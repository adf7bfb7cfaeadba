// SchNet continuous-filter convolution on the column layout for Hopper
// (sm_90a), f32.
//
// K9 cf_fwd_kernel replaces the TPU kernel
//   schnetpack_tpu/ops/schnet_columns.py:79 _cf_fwd_kernel
//   (launcher :118 _cf_fwd_call).
// K10 cf_bwd_kernel<W> replaces
//   schnetpack_tpu/ops/schnet_columns.py:145 _cf_bwd_kernel (launcher :225
//   _cf_bwd_call): dh and the geometry cotangent ggeo, and in its wgrad
//   instance (W = true) also the filter-weight cotangents gW1 [B, F], gb1,
//   gW2 [F, F] and gb2 (``schnet_columns.py:191-205``).
//
// Per edge slot (source row j, destination row i, raw-phi geometry
// [phi (B), fcut, dir (3)] from colblock_geo.cu in its raw form):
//   z1  = phi W1 + b1            [F]   W1 [B, F]
//   h1  = ssp(z1)                      ssp(z) = softplus(z) - ln 2
//   pre = h1 W2 + b2             [F]   W2 [F, F]
//   out_i += h_j * pre * fcut
// and the VJP for the cotangent g of out:
//   gmsg = g_i; ghj = gmsg pre fcut (folded onto h_j); gW = gmsg h_j;
//   gfcut = sum_f gW pre; gpre = gW fcut; gh1 = gpre W2^T;
//   gz1 = gh1 sigmoid(z1); gphi = gz1 W1^T; ggeo = [gphi, gfcut, 0, 0, 0].
//
// Layout as in colblock_message.cu (slot k of column (i, j) in bucket c9,
// source row qcol of column ((i+dx) mod nx, (j+dy) mod ny), destination
// row dcol of column (i, j)).  Both kernels run one block per destination
// column over the column's real slots only: ``order`` [col][Ktot] lists
// them first, in slot order (so bucket by bucket), and ``nreal`` [col]
// counts them; padded slots cost nothing.
//
// What bounds them on the H100: the filter MLP.  Per edge it is B*F + F*F
// FMAs forward and twice that backward (~19k and ~38k at F = 128, B = 20),
// against a few hundred bytes of loads, so the kernels are bound by FP32
// FMA issue and by the shared-memory reads that feed it.  A block takes 64
// edges at a time and computes the filter products as small matrix
// products: 256 threads, each owning 4 edges x 8 filters (filters tf + 16u,
// so that the 16 filter groups of a half-warp read 16 consecutive words of
// a weight row, and the other half-warp, on the next 4 edges, reads the
// same words: conflict-free, broadcast).  Per step of the reduction a
// thread reads one float4 of activations (4 edges, stored transposed [F][E])
// and 8 weights, for 32 FMAs.  W2 (64 KB) and W1 stay in shared memory for
// the whole block, which needs the opt-in above 48 KB.  Tensor cores
// (TF32 / bf16) would be a precision decision and are not used; the filter
// products never leave the kernel (no library GEMM).
//
// Every sum has one writer and no atomics.  K9 owns its column's output
// rows: after the chunk's messages are in shared memory, thread f adds
// them to row dcol, feature f, in slot order.  K10 owns its column's
// ggeo slots and folds ghj onto source rows the way the TPU kernel does,
// into 9 per-source-column partials part[c9][source column][P][F] (one
// writer each, as the bucket shift is a bijection of the columns): thread
// f keeps the current bucket's source-row sums of feature f in shared
// memory and writes them out when the slot order passes to the next
// bucket.  The wrapper adds the 9 partials.
//
// The wgrad instance adds, per chunk, gW2 += h1^T gpre, gb2 += sum gpre,
// gW1 += phi^T gz1 and gb1 += sum gz1 (gz1 = gh1 sigmoid(z1)) over the
// chunk's edges: gpre^T is stored beside h1^T (in the M tile, free once the
// fold has read it), then gz1^T over h1^T.  Thread (te, tf) owns gW2[k][f]
// for k = te + 16i, f = tf + 16j (8 x 8, float4 reads along the edges) and
// gW1[b][f] for b = te + 16i; it sums the chunk's 64 edges in f32 and adds
// them to the block's f64 partial in device memory, which only it touches
// (deterministic, no atomics); the wrapper sums the columns' partials.

#include <cuda_runtime.h>

namespace {

constexpr int kF = 128;           // filters: the kernels' only width
constexpr int kE = 64;            // edges per chunk
constexpr int kThreads = 256;     // 16 filter groups x 16 edge groups
constexpr int kNF = kF / 16;      // filters per thread (tf + 16 u)
constexpr int kNE = 4;            // edges per thread (te * 4 + v)
constexpr int kLdT = kE + 4;      // row stride of [F][E] tiles (float4 rows)
constexpr int kLdW = kF + 1;      // row stride of W2 in shared memory
constexpr int kLdM = kF + 1;      // row stride of [E][F] tiles
constexpr int kMaxB = 32;
// K10's M tile: [E][kLdM] ghj, or (wgrad) gpre^T [F][kLdT]
constexpr int kMSize = kE * kLdM > kF * kLdT ? kE * kLdM : kF * kLdT;
constexpr float kLn2 = 0.69314718055994531f;

struct KOffs {
  int o[10];
};

__device__ __forceinline__ float ssp(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - kLn2;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// shared-memory carve-up common to both kernels
struct Smem {
  float* W2;    // [F][kLdW]
  float* W1;    // [B][F]
  float* b1;    // [F]
  float* b2;    // [F]
  float* phiT;  // [B][kLdT]
  float* T;     // [F][kLdT]: h1^T, then (K10) gpre^T
  float* M;     // [E][kLdM]: messages (K9, aliases T) or ghj (K10)
  float* acc;   // [P][F]: output rows (K9) or source-row sums (K10)
  float* fc;    // [E]
  int* src;     // [E] global source row, -1 past the real slots
  int* dst;     // [E] destination row in the column
  int* slot;    // [E]
  int* c9;      // [E]
};

__host__ __device__ inline size_t smem_floats(int B, int P, bool bwd) {
  return (size_t)kF * kLdW + (size_t)B * kF + 2 * kF + (size_t)B * kLdT +
         (size_t)kF * kLdT + (bwd ? kMSize : 0) + (size_t)P * kF + kE;
}

__device__ inline Smem carve(float* s, int B, int P, bool bwd) {
  Smem m;
  m.W2 = s;
  m.W1 = m.W2 + kF * kLdW;
  m.b1 = m.W1 + B * kF;
  m.b2 = m.b1 + kF;
  m.phiT = m.b2 + kF;
  m.T = m.phiT + B * kLdT;
  m.M = bwd ? m.T + kF * kLdT : m.T;
  m.acc = m.M + (bwd ? kMSize : kF * kLdT);
  m.fc = m.acc + P * kF;
  m.src = reinterpret_cast<int*>(m.fc + kE);
  m.dst = m.src + kE;
  m.slot = m.dst + kE;
  m.c9 = m.slot + kE;
  return m;
}

__device__ inline void load_weights(const Smem& m, const float* W1,
                                    const float* b1, const float* W2,
                                    const float* b2, int B, int tid) {
  for (int t = tid; t < kF * kF; t += kThreads)
    m.W2[(t / kF) * kLdW + t % kF] = W2[t];
  for (int t = tid; t < B * kF; t += kThreads) m.W1[t] = W1[t];
  for (int t = tid; t < kF; t += kThreads) {
    m.b1[t] = b1[t];
    m.b2[t] = b2[t];
  }
}

// Decode the chunk's edges (slots ord[n0 .. n0+kE) of the column) and load
// their basis channels phi^T [B][E] and fcut; slots past the real ones get
// src = -1 and zeros.
__device__ inline void load_chunk(const Smem& m, const float* geo,
                                  const int* qcol, const int* dcol,
                                  const int* ord, int n0, int nreal, int col,
                                  int ci, int cj, int nx, int ny, int P,
                                  int Ktot, const KOffs& ko, int B, int nch,
                                  int tid) {
  if (tid < kE) {
    const int n = n0 + tid;
    int slot = -1, src = -1, dv = 0, c9 = 0;
    float fc = 0.f;
    if (n < nreal) {
      slot = ord[n];
      while (slot >= ko.o[c9 + 1]) ++c9;
      const int si = (ci + c9 / 3 - 1 + nx) % nx;
      const int sj = (cj + c9 % 3 - 1 + ny) % ny;
      const size_t e = (size_t)col * Ktot + slot;
      src = (si * ny + sj) * P + qcol[e];
      dv = dcol[e];
      fc = geo[((size_t)col * nch + B) * Ktot + slot];
    }
    m.slot[tid] = slot;
    m.src[tid] = src;
    m.dst[tid] = dv;
    m.c9[tid] = c9;
    m.fc[tid] = fc;
  }
  __syncthreads();
  for (int t = tid; t < B * kE; t += kThreads) {
    const int b = t / kE, e = t - b * kE;
    const int slot = m.slot[e];
    m.phiT[b * kLdT + e] =
        slot >= 0 ? geo[((size_t)col * nch + b) * Ktot + slot] : 0.f;
  }
  __syncthreads();
}

// z[v][u] = b1 + sum_b phi[e][b] W1[b][f] for e = te*4+v, f = tf+16u
__device__ inline void filter_layer1(const Smem& m, int B, int te, int tf,
                                     float (&z)[kNE][kNF]) {
#pragma unroll
  for (int u = 0; u < kNF; ++u) {
    const float bias = m.b1[tf + 16 * u];
#pragma unroll
    for (int v = 0; v < kNE; ++v) z[v][u] = bias;
  }
  for (int b = 0; b < B; ++b) {
    const float4 p = *reinterpret_cast<const float4*>(m.phiT + b * kLdT +
                                                      te * 4);
#pragma unroll
    for (int u = 0; u < kNF; ++u) {
      const float w = m.W1[b * kF + tf + 16 * u];
      z[0][u] = fmaf(p.x, w, z[0][u]);
      z[1][u] = fmaf(p.y, w, z[1][u]);
      z[2][u] = fmaf(p.z, w, z[2][u]);
      z[3][u] = fmaf(p.w, w, z[3][u]);
    }
  }
}

// store a thread's tile transposed into T [F][kLdT]
__device__ inline void store_T(float* T, int te, int tf,
                               const float (&a)[kNE][kNF]) {
#pragma unroll
  for (int u = 0; u < kNF; ++u)
    *reinterpret_cast<float4*>(T + (tf + 16 * u) * kLdT + te * 4) =
        make_float4(a[0][u], a[1][u], a[2][u], a[3][u]);
}

// pre[v][u] = b2 + sum_k T[k][e] W2[k][f]
__device__ inline void filter_layer2(const Smem& m, int te, int tf,
                                     float (&a)[kNE][kNF]) {
#pragma unroll
  for (int u = 0; u < kNF; ++u) {
    const float bias = m.b2[tf + 16 * u];
#pragma unroll
    for (int v = 0; v < kNE; ++v) a[v][u] = bias;
  }
#pragma unroll 4
  for (int k = 0; k < kF; ++k) {
    const float4 h = *reinterpret_cast<const float4*>(m.T + k * kLdT +
                                                      te * 4);
#pragma unroll
    for (int u = 0; u < kNF; ++u) {
      const float w = m.W2[k * kLdW + tf + 16 * u];
      a[0][u] = fmaf(h.x, w, a[0][u]);
      a[1][u] = fmaf(h.y, w, a[1][u]);
      a[2][u] = fmaf(h.z, w, a[2][u]);
      a[3][u] = fmaf(h.w, w, a[3][u]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
cf_fwd_kernel(const float* __restrict__ h, const float* __restrict__ geo,
              const float* __restrict__ W1, const float* __restrict__ b1,
              const float* __restrict__ W2, const float* __restrict__ b2,
              const int* __restrict__ qcol, const int* __restrict__ dcol,
              const int* __restrict__ order, const int* __restrict__ nreal,
              float* __restrict__ out, int nx, int ny, int P, int Ktot,
              KOffs ko, int B, int nch) {
  extern __shared__ float smem[];
  const Smem m = carve(smem, B, P, false);
  const int col = blockIdx.x, ci = col / ny, cj = col - ci * ny;
  const int tid = threadIdx.x, tf = tid & 15, te = tid >> 4;
  load_weights(m, W1, b1, W2, b2, B, tid);
  for (int t = tid; t < P * kF; t += kThreads) m.acc[t] = 0.f;
  const int nr = nreal[col];
  const int* ord = order + (size_t)col * Ktot;

  for (int n0 = 0; n0 < nr; n0 += kE) {
    __syncthreads();  // the previous chunk's fold is done
    load_chunk(m, geo, qcol, dcol, ord, n0, nr, col, ci, cj, nx, ny, P, Ktot,
               ko, B, nch, tid);
    float a[kNE][kNF];
    filter_layer1(m, B, te, tf, a);
#pragma unroll
    for (int v = 0; v < kNE; ++v)
#pragma unroll
      for (int u = 0; u < kNF; ++u) a[v][u] = ssp(a[v][u]);
    store_T(m.T, te, tf, a);
    __syncthreads();
    filter_layer2(m, te, tf, a);
    __syncthreads();  // every thread is done reading T (M aliases it)
#pragma unroll
    for (int v = 0; v < kNE; ++v) {
      const int e = te * 4 + v;
      const int src = m.src[e];
      const float fc = m.fc[e];
      const float* hj = h + (size_t)max(src, 0) * kF;
#pragma unroll
      for (int u = 0; u < kNF; ++u) {
        const int f = tf + 16 * u;
        m.M[e * kLdM + f] = src >= 0 ? hj[f] * a[v][u] * fc : 0.f;
      }
    }
    __syncthreads();
    if (tid < kF) {
      const int ne = min(kE, nr - n0);
      for (int e = 0; e < ne; ++e)
        m.acc[m.dst[e] * kF + tid] += m.M[e * kLdM + tid];
    }
  }
  __syncthreads();
  float* o = out + (size_t)col * P * kF;
  for (int t = tid; t < P * kF; t += kThreads) o[t] = m.acc[t];
}

// wgrad: gW2 += h1^T gpre and gb2 += sum gpre over the chunk (T holds
// h1^T, G gpre^T); thread (te, tf) owns k = te + 16i, f = tf + 16j
__device__ inline void wgrad_layer2(const float* T, const float* G,
                                    double* pw, int B, int te, int tf) {
  float w[kNF][kNF], bs[kNF];
#pragma unroll
  for (int j = 0; j < kNF; ++j) {
    bs[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kNF; ++i) w[i][j] = 0.f;
  }
  for (int e = 0; e < kE; e += 4) {
    float4 gv[kNF];
#pragma unroll
    for (int j = 0; j < kNF; ++j)
      gv[j] = *reinterpret_cast<const float4*>(G + (tf + 16 * j) * kLdT + e);
#pragma unroll
    for (int i = 0; i < kNF; ++i) {
      const float4 hv =
          *reinterpret_cast<const float4*>(T + (te + 16 * i) * kLdT + e);
#pragma unroll
      for (int j = 0; j < kNF; ++j)
        w[i][j] = fmaf(hv.x, gv[j].x, fmaf(hv.y, gv[j].y,
                  fmaf(hv.z, gv[j].z, fmaf(hv.w, gv[j].w, w[i][j]))));
    }
#pragma unroll
    for (int j = 0; j < kNF; ++j)
      bs[j] += (gv[j].x + gv[j].y) + (gv[j].z + gv[j].w);
  }
  double* gW2 = pw + (size_t)B * kF + kF;
#pragma unroll
  for (int i = 0; i < kNF; ++i)
#pragma unroll
    for (int j = 0; j < kNF; ++j)
      gW2[(te + 16 * i) * kF + tf + 16 * j] += (double)w[i][j];
  if (te == 0) {
#pragma unroll
    for (int j = 0; j < kNF; ++j) gW2[kF * kF + tf + 16 * j] += (double)bs[j];
  }
}

// wgrad: gW1 += phi^T gz1 and gb1 += sum gz1 over the chunk (phiT [B][E],
// T gz1^T); thread (te, tf) owns b = te + 16i (< B), f = tf + 16j
__device__ inline void wgrad_layer1(const float* phiT, const float* T,
                                    double* pw, int B, int te, int tf) {
  constexpr int kNB = kMaxB / 16;
  float w[kNB][kNF], bs[kNF];
#pragma unroll
  for (int j = 0; j < kNF; ++j) {
    bs[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kNB; ++i) w[i][j] = 0.f;
  }
  for (int e = 0; e < kE; e += 4) {
    float4 gv[kNF];
#pragma unroll
    for (int j = 0; j < kNF; ++j)
      gv[j] = *reinterpret_cast<const float4*>(T + (tf + 16 * j) * kLdT + e);
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      const int b = te + 16 * i;
      if (b >= B) break;
      const float4 pv = *reinterpret_cast<const float4*>(phiT + b * kLdT + e);
#pragma unroll
      for (int j = 0; j < kNF; ++j)
        w[i][j] = fmaf(pv.x, gv[j].x, fmaf(pv.y, gv[j].y,
                  fmaf(pv.z, gv[j].z, fmaf(pv.w, gv[j].w, w[i][j]))));
    }
#pragma unroll
    for (int j = 0; j < kNF; ++j)
      bs[j] += (gv[j].x + gv[j].y) + (gv[j].z + gv[j].w);
  }
#pragma unroll
  for (int i = 0; i < kNB; ++i) {
    const int b = te + 16 * i;
    if (b >= B) break;
#pragma unroll
    for (int j = 0; j < kNF; ++j) pw[b * kF + tf + 16 * j] += (double)w[i][j];
  }
  if (te == 0) {
#pragma unroll
    for (int j = 0; j < kNF; ++j) pw[B * kF + tf + 16 * j] += (double)bs[j];
  }
}

template <bool kWgrad>
__global__ void __launch_bounds__(kThreads, 1)
cf_bwd_kernel(const float* __restrict__ h, const float* __restrict__ geo,
              const float* __restrict__ W1, const float* __restrict__ b1,
              const float* __restrict__ W2, const float* __restrict__ b2,
              const int* __restrict__ qcol, const int* __restrict__ dcol,
              const int* __restrict__ order, const int* __restrict__ nreal,
              const float* __restrict__ g, float* __restrict__ part,
              float* __restrict__ ggeo, double* __restrict__ wpart, int nx,
              int ny, int P, int Ktot, KOffs ko, int B, int nch) {
  extern __shared__ float smem[];
  const Smem m = carve(smem, B, P, true);
  const int col = blockIdx.x, ci = col / ny, cj = col - ci * ny;
  const int ncol = nx * ny;
  const int tid = threadIdx.x, tf = tid & 15, te = tid >> 4;
  load_weights(m, W1, b1, W2, b2, B, tid);
  for (int t = tid; t < P * kF; t += kThreads) m.acc[t] = 0.f;
  const int nr = nreal[col];
  const int* ord = order + (size_t)col * Ktot;
  const size_t gbase = (size_t)col * (B + 4) * Ktot;
  // the block's f64 weight-cotangent partial [gW1 | gb1 | gW2 | gb2]
  double* pw = kWgrad ? wpart + (size_t)col * ((B + 2) * kF + kF * kF)
                      : nullptr;
  // gpre^T: beside h1^T in the wgrad instance (h1 is still needed), else
  // over it
  float* G = kWgrad ? m.M : m.T;
  // padded slots: ggeo 0 in every channel; real slots: 0 in dir channels
  // (the other channels are written chunk by chunk below)
  for (int k = tid; k < Ktot; k += kThreads) {
    const bool pad = qcol[(size_t)col * Ktot + k] < 0;
    for (int c = pad ? 0 : B + 1; c < B + 4; ++c)
      ggeo[gbase + (size_t)c * Ktot + k] = 0.f;
  }
  // the fold's bucket (threads tid < kF): partial sums of bucket `cur`
  int cur = 0;
  auto flush = [&](int c9) {
    const int scol = ((ci + c9 / 3 - 1 + nx) % nx) * ny +
                     (cj + c9 % 3 - 1 + ny) % ny;
    float* p = part + ((size_t)c9 * ncol + scol) * P * kF + tid;
    for (int r = 0; r < P; ++r) {
      p[(size_t)r * kF] = m.acc[r * kF + tid];
      m.acc[r * kF + tid] = 0.f;
    }
  };

  for (int n0 = 0; n0 < nr; n0 += kE) {
    __syncthreads();  // the previous chunk's fold is done
    load_chunk(m, geo, qcol, dcol, ord, n0, nr, col, ci, cj, nx, ny, P, Ktot,
               ko, B, nch, tid);
    float a[kNE][kNF], sg[kNE][kNF];
    filter_layer1(m, B, te, tf, a);
#pragma unroll
    for (int v = 0; v < kNE; ++v)
#pragma unroll
      for (int u = 0; u < kNF; ++u) {
        sg[v][u] = sigmoid(a[v][u]);
        a[v][u] = ssp(a[v][u]);
      }
    store_T(m.T, te, tf, a);
    __syncthreads();
    filter_layer2(m, te, tf, a);  // a = pre
    // per-edge cotangents; a becomes gpre
#pragma unroll
    for (int v = 0; v < kNE; ++v) {
      const int e = te * 4 + v;
      const int src = m.src[e];
      const float fc = m.fc[e];
      const float* hj = h + (size_t)max(src, 0) * kF;
      const float* gi = g + ((size_t)col * P + m.dst[e]) * kF;
      float gfc = 0.f;
#pragma unroll
      for (int u = 0; u < kNF; ++u) {
        const int f = tf + 16 * u;
        const float gm = src >= 0 ? gi[f] : 0.f;
        const float gw = gm * (src >= 0 ? hj[f] : 0.f);
        m.M[e * kLdM + f] = gm * a[v][u] * fc;
        gfc = fmaf(gw, a[v][u], gfc);
        a[v][u] = gw * fc;
      }
      // the 16 filter groups of edge e are the 16 lanes of a half-warp
#pragma unroll
      for (int s = 8; s > 0; s >>= 1)
        gfc += __shfl_xor_sync(0xffffffffu, gfc, s);
      if (tf == v && src >= 0)
        ggeo[gbase + (size_t)B * Ktot + m.slot[e]] = gfc;
    }
    __syncthreads();  // M is written; every thread is done reading T
    // fold ghj onto the source rows, in slot order, one bucket at a time
    if (tid < kF) {
      const int ne = min(kE, nr - n0);
      for (int e = 0; e < ne; ++e) {
        const int c9 = m.c9[e];
        while (cur < c9) flush(cur++);
        const int q = m.src[e] % P;
        m.acc[q * kF + tid] += m.M[e * kLdM + tid];
      }
    }
    __syncthreads();  // the fold is done with M
    store_T(G, te, tf, a);
    __syncthreads();
    if constexpr (kWgrad) wgrad_layer2(m.T, G, pw, B, te, tf);
    // gh1[e][k] = sum_f gpre[e][f] W2[k][f] for k = tf + 16u
    float gh[kNE][kNF];
#pragma unroll
    for (int u = 0; u < kNF; ++u)
#pragma unroll
      for (int v = 0; v < kNE; ++v) gh[v][u] = 0.f;
#pragma unroll 4
    for (int f = 0; f < kF; ++f) {
      const float4 gp = *reinterpret_cast<const float4*>(G + f * kLdT +
                                                         te * 4);
#pragma unroll
      for (int u = 0; u < kNF; ++u) {
        const float w = m.W2[(tf + 16 * u) * kLdW + f];
        gh[0][u] = fmaf(gp.x, w, gh[0][u]);
        gh[1][u] = fmaf(gp.y, w, gh[1][u]);
        gh[2][u] = fmaf(gp.z, w, gh[2][u]);
        gh[3][u] = fmaf(gp.w, w, gh[3][u]);
      }
    }
    // gz1 = gh1 sigmoid(z1); gphi[e][b] = sum_k gz1[e][k] W1[b][k]
#pragma unroll
    for (int v = 0; v < kNE; ++v)
#pragma unroll
      for (int u = 0; u < kNF; ++u) gh[v][u] *= sg[v][u];
    for (int b = 0; b < B; ++b) {
      float s[kNE];
#pragma unroll
      for (int v = 0; v < kNE; ++v) s[v] = 0.f;
#pragma unroll
      for (int u = 0; u < kNF; ++u) {
        const float w = m.W1[b * kF + tf + 16 * u];
#pragma unroll
        for (int v = 0; v < kNE; ++v) s[v] = fmaf(gh[v][u], w, s[v]);
      }
#pragma unroll
      for (int v = 0; v < kNE; ++v)
#pragma unroll
        for (int sh = 8; sh > 0; sh >>= 1)
          s[v] += __shfl_xor_sync(0xffffffffu, s[v], sh);
      if (tf == (b & 15)) {
#pragma unroll
        for (int v = 0; v < kNE; ++v) {
          const int e = te * 4 + v;
          if (m.src[e] >= 0)
            ggeo[gbase + (size_t)b * Ktot + m.slot[e]] = s[v];
        }
      }
    }
    if constexpr (kWgrad) {
      __syncthreads();  // every thread is done reading T (h1^T) and G
      store_T(m.T, te, tf, gh);  // gz1^T
      __syncthreads();
      wgrad_layer1(m.phiT, m.T, pw, B, te, tf);
    }
  }
  __syncthreads();
  if (tid < kF)
    while (cur < 9) flush(cur++);
}

// opt in to `smem` bytes of dynamic shared memory (W2 alone is 64 KB)
template <typename K>
int set_smem(K kernel, size_t smem) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// dynamic shared memory of K9 (bwd 0) or K10 for B basis functions and
// column capacity P, bytes a block
extern "C" int spk_cf_smem_bytes(int B, int P, int bwd) {
  return (int)(smem_floats(B, P, bwd != 0) * sizeof(float) +
               4 * kE * sizeof(int));
}

extern "C" int spk_cf_fwd(const float* h, const float* geo, const float* W1,
                          const float* b1, const float* W2, const float* b2,
                          const int* qcol, const int* dcol, const int* order,
                          const int* nreal, float* out, int nx, int ny, int P,
                          int Ktot, const int* koffs, int B, int nch,
                          cudaStream_t stream) {
  if (B > kMaxB) return (int)cudaErrorInvalidValue;
  KOffs ko;
  for (int i = 0; i < 10; ++i) ko.o[i] = koffs[i];
  const size_t smem = spk_cf_smem_bytes(B, P, 0);
  int err = set_smem(cf_fwd_kernel, smem);
  if (err) return err;
  cf_fwd_kernel<<<nx * ny, kThreads, smem, stream>>>(
      h, geo, W1, b1, W2, b2, qcol, dcol, order, nreal, out, nx, ny, P, Ktot,
      ko, B, nch);
  return (int)cudaGetLastError();
}

extern "C" int spk_cf_bwd(const float* h, const float* geo, const float* W1,
                          const float* b1, const float* W2, const float* b2,
                          const int* qcol, const int* dcol, const int* order,
                          const int* nreal, const float* g, float* part,
                          float* ggeo, double* wpart, int nx, int ny, int P,
                          int Ktot, const int* koffs, int B, int nch,
                          cudaStream_t stream) {
  if (B > kMaxB) return (int)cudaErrorInvalidValue;
  KOffs ko;
  for (int i = 0; i < 10; ++i) ko.o[i] = koffs[i];
  const size_t smem = spk_cf_smem_bytes(B, P, 1);
  auto* kernel = wpart != nullptr ? cf_bwd_kernel<true> : cf_bwd_kernel<false>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<nx * ny, kThreads, smem, stream>>>(
      h, geo, W1, b1, W2, b2, qcol, dcol, order, nreal, g, part, ggeo, wpart,
      nx, ny, P, Ktot, ko, B, nch);
  return (int)cudaGetLastError();
}
