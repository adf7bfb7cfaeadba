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
// row dcol of column (i, j)).
//
// What bounds them on the H100: the filter MLP.  Per edge it is B*F + F*F
// FMAs forward and twice that backward (~19k and ~38k at F = 128, B = 20),
// against a few hundred bytes of loads: bound by arithmetic.
//
// K9 runs one block per destination column over the column's real slots
// only: ``order`` [col][Ktot] lists them first, in slot order (so bucket by
// bucket), and ``nreal`` [col] counts them.  A block takes 64 edges at a
// time and computes the filter products as small matrix products in FP32:
// 256 threads, each owning 4 edges x 8 filters (filters tf + 16u, so that
// the 16 filter groups of a half-warp read 16 consecutive words of a
// weight row, and the other half-warp, on the next 4 edges, reads the same
// words: conflict-free, broadcast).  Per step of the reduction a thread
// reads one float4 of activations (4 edges, stored transposed [F][E]) and
// 8 weights, for 32 FMAs.  W2 (64 KB) and W1 stay in shared memory for the
// whole block, and a [P][F] accumulator holds the column's output rows:
// after a chunk's messages are in shared memory, thread f adds them to
// row dcol, feature f, in slot order (one writer, no atomics).
//
// K10 is source-centric, on the message backward's schedule
// (colblock_message_bwd.cu, ops/colblock.py::source_schedule): the real
// slots sorted by their source row (``esorted``), each source column's
// rows cut into G ranges of about equal edge count; a row range (col, g)
// owns the source rows [r0, r1) of column col and their slots
// esorted[e0, e1) (``grp[col][g]`` = (r0, e0), ``grp[col][g+1]`` = (r1,
// e1)), G of them (ops/schnet_columns.py::BWD_RANGES, measured).
// No bucket is needed: a slot's source row is its qcol in the
// range's own column, its destination row dcol in column slot / Ktot.
// Per chunk of kBwdE = 16 slots:
//   the slots' indices, fcut and basis rows phi [E][B] (with a column of
//   ones at B, which the zero row B of the padded W1 ignores and which
//   makes the wgrad product's row B the bias cotangent gb1), staged by
//   cp.async into the other of two buffers while the chunk before runs;
//   P1  z1 = phi W1 + b1: h1 = ssp(z1) and sigmoid(z1) in the epilogue;
//   P2  pre = h1 W2 + b2;
//   E1  per (slot, feature), the destination row's cotangent and the
//       source row read from L2: ghj, gpre (over pre) and gW pre, whose
//       sum over the features (warp shuffles, then the warps' partials in
//       a fixed order) is gfcut;
//   the fold: thread f walks the chunk's slots in order and sums feature
//       f of ghj for the open source row in a register, stored once when
//       the row's run ends (rows without a slot get 0); every row of
//       [r0, r1) is written exactly once;
//   P3  gh1 = gpre W2^T, gz1 = gh1 sigmoid(z1) in the epilogue;
//   P4  gphi = gz1 W1^T, written at the slot's ggeo channels b < B.
// P1-P4 run on the tensor cores in 3xTF32 (tf32_mma.cuh, rows_mma: each
// k-step's products in a fresh fragment added to an f32 sum): a chunk is
// one m16 tile, the warps split the F (P4: the padded B) columns.  Every
// real slot's ggeo is written by the range that owns its source row
// (gphi, gfcut, 0 in the dir channels); range (col, 0) writes 0 at every
// channel of the padded slots of column col; so ggeo needs no fill.
//
// What bounds it on the H100, measured (scripts/time_cfconv_kernels.py,
// PERF.md): not its bytes, and not the tensor cores alone.  With 8 warps
// a block and the weights read through L1 from L2 the products were 2
// n8-tiles a warp per k-step, too little work around each mma.sync and
// its splits (1.0 ms at the SchNet bench); the weights in shared memory
// did not move that.  So the plain instance runs one block an SM of
// kBwdGroups groups of 4 warps, each group a row range of its own with
// its own named barrier, sharing W2 and the padded W1 [Bp][F] (Bp = B+1
// rounded up to 8) in shared memory, read row-major in P1/P2 and as
// their transposes in P3/P4 (rows_mma's kWShared, kWSharedT): 4 n8-tiles
// a warp per k-step, and the groups' phases interleave on the SM.  Shared
// memory holds the weights and each group's chunk tiles, whatever P is.
//
// The wgrad instance runs one group of 8 warps a block and adds per chunk
// gW2 += h1^T gpre and [gW1; gb1] += [phi | 1]^T gz1, 3xTF32 products
// with both operands in shared memory (acc_tn below), whose chunk sums
// each thread adds to the elements of the block's f32 sums in shared
// memory that it alone owns; gb2 is summed per feature in registers.  At
// its end the block writes its sums to its own f64 partial, which the
// wrapper adds up: one writer per element and one order per sum, no
// atomics.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kF = 128;           // filters: the kernels' only width
constexpr int kE = 64;            // K9: edges per chunk
constexpr int kThreads = 256;     // K9: 16 filter groups x 16 edge groups
constexpr int kNF = kF / 16;      // filters per thread (tf + 16 u)
constexpr int kNE = 4;            // edges per thread (te * 4 + v)
constexpr int kLdT = kE + 4;      // row stride of [F][E] tiles (float4 rows)
constexpr int kLdW = kF + 1;      // row stride of W2 in shared memory
constexpr int kLdM = kF + 1;      // row stride of [E][F] tiles
constexpr int kMaxB = 32;
constexpr float kLn2 = 0.69314718055994531f;

// K10's tuning constants (scripts/time_cfconv_kernels.py --set): slots a
// chunk (kBwdE / 16 m16 tiles); the plain instance's block, one an SM,
// runs kBwdGroups groups of kBwdGroupWarps warps, each group on a row
// range of its own, sharing the filter weights; its warps take kBwdNT
// n8-tiles at a time in the F-wide products; the wgrad instance runs one
// group of kWgradWarps warps (kWgradNT)
constexpr int kBwdE = 16;
constexpr int kBwdGroups = 3;
constexpr int kBwdGroupWarps = 4;
constexpr int kBwdNT = 4;
constexpr int kWgradWarps = 8;
constexpr int kWgradNT = 2;
constexpr int kLdF = kF + 4;      // K10's [E][F] tiles: 4 mod 32 floats
constexpr int kLdA = kF + 8;      // the wgrad sums [rows][F]: 8 mod 32
constexpr int kQ = kF / 32;       // warps across a row of F features

// an instance's groups a block, warps a group, n8-tiles a warp
template <bool kWgrad>
struct BwdShape {
  static constexpr int QG = kWgrad ? 1 : kBwdGroups;
  static constexpr int NW = kWgrad ? kWgradWarps : kBwdGroupWarps;
  static constexpr int NT = kWgrad ? kWgradNT : kBwdNT;
  static constexpr int NTH = 32 * NW;  // threads a group
  static_assert(kBwdE % 16 == 0 && NTH % kF == 0 && kF % (8 * NT * NW) == 0,
                "K10's constants");
};

struct KOffs {
  int o[10];
};

__device__ __forceinline__ float ssp(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - kLn2;
}

// K9's shared-memory carve-up
struct Smem {
  float* W2;    // [F][kLdW]
  float* W1;    // [B][F]
  float* b1;    // [F]
  float* b2;    // [F]
  float* phiT;  // [B][kLdT]
  float* T;     // [F][kLdT]: h1^T
  float* M;     // [E][kLdM]: messages (aliases T)
  float* acc;   // [P][F]: output rows
  float* fc;    // [E]
  int* src;     // [E] global source row, -1 past the real slots
  int* dst;     // [E] destination row in the column
  int* slot;    // [E]
  int* c9;      // [E]
};

__host__ __device__ inline size_t smem_floats(int B, int P) {
  return (size_t)kF * kLdW + (size_t)B * kF + 2 * kF + (size_t)B * kLdT +
         (size_t)kF * kLdT + (size_t)P * kF + kE;
}

__device__ inline Smem carve(float* s, int B, int P) {
  Smem m;
  m.W2 = s;
  m.W1 = m.W2 + kF * kLdW;
  m.b1 = m.W1 + B * kF;
  m.b2 = m.b1 + kF;
  m.phiT = m.b2 + kF;
  m.T = m.phiT + B * kLdT;
  m.M = m.T;
  m.acc = m.M + kF * kLdT;
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
  const Smem m = carve(smem, B, P);
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


// K10's padded basis width Bp (B + 1 rounded up to 8: the ones column at
// B) and the rows MP of the gW1 product (Bp rounded up to 16)
__host__ __device__ inline int bwd_bp(int B) { return (B + 1 + 7) / 8 * 8; }
__host__ __device__ inline int bwd_mp(int B) {
  return (bwd_bp(B) + 15) / 16 * 16;
}

// K10's shared memory, floats: W2 [F][kLdF] and W1 [Bp][kLdF], shared by
// the block's groups; per group two buffers of the staged chunk (phi
// [E][MP+4], fcut [E], the geo offsets [E] (size_t) and three int arrays
// [E]), the tiles h1 (the plain instance's ghj over it), sigmoid(z1) ->
// gz1 and pre -> gpre [E][kLdF] and the gfcut partials [E][kQ]; wgrad: a
// ghj tile and the f32 sums gW2 [F][kLdA] and [gW1; gb1] [MP][kLdA]
__host__ __device__ inline size_t bwd_group_floats(int B, bool wgrad) {
  const int E = kBwdE;
  return 2 * ((size_t)E * (bwd_mp(B) + 4) + 6 * E) +
         (wgrad ? 4 : 3) * (size_t)E * kLdF + (size_t)E * kQ;
}

__host__ __device__ inline size_t bwd_smem_floats(int B, bool wgrad) {
  return (size_t)(kF + bwd_bp(B)) * kLdF +
         (wgrad ? bwd_group_floats(B, true) +
                      (size_t)(kF + bwd_mp(B)) * kLdA
                : kBwdGroups * bwd_group_floats(B, false));
}

// the named barrier of a group of n threads
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) v += __shfl_xor_sync(0xffffffffu, v, sh);
  return v;
}

// out[m][n] += sum_e A[e][m] Bm[e][n] over a chunk's E slots, for M rows
// (M % 16 == 0) and N = kF columns, A and Bm in shared memory (row
// strides lda, ldb): the wgrad instance's products.  The warps take (m16
// tile, NG n8-tiles) items in turn; per k-step of 8 slots the A fragment
// is split once for the NG tiles, the three products of each tile go
// into a fresh fragment added to the chunk's f32 sum, which the thread
// then adds to its own elements of out (row stride kLdA).
template <int E, int NG, int NW>
__device__ __forceinline__ void acc_tn(const float* A, int lda, int M,
                                       const float* Bm, int ldb,
                                       float* out) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & (NW - 1);
  const int gid = lane >> 2, tig = lane & 3;
  constexpr int ng = kF / (8 * NG);
  const int items = (M / 16) * ng;
  for (int it = warp; it < items; it += NW) {
    const int m0 = (it / ng) * 16, n0 = (it % ng) * 8 * NG;
    float acc[NG][4] = {};
#pragma unroll
    for (int k = 0; k < E; k += 8) {
      const float* a = A + (k + tig) * lda + m0 + gid;
      uint32_t ab[4], as[4];
      split_tf32(a[0], ab[0], as[0]);
      split_tf32(a[8], ab[1], as[1]);
      split_tf32(a[4 * lda], ab[2], as[2]);
      split_tf32(a[4 * lda + 8], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const float* b = Bm + (k + tig) * ldb + n0 + 8 * j + gid;
        uint32_t bb[2], bs[2];
        split_tf32(b[0], bb[0], bs[0]);
        split_tf32(b[4 * ldb], bb[1], bs[1]);
        float t[4] = {};
        mma_tf32(t, as, bb);
        mma_tf32(t, ab, bs);
        mma_tf32(t, ab, bb);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += t[e];
      }
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      float* o = out + (m0 + gid) * kLdA + n0 + 8 * j + 2 * tig;
      o[0] += acc[j][0];
      o[1] += acc[j][1];
      o[8 * kLdA] += acc[j][2];
      o[8 * kLdA + 1] += acc[j][3];
    }
  }
}

template <bool kWgrad>
__global__ void __launch_bounds__(32 * BwdShape<kWgrad>::NW *
                                      BwdShape<kWgrad>::QG, 1)
cf_bwd_kernel(const float* __restrict__ h, const float* __restrict__ geo,
              const float* __restrict__ W1p, const float* __restrict__ b1,
              const float* __restrict__ W2, const float* __restrict__ b2,
              const int* __restrict__ qcol, const int* __restrict__ dcol,
              const int* __restrict__ esorted, const int* __restrict__ grp,
              const float* __restrict__ g, float* __restrict__ dh,
              float* __restrict__ ggeo, double* __restrict__ wpart,
              int ncol, int P, int Ktot, int G, int B) {
  using S = BwdShape<kWgrad>;
  constexpr int E = kBwdE, RT = E / 16, NW = S::NW, NTH = S::NTH;
  constexpr int kPh = NTH / kF;  // row phases of the per-feature passes
  constexpr int kSt = NTH / E;   // staging threads a slot
  extern __shared__ __align__(16) float smem[];
  const int Bp = bwd_bp(B), MP = bwd_mp(B), LDP = MP + 4, nch = B + 4;
  float* W2s = smem;                  // [F][kLdF]
  float* W1s = W2s + kF * kLdF;       // [Bp][kLdF]
  // the filter weights, in shared memory for the block's groups
  for (int t = threadIdx.x; t < kF * kF; t += blockDim.x)
    W2s[(t / kF) * kLdF + t % kF] = __ldg(W2 + t);
  for (int t = threadIdx.x; t < Bp * kF; t += blockDim.x)
    W1s[(t / kF) * kLdF + t % kF] = __ldg(W1p + t);
  __syncthreads();
  // group q takes row range vb of the grid's ncol * G
  const int q = threadIdx.x / NTH, tid = threadIdx.x - q * NTH;
  const int vb = blockIdx.x * S::QG + q;
  if (vb >= ncol * G) return;
  const int col = vb / G, grow = vb - col * G;
  auto sync = [&]() { group_sync(1 + q, NTH); };

  float* PHI = W1s + Bp * kLdF + q * bwd_group_floats(B, kWgrad);
  // PHI [2][E][LDP] phi | 1 | 0
  float* s_fc = PHI + 2 * E * LDP;    // [2][E] fcut
  // [2][E] the slot's channel 0 in geo and ggeo (8-byte aligned: every
  // array above has an even number of floats)
  size_t* s_goff = reinterpret_cast<size_t*>(s_fc + 2 * E);
  int* s_q = reinterpret_cast<int*>(s_goff + 2 * E);  // [2][E] qcol
  int* s_dcl = s_q + 2 * E;           // [2][E] dcol
  int* s_dc = s_dcl + 2 * E;          // [2][E] destination column
  float* H1 = reinterpret_cast<float*>(s_dc + 2 * E);  // [E][kLdF] h1
  float* SG = H1 + E * kLdF;          // sigmoid(z1) -> gz1
  float* PR = SG + E * kLdF;          // pre -> gpre
  float* GH = kWgrad ? PR + E * kLdF : H1;  // ghj (h1 is dead by then)
  float* s_gfc = PR + (kWgrad ? 2 : 1) * E * kLdF;  // [E][kQ]
  float* GW2 = s_gfc + E * kQ;        // wgrad [F][kLdA]
  float* GW1 = GW2 + kF * kLdA;       // [MP][kLdA]

  const int* gb = grp + ((size_t)col * (G + 1) + grow) * 2;
  const int r0 = gb[0], e0 = gb[1], r1 = gb[2], e1 = gb[3];
  const size_t row0 = (size_t)col * P;  // the column's first row of h, dh

  // stage the chunk at esorted[base, base + E) into buffer b: slot st_e's
  // channels st_p, st_p + kSt, ... (phi, then the ones column and zeros),
  // and (st_p == 0) its fcut, qcol, dcol and offsets, by cp.async
  const int st_e = tid % E, st_p = tid / E;
  auto slot_at = [&](int e) { return e < e1 ? esorted[e] : 0; };
  auto stage = [&](int b, int base, int s) {
    const bool ok = base + st_e < e1;
    const int dc = s / Ktot, k = s - dc * Ktot;
    const size_t goff = (size_t)dc * nch * Ktot + k;
    float* ph = PHI + (b * E + st_e) * LDP;
    for (int c = st_p; c < LDP; c += kSt) {
      if (ok && c < B) cp_async4(ph + c, geo + goff + (size_t)c * Ktot);
      else ph[c] = ok && c == B ? 1.f : 0.f;
    }
    if (st_p == 0) {
      const int i = b * E + st_e;
      if (ok) {
        cp_async4(s_fc + i, geo + goff + (size_t)B * Ktot);
        cp_async4(s_q + i, qcol + s);
        cp_async4(s_dcl + i, dcol + s);
      } else {
        s_fc[i] = 0.f;
        s_q[i] = 0;
        s_dcl[i] = 0;
      }
      s_goff[i] = goff;
      s_dc[i] = dc;
    }
    cp_async_commit();
  };
  stage(0, e0, slot_at(e0 + st_e));
  int sl_nxt = slot_at(e0 + E + st_e);

  // the padded slots of destination column col: 0 in every channel
  if (grow == 0)
    for (int k = tid; k < Ktot; k += NTH)
      if (qcol[(size_t)col * Ktot + k] < 0)
        for (int c = 0; c < nch; ++c)
          ggeo[((size_t)col * nch + c) * Ktot + k] = 0.f;
  if constexpr (kWgrad)
    for (int t = tid; t < (kF + MP) * kLdA; t += NTH) GW2[t] = 0.f;

  // the fold (threads tid < kF, feature tid): the open source row `run`,
  // its sum, and the first row of the range not yet written
  int run = -1, next = r0;
  float racc = 0.f;
  float gb2 = 0.f;  // wgrad: feature tid % kF of gpre, this thread's rows
  const int ef = tid & (kF - 1), eph = tid / kF;  // E1: feature, row phase

  for (int base = e0, it = 0; base < e1; base += E, ++it) {
    const int buf = it & 1, n = min(E, e1 - base);
    const float* phi = PHI + buf * E * LDP;
    const float* fc = s_fc + buf * E;
    const size_t* goff = s_goff + buf * E;
    const int* qs = s_q + buf * E;
    cp_async_wait<0>();
    sync();  // (A) this chunk staged; the last one done with every tile
    if (base + E < e1) {  // the next chunk's loads run under this one
      stage(buf ^ 1, base + E, sl_nxt);
      sl_nxt = slot_at(base + 2 * E + st_e);
    }
    {  // P1: z1 = phi W1 + b1 -> h1, sigmoid(z1)
      const MmaSeg seg[1] = {{phi, LDP, 0, W1s, kLdF, Bp}};
      rows_mma<RT, 1, S::NT, NW, false, kWShared>(
          seg, kF, [&](int, int r, int f, float v) {
            // ssp(z) and sigmoid(z) from one exp(-|z|), by the fast
            // intrinsics (the exact functions: 0.040 of the tolerance
            // against the float64 twin at the bench, 0.063 fast, 13%
            // slower)
            const float z = v + __ldg(b1 + f), ez = __expf(-fabsf(z));
            const float inv = __fdividef(1.f, 1.f + ez);
            H1[r * kLdF + f] = fmaxf(z, 0.f) + __logf(1.f + ez) - kLn2;
            SG[r * kLdF + f] = z >= 0.f ? inv : ez * inv;
          });
    }
    sync();  // (B)
    {  // P2: pre = h1 W2 + b2
      const MmaSeg seg[1] = {{H1, kLdF, 0, W2s, kLdF, kF}};
      rows_mma<RT, 1, S::NT, NW, false, kWShared>(
          seg, kF, [&](int, int r, int f, float v) {
            PR[r * kLdF + f] = v + __ldg(b2 + f);
          });
    }
    // E1's operands, loaded before the barrier: the destination rows'
    // cotangents and the source rows
    float gm[E / kPh], hj[E / kPh];
#pragma unroll
    for (int m = 0; m < E / kPh; ++m) {
      const int e = eph + kPh * m, i = buf * E + e;
      const bool ok = e < n;
      gm[m] = ok ? __ldg(g + ((size_t)s_dc[i] * P + s_dcl[i]) * kF + ef)
                 : 0.f;
      hj[m] = ok ? __ldg(h + (row0 + qs[e]) * kF + ef) : 0.f;
    }
    sync();  // (C)
    // E1: thread (ef, eph) takes feature ef of the rows eph, eph + kPh, ...
#pragma unroll
    for (int m = 0; m < E / kPh; ++m) {
      const int e = eph + kPh * m;
      float* pr = PR + e * kLdF + ef;
      const float p = *pr, gw = gm[m] * hj[m], gp = gw * fc[e];
      GH[e * kLdF + ef] = gm[m] * p * fc[e];
      *pr = gp;
      if constexpr (kWgrad) gb2 += gp;
      const float s = warp_sum(gw * p);
      if ((tid & 31) == 0) s_gfc[e * kQ + (ef >> 5)] = s;
    }
    sync();  // (D)
    if (tid < n) {  // gfcut and the dir channels of the chunk's slots
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kQ; ++q) s += s_gfc[tid * kQ + q];
      float* o = ggeo + goff[tid] + (size_t)B * Ktot;
      o[0] = s;
      o[Ktot] = 0.f;
      o[2 * (size_t)Ktot] = 0.f;
      o[3 * (size_t)Ktot] = 0.f;
    }
    if (tid < kF) {  // the fold of ghj onto the source rows, in slot order
      float v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = GH[e * kLdF + tid];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e >= n) break;
        const int q = qs[e];
        if (q != run) {
          if (run >= 0) {
            dh[(row0 + run) * kF + tid] = racc;
            next = run + 1;
          }
          for (; next < q; ++next) dh[(row0 + next) * kF + tid] = 0.f;
          run = q;
          racc = 0.f;
        }
        racc += v[e];
      }
    }
    {  // P3: gh1 = gpre W2^T; gz1 = gh1 sigmoid(z1) over sigmoid(z1)
      const MmaSeg seg[1] = {{PR, kLdF, 0, W2s, kLdF, kF}};
      rows_mma<RT, 1, S::NT, NW, false, kWSharedT>(
          seg, kF, [&](int, int r, int f, float v) {
            float* sg = SG + r * kLdF + f;
            *sg = v * *sg;
          });
    }
    if constexpr (kWgrad)  // gW2 += h1^T gpre
      acc_tn<E, 4, NW>(H1, kLdF, kF, PR, kLdF, GW2);
    sync();  // (E) gz1 complete
    {  // P4: gphi = gz1 W1^T at the slots' channels b < B
      const MmaSeg seg[1] = {{SG, kLdF, 0, W1s, kLdF, kF}};
      rows_mma<RT, 1, 1, NW, false, kWSharedT>(
          seg, Bp, [&](int, int r, int b, float v) {
            if (b < B && r < n) ggeo[goff[r] + (size_t)b * Ktot] = v;
          });
    }
    if constexpr (kWgrad)  // [gW1; gb1] += [phi | 1]^T gz1
      acc_tn<E, 4, NW>(phi, LDP, MP, SG, kLdF, GW1);
  }
  if (tid < kF) {  // close the last run; rows after it get 0
    if (run >= 0) {
      dh[(row0 + run) * kF + tid] = racc;
      next = run + 1;
    }
    for (; next < r1; ++next) dh[(row0 + next) * kF + tid] = 0.f;
  }
  if constexpr (kWgrad) {  // this block's partial [gW1 | gb1 | gW2 | gb2]
    sync();  // every product is in the sums
    double* pw = wpart + ((size_t)col * G + grow) *
                             ((size_t)(B + 2) * kF + kF * kF);
    for (int t = tid; t < (B + 1) * kF; t += NTH)
      pw[t] = GW1[(t / kF) * kLdA + t % kF];
    for (int t = tid; t < kF * kF; t += NTH)
      pw[(B + 1) * kF + t] = GW2[(t / kF) * kLdA + t % kF];
    H1[eph * kLdF + ef] = gb2;  // kPh <= E rows, free now
    sync();
    if (tid < kF) {
      float s = 0.f;
      for (int p = 0; p < kPh; ++p) s += H1[p * kLdF + tid];
      pw[(B + 1) * kF + kF * kF + tid] = s;
    }
  }
}

// opt in to `smem` bytes of dynamic shared memory (K9's W2 alone is 64 KB)
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

size_t bwd_smem_bytes(int B, bool wgrad) {
  return bwd_smem_floats(B, wgrad) * sizeof(float);
}

template <bool kWgrad>
int launch_bwd(const float* h, const float* geo, const float* W1p,
               const float* b1, const float* W2, const float* b2,
               const int* qcol, const int* dcol, const int* esorted,
               const int* grp, const float* g, float* dh, float* ggeo,
               double* wpart, int ncol, int P, int Ktot, int G, int B,
               cudaStream_t stream) {
  using S = BwdShape<kWgrad>;
  int err = set_smem(cf_bwd_kernel<kWgrad>, bwd_smem_bytes(B, kWgrad));
  if (err) return err;
  const int blocks = (ncol * G + S::QG - 1) / S::QG;
  cf_bwd_kernel<kWgrad><<<blocks, 32 * S::NW * S::QG,
                          bwd_smem_bytes(B, kWgrad), stream>>>(
      h, geo, W1p, b1, W2, b2, qcol, dcol, esorted, grp, g, dh, ggeo, wpart,
      ncol, P, Ktot, G, B);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory of K9 (mode 0, for column capacity P), K10 (mode
// 1) or K10's wgrad instance (mode 2) for B basis functions, bytes a
// block; K10's does not depend on P
extern "C" int spk_cf_smem_bytes(int B, int P, int mode) {
  if (mode == 0)
    return (int)(smem_floats(B, P) * sizeof(float) + 4 * kE * sizeof(int));
  return (int)bwd_smem_bytes(B, mode == 2);
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

// W1p [Bp, F] (W1 with zero rows up to Bp); esorted and grp the source
// schedule of the nx * ny columns in G row ranges each; wpart [nx * ny *
// G][(B+2) F + F F] f64 (the wgrad instance) or null
extern "C" int spk_cf_bwd(const float* h, const float* geo, const float* W1p,
                          const float* b1, const float* W2, const float* b2,
                          const int* qcol, const int* dcol,
                          const int* esorted, const int* grp, const float* g,
                          float* dh, float* ggeo, double* wpart, int nx,
                          int ny, int P, int Ktot, int G, int B,
                          cudaStream_t stream) {
  if (B > kMaxB) return (int)cudaErrorInvalidValue;
  auto* fn = wpart != nullptr ? launch_bwd<true> : launch_bwd<false>;
  return fn(h, geo, W1p, b1, W2, b2, qcol, dcol, esorted, grp, g, dh, ggeo,
            wpart, nx * ny, P, Ktot, G, B, stream);
}
