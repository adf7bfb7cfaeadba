// General instances of SchNet's cfconv on the column layout for Hopper
// (sm_90a), f32: every filter width F >= 1 and basis size B >= 1.
//
// The tuned instances (schnet_columns.cu) take F = 64 or 128 (a template
// argument) and B <= 32.  These take every other shape and replace the
// same TPU kernels:
// K9 cf_fwd_gen_kernel: schnetpack_tpu/ops/schnet_columns.py:79
//   _cf_fwd_kernel;
// K10 cf_bwd_gen_kernel<W>: schnetpack_tpu/ops/schnet_columns.py:145
//   _cf_bwd_kernel: dh and the geometry cotangent, and with W the filter
//   weight cotangents gW1 [B, F], gb1, gW2 [F, F], gb2.
// The per-slot math, the layout and the schedules are the tuned kernels'
// (their header): z1 = phi W1 + b1, h1 = ssp(z1), pre = h1 W2 + b2, out_i
// += h_j pre fcut; the VJP gW = g_i h_j, gfcut = sum_f gW pre, gpre = gW
// fcut, gh1 = gpre W2^T, gz1 = gh1 sigmoid(z1), gphi = gz1 W1^T.
//
// The design: the filters are cut into Z = ceil(F / 256) tiles of NT
// threads; block (col, g, z) walks row range g of column col (K9: the
// destination schedule, K10: the source schedule) in chunks of E slots
// (E from the shared memory that fits, at most 16).  Per chunk the block
// stages the slots' basis rows and computes z1 for all F hidden units of
// every slot (the (slot, unit) pairs over the threads, k-loops in order;
// the filter products' sums are f64: in f32 the gfcut channel, an F-long
// sum that can cancel, and gphi missed the float64 twin by more than
// 1e-5 from F = 96 on the H100);
// then thread f of the tile walks the chunk in order: pre_f (F FMAs), and
// the run sum of the open output row in a register, stored once when the
// row's run ends (rows without a slot get 0).  K9 skips the slots with
// fcut = 0, which add exactly 0.  K10 sums the tile's gpre W2^T and
// gfcut per slot through shared memory in feature order; with Z > 1 each
// tile writes its own partial of the geometry cotangent (the wrapper sums
// them).  The wgrad instance adds each chunk's sums into the block's own
// f64 partial [gW1 | gb1 | gW2 | gb2] in global memory, each element by one
// thread (gW2 and gb2: the tile's columns; gW1 and gb1: the tile's
// share), which the wrapper adds up.  No atomics.
//
// What bounds them on the H100: the filter MLP, B F + F^2 FMAs a slot
// forward and about twice that backward, at the FP32 rate (run here with
// f64 sums, at the FP64 rate, half of it); these instances
// also read W1 and W2 through L1 per (slot, unit) and recompute z1 in
// every filter tile.

#include <cuda_runtime.h>

// KOffs, bucket_of
#include "colblock_message.cuh"

namespace {

constexpr int kGenTile = 256;  // filters a block, at most
constexpr int kGenE = 16;      // slots a chunk, at most
constexpr float kLn2g = 0.69314718055994531f;

__host__ __device__ inline int cf_tiles(int F) {
  return (F + kGenTile - 1) / kGenTile;
}
__host__ __device__ inline int cf_threads(int F) {
  const int Z = cf_tiles(F), w = (F + Z - 1) / Z;
  return (w + 31) / 32 * 32;
}

__device__ __forceinline__ float ssp_g(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - kLn2g;
}
__device__ __forceinline__ float sigmoid_g(float z) {
  const float e = expf(-fabsf(z));
  return z >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);
}

inline size_t cf_fwd_gen_smem(int E, int F, int B) {
  return sizeof(float) * (size_t)E * (B + F + 1) + sizeof(int) * 3 * E;
}
inline size_t cf_bwd_gen_smem(int E, int F, int NT, int B) {
  return sizeof(float) * (size_t)E * (B + 3 * F + 2 * NT + 2) +
         sizeof(int) * 3 * E;
}

template <typename Fn>
int cf_chunk(Fn smem) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int E = kGenE;
  while (E > 0 && smem(E) > (size_t)optin) --E;
  return E;
}

// z1 = phi W1 + b1 of the chunk's n slots (phi [n][B] at s_phi) for all F
// hidden units, into s_z [n][F]
__device__ void cf_z1(const float* s_phi, float* s_z, const float* W1,
                      const float* b1, int n, int F, int B) {
  for (int i = threadIdx.x; i < n * F; i += blockDim.x) {
    const int t = i / F, j = i - t * F;
    const float* ph = s_phi + (size_t)t * B;
    double acc = 0.0;
    for (int b = 0; b < B; ++b)
      acc = fma((double)ph[b], (double)__ldg(W1 + (size_t)b * F + j), acc);
    s_z[i] = (float)(acc + __ldg(b1 + j));
  }
}

__global__ void __launch_bounds__(kGenTile)
    cf_fwd_gen_kernel(const float* __restrict__ h,
                      const float* __restrict__ geo,
                      const float* __restrict__ W1,
                      const float* __restrict__ b1,
                      const float* __restrict__ W2,
                      const float* __restrict__ b2,
                      const int* __restrict__ qcol,
                      const int* __restrict__ dcol,
                      const int* __restrict__ dsorted,
                      const int* __restrict__ grp, float* __restrict__ out,
                      int nx, int ny, int P, int Ktot, KOffs ko, int G,
                      int B, int F, int E) {
  extern __shared__ __align__(16) float cf_smem[];
  const int NT = blockDim.x, col = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, f = blockIdx.z * NT + tid;
  const bool fok = f < F;
  const int fl = fok ? f : F - 1;
  const int ci = col / ny, cj = col - ci * ny;
  const int* gb = grp + ((size_t)col * (G + 1) + g) * 2;
  const int r0 = gb[0], e0 = gb[1], r1 = gb[2], e1 = gb[3];
  float* s_phi = cf_smem;                      // [E][B]
  float* s_z = s_phi + (size_t)E * B;          // [E][F] z1 -> h1
  float* s_fc = s_z + (size_t)E * F;           // [E] fcut
  int* s_src = reinterpret_cast<int*>(s_fc + E);  // [E] source row or -1
  int* s_dst = s_src + E;                      // [E] destination row
  int* s_k = s_dst + E;                        // [E]
  const size_t row0 = (size_t)col * P, gcol = (size_t)col * (B + 4) * Ktot;

  int run = -1, next = r0;
  float acc = 0.f;
  auto put = [&](int r, float v) {
    if (fok) out[(row0 + r) * F + f] = v;
  };
  for (int base = e0; base < e1; base += E) {
    const int n = min(E, e1 - base);
    __syncthreads();  // the last chunk's readers are done
    if (tid < n) {
      const int slot = dsorted[base + tid], k = slot - col * Ktot;
      const int c9 = bucket_of(k, ko), c3 = c9 / 3;
      int si = ci + c3 - 1, sj = cj + c9 - 3 * c3 - 1;
      si += si < 0 ? nx : (si >= nx ? -nx : 0);
      sj += sj < 0 ? ny : (sj >= ny ? -ny : 0);
      const float fc = geo[gcol + (size_t)B * Ktot + k];
      s_src[tid] = fc != 0.f ? (si * ny + sj) * P + qcol[slot] : -1;
      s_dst[tid] = dcol[slot];
      s_k[tid] = k;
      s_fc[tid] = fc;
    }
    __syncthreads();
    for (int i = tid; i < n * B; i += NT) {
      const int t = i / B, b = i - t * B;
      s_phi[i] = geo[gcol + (size_t)b * Ktot + s_k[t]];
    }
    __syncthreads();
    cf_z1(s_phi, s_z, W1, b1, n, F, B);
    __syncthreads();
    for (int i = tid; i < n * F; i += NT) s_z[i] = ssp_g(s_z[i]);
    __syncthreads();
    for (int t = 0; t < n; ++t) {  // filter f of the chunk's slots
      const int sv = s_src[t];
      if (sv < 0) continue;  // fcut = 0 adds exactly 0
      const int dt = s_dst[t];
      if (dt != run) {
        if (run >= 0) {
          put(run, acc);
          next = run + 1;
        }
        for (; next < dt; ++next) put(next, 0.f);
        run = dt;
        acc = 0.f;
      }
      const float* h1 = s_z + (size_t)t * F;
      double pd = 0.0;
      for (int j = 0; j < F; ++j)
        pd = fma((double)h1[j], (double)__ldg(W2 + (size_t)j * F + fl), pd);
      const float pre = (float)(pd + __ldg(b2 + fl));
      acc = fmaf(h[(size_t)sv * F + fl], pre * s_fc[t], acc);
    }
  }
  if (run >= 0) {
    put(run, acc);
    next = run + 1;
  }
  for (; next < r1; ++next) put(next, 0.f);
}

template <bool kWgrad>
__global__ void __launch_bounds__(kGenTile)
    cf_bwd_gen_kernel(const float* __restrict__ h,
                      const float* __restrict__ geo,
                      const float* __restrict__ W1,
                      const float* __restrict__ b1,
                      const float* __restrict__ W2,
                      const float* __restrict__ b2,
                      const int* __restrict__ qcol,
                      const int* __restrict__ dcol,
                      const int* __restrict__ esorted,
                      const int* __restrict__ grp,
                      const float* __restrict__ g, float* __restrict__ dh,
                      float* __restrict__ ggeo, size_t gz,
                      double* __restrict__ wpart, int P, int Ktot, int G,
                      int B, int F, int E) {
  extern __shared__ __align__(16) float cf_smem[];
  const int NT = blockDim.x, col = blockIdx.x, gr = blockIdx.y;
  const int z = blockIdx.z, tid = threadIdx.x, f0 = z * NT, f = f0 + tid;
  const int nt = min(NT, F - f0);
  const bool fok = f < F;
  const int fl = fok ? f : F - 1;
  const int* gb = grp + ((size_t)col * (G + 1) + gr) * 2;
  const int r0 = gb[0], e0 = gb[1], r1 = gb[2], e1 = gb[3];
  float* s_phi = cf_smem;                      // [E][B]
  float* s_z = s_phi + (size_t)E * B;          // [E][F] z1
  float* s_h1 = s_z + (size_t)E * F;           // [E][F] h1 = ssp(z1)
  float* s_gz = s_h1 + (size_t)E * F;          // [E][F] gz1 (this tile's)
  float* s_gpre = s_gz + (size_t)E * F;        // [E][NT] gpre
  float* s_gfp = s_gpre + (size_t)E * NT;      // [E][NT] gfcut terms
  float* s_fc = s_gfp + (size_t)E * NT;        // [E] fcut
  float* s_gfc = s_fc + E;                     // [E] gfcut (this tile's)
  int* s_src = reinterpret_cast<int*>(s_gfc + E);  // [E] own source row
  int* s_dst = s_src + E;                      // [E] global destination row
  int* s_slot = s_dst + E;                     // [E]
  const size_t own0 = (size_t)col * P;
  float* gg = ggeo + z * gz;
  // this block's partial [gW1 B F | gb1 F | gW2 F F | gb2 F] (zero-filled
  // by the wrapper)
  double* pw = kWgrad ? wpart + (((size_t)col * G + gr) * gridDim.z + z) *
                                    ((size_t)(B + 2) * F + (size_t)F * F)
                      : nullptr;
  float gb2 = 0.f;

  int run = -1, next = r0;
  float acc = 0.f;
  auto put = [&](int r, float v) {
    if (fok) dh[(own0 + r) * F + f] = v;
  };
  for (int base = e0; base < e1; base += E) {
    const int n = min(E, e1 - base);
    __syncthreads();  // the last chunk's readers are done
    if (tid < n) {
      const int slot = esorted[base + tid];
      const int dcl = slot / Ktot, k = slot - dcl * Ktot;
      s_src[tid] = qcol[slot];
      s_dst[tid] = dcl * P + dcol[slot];
      s_slot[tid] = slot;
      s_fc[tid] = geo[((size_t)dcl * (B + 4) + B) * Ktot + k];
    }
    __syncthreads();
    for (int i = tid; i < n * B; i += NT) {
      const int t = i / B, b = i - t * B;
      const int slot = s_slot[t], dcl = slot / Ktot;
      s_phi[i] = geo[((size_t)dcl * (B + 4) + b) * Ktot + slot - dcl * Ktot];
    }
    __syncthreads();
    cf_z1(s_phi, s_z, W1, b1, n, F, B);
    __syncthreads();
    for (int i = tid; i < n * F; i += NT) s_h1[i] = ssp_g(s_z[i]);
    __syncthreads();
    // filter f of the chunk's slots in order: pre, the fold of ghj onto
    // the open source row, gpre and the gfcut term
    for (int t = 0; t < n; ++t) {
      const float* h1 = s_h1 + (size_t)t * F;
      double pd = 0.0;
      for (int j = 0; j < F; ++j)
        pd = fma((double)h1[j], (double)__ldg(W2 + (size_t)j * F + fl), pd);
      const float pre = (float)(pd + __ldg(b2 + fl));
      const int sv = s_src[t];
      const float fc = s_fc[t];
      const float gm = g[(size_t)s_dst[t] * F + fl];
      const float hj = h[(own0 + sv) * F + fl];
      if (sv != run) {
        if (run >= 0) {
          put(run, acc);
          next = run + 1;
        }
        for (; next < sv; ++next) put(next, 0.f);
        run = sv;
        acc = 0.f;
      }
      acc = fmaf(gm, pre * fc, acc);
      const float gW = gm * hj, on = fok ? 1.f : 0.f;
      const float gp = on * (gW * fc);
      s_gpre[(size_t)t * NT + tid] = gp;
      s_gfp[(size_t)t * NT + tid] = on * (gW * pre);
      gb2 += gp;
    }
    __syncthreads();
    // gz1 = (gpre W2^T) sigmoid(z1) over the tile's filters; gfcut
    for (int i = tid; i < n * F; i += NT) {
      const int t = i / F, j = i - t * F;
      const float* gp = s_gpre + (size_t)t * NT;
      const float* w2 = W2 + (size_t)j * F + f0;
      double a = 0.0;
      for (int c = 0; c < nt; ++c) a = fma((double)gp[c], (double)__ldg(w2 + c), a);
      s_gz[i] = (float)a * sigmoid_g(s_z[i]);
    }
    for (int t = tid; t < n; t += NT) {
      const float* gp = s_gfp + (size_t)t * NT;
      double a = 0.0;
      for (int c = 0; c < nt; ++c) a += gp[c];
      s_gfc[t] = (float)a;
    }
    if (kWgrad && fok) {  // gW2[:, f] += h1^T gpre[:, f]
      double* o = pw + (size_t)(B + 1) * F;
      for (int j = 0; j < F; ++j) {
        float a = 0.f;
        for (int t = 0; t < n; ++t)
          a = fmaf(s_h1[(size_t)t * F + j], s_gpre[(size_t)t * NT + tid], a);
        o[(size_t)j * F + f] += (double)a;
      }
    }
    __syncthreads();
    // the geometry cotangent [gphi (B), gfcut] of each slot (this tile's
    // partial where Z > 1); the wgrad instance's [gW1; gb1] += [phi | 1]^T
    // gz1
    for (int i = tid; i < n * (B + 1); i += NT) {
      const int t = i / (B + 1), c = i - t * (B + 1);
      float v;
      if (c < B) {
        const float* gz1 = s_gz + (size_t)t * F;
        double a = 0.0;
        for (int j = 0; j < F; ++j)
          a = fma((double)gz1[j], (double)__ldg(W1 + (size_t)c * F + j), a);
        v = (float)a;
      } else {
        v = s_gfc[t];
      }
      const int slot = s_slot[t], dcl = slot / Ktot;
      gg[((size_t)dcl * (B + 4) + c) * Ktot + slot - dcl * Ktot] = v;
    }
    if (kWgrad) {
      for (int i = tid; i < (B + 1) * F; i += NT) {
        const int b = i / F, j = i - b * F;
        float a = 0.f;
        for (int t = 0; t < n; ++t)
          a = fmaf(b < B ? s_phi[(size_t)t * B + b] : 1.f,
                   s_gz[(size_t)t * F + j], a);
        pw[i] += (double)a;
      }
    }
  }
  if (run >= 0) {
    put(run, acc);
    next = run + 1;
  }
  for (; next < r1; ++next) put(next, 0.f);
  if (kWgrad && fok) pw[(size_t)(B + 1) * F + (size_t)F * F + f] = gb2;
}

}  // namespace

// K9's general instance: dsorted and grp the destination schedule of the
// nx * ny columns in G row ranges each
extern "C" int spk_cf_fwd_gen(const float* h, const float* geo,
                              const float* W1, const float* b1,
                              const float* W2, const float* b2,
                              const int* qcol, const int* dcol,
                              const int* dsorted, const int* grp, float* out,
                              int nx, int ny, int P, int Ktot,
                              const int* koffs, int G, int B, int F,
                              cudaStream_t stream) {
  const int E = cf_chunk([&](int e) { return cf_fwd_gen_smem(e, F, B); });
  if (E == 0 || F < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = cf_fwd_gen_smem(E, F, B);
  cudaError_t err = cudaFuncSetAttribute(
      cf_fwd_gen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cf_fwd_gen_kernel<<<dim3(nx * ny, G, cf_tiles(F)), cf_threads(F), smem,
                      stream>>>(h, geo, W1, b1, W2, b2, qcol, dcol, dsorted,
                                grp, out, nx, ny, P, Ktot, make_koffs(koffs),
                                G, B, F, E);
  return (int)cudaGetLastError();
}

// K10's general instance: esorted and grp the source schedule; ggeo [Z, nx,
// ny, B+4, Ktot] zero-filled (Z = the filter tiles); wpart [nx * ny * G *
// Z][(B+2) F + F F] f64 zero-filled (the wgrad instance) or null
extern "C" int spk_cf_bwd_gen(const float* h, const float* geo,
                              const float* W1, const float* b1,
                              const float* W2, const float* b2,
                              const int* qcol, const int* dcol,
                              const int* esorted, const int* grp,
                              const float* g, float* dh, float* ggeo,
                              double* wpart, int nx, int ny, int P, int Ktot,
                              int G, int B, int F, cudaStream_t stream) {
  const int NT = cf_threads(F);
  const int E = cf_chunk([&](int e) { return cf_bwd_gen_smem(e, F, NT, B); });
  if (E == 0 || F < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = cf_bwd_gen_smem(E, F, NT, B);
  auto* kern = wpart != nullptr ? cf_bwd_gen_kernel<true>
                                : cf_bwd_gen_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t gz = (size_t)nx * ny * (B + 4) * Ktot;
  kern<<<dim3(nx * ny, G, cf_tiles(F)), NT, smem, stream>>>(
      h, geo, W1, b1, W2, b2, qcol, dcol, esorted, grp, g, dh, ggeo, gz,
      wpart, P, Ktot, G, B, F, E);
  return (int)cudaGetLastError();
}
