// Per-edge geometry of the column layout for Hopper (sm_90a), f32.
//
// K5 geo_fwd_kernel replaces the TPU kernel
//   schnetpack_tpu/ops/colblock_geo.py:202 _geo_fwd_kernel
//   (launcher :155 _geo_fwd_call), packed along Ktot, in both of its forms:
//   channels [phi*fcut (B), fcut, dir (3)] for PaiNN and, ``raw``, the
//   raw-phi form [phi*emask (B), fcut, dir (3)] for SchNet, whose filter
//   network is nonlinear in phi (schnetpack_tpu/ops/schnet_columns.py:
//   10-12); with nch = B+5 the distance d follows (``with_d``).
// K8 geo_bwd_kernel replaces
//   schnetpack_tpu/ops/colblock_geo.py:230 _geo_bwd_kernel (launcher :273
//   _geo_bwd_call) in its raw-phi form: the cotangent of the B+4 raw-phi
//   channels -> the position cotangent dR.
//
// Layout as in colblock_message.cu: slot k of column (i, j) lies in bucket
// c9 = (dx+1)*3 + (dy+1), [koffs[c9], koffs[c9+1]); its source is row qcol
// of column ((i+dx) mod nx, (j+dy) mod ny), its destination row dcol of
// column (i, j).  geo [nx, ny, nch, Ktot] is channel-major: channel ch of
// slot k of column col lies at (col * nch + ch) * Ktot + k.  Padded slots
// (qcol < 0) get d = 1 (sqrt(|0|^2 + 1)), dir = 0, fcut = 0 and 0 in the
// basis channels, exactly as column_geometry_xla(...) writes them.
//
// What bounds K5 on the H100: one thread per edge slot does B exp and a
// cos and stores B+5 floats; at the 10k-atom bench the output is ~25 MB,
// so the kernel is bound by that store stream (a few microseconds of HBM
// time at 3.35 TB/s) and by the scattered position loads.  Stores are
// channel-major along Ktot, so the 32 threads of a warp write 32
// neighbouring addresses of every channel.  The TPU selected positions
// with one-hot matmuls in 3 bf16 pieces for exact f32 (an MXU device);
// here the two position rows are read by index in f32.
//
// K8 runs one block per column and, inside it, one thread per edge slot:
// the thread recomputes rij, d, fcut and phi as K5 does and chains the
// cotangent g = [gphi (B), gfc, gdir (3)] back to rij:
//   gd   = sum_b gphi_b 2 coeff_b (d - c_b) phi_b + gfc dfcut/dd
//   grij = gdir / d - rij (gdir . rij) / d^3 + gd dir
// (the raw-phi branch of colblock_geo.py:253-257; phi carries emask, which
// is 1 on every slot the thread works on).  Each sum has one writer and no
// atomics: the chunk's grij go to shared memory, then 54 threads, one per
// (bucket, end, component), add them in slot order into per-bucket
// accumulators [9][P][3] of the destination rows (own column) and of the
// source rows (the bucket's source column).  The block writes the
// destination sums, added over the buckets, to dRo [col][P][3] and the
// source sums to the partial part[c9][source column][P][3], which has one
// writer since the bucket shift is a bijection of the columns; the wrapper
// adds the 9 partials (the TPU's scheme, colblock_geo.py:267-269, 302-304).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBwdThreads = 256;
constexpr float kPi = 3.14159265358979323846f;

struct KOffs {
  int o[10];
};

__device__ __forceinline__ int bucket_of(const KOffs& ko, int k) {
  int c9 = 0;
  while (k >= ko.o[c9 + 1]) ++c9;
  return c9;
}

// source column of bucket c9 of column (ci, cj)
__device__ __forceinline__ int source_col(int ci, int cj, int c9, int nx,
                                          int ny) {
  return ((ci + c9 / 3 - 1 + nx) % nx) * ny + (cj + c9 % 3 - 1 + ny) % ny;
}

__global__ void __launch_bounds__(kThreads)
geo_fwd_kernel(const float* __restrict__ R, const float* __restrict__ coff,
               const float* __restrict__ cw, const int* __restrict__ qcol,
               const int* __restrict__ dcol, float* __restrict__ geo, int nx,
               int ny, int P, int Ktot, KOffs ko, int B, int nch, int raw,
               float rc) {
  const int col = blockIdx.y;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= Ktot) return;
  const int ci = col / ny, cj = col - ci * ny;
  const size_t e = (size_t)col * Ktot + k;
  const int q = qcol[e];
  float rx = 0.f, ry = 0.f, rz = 0.f, pad = 1.f;
  if (q >= 0) {
    const int scol = source_col(ci, cj, bucket_of(ko, k), nx, ny);
    const size_t src = ((size_t)scol * P + q) * 3;
    const size_t dst = ((size_t)col * P + dcol[e]) * 3;
    const float* oc = coff + (size_t)col * 3 * Ktot + k;
    rx = R[src + 0] + oc[0] - R[dst + 0];
    ry = R[src + 1] + oc[Ktot] - R[dst + 1];
    rz = R[src + 2] + oc[2 * Ktot] - R[dst + 2];
    pad = 0.f;
  }
  const float d = sqrtf(rx * rx + ry * ry + rz * rz + pad);
  const float inv = 1.f / d;
  const float fcut =
      (q >= 0 && d < rc) ? 0.5f * (cosf(d * (kPi / rc)) + 1.f) : 0.f;
  // raw: phi * emask; otherwise phi * fcut
  const float scale = raw ? (q >= 0 ? 1.f : 0.f) : fcut;
  float* out = geo + (size_t)col * nch * Ktot + k;
  for (int b = 0; b < B; ++b) {
    const float df = d - cw[2 * b];
    out[(size_t)b * Ktot] = expf(cw[2 * b + 1] * df * df) * scale;
  }
  out[(size_t)B * Ktot] = fcut;
  out[(size_t)(B + 1) * Ktot] = rx * inv;
  out[(size_t)(B + 2) * Ktot] = ry * inv;
  out[(size_t)(B + 3) * Ktot] = rz * inv;
  if (nch > B + 4) out[(size_t)(B + 4) * Ktot] = d;
}

__global__ void __launch_bounds__(kBwdThreads)
geo_bwd_kernel(const float* __restrict__ R, const float* __restrict__ coff,
               const float* __restrict__ cw, const int* __restrict__ qcol,
               const int* __restrict__ dcol, const float* __restrict__ ggeo,
               float* __restrict__ dRo, float* __restrict__ part, int nx,
               int ny, int P, int Ktot, KOffs ko, int B, float rc) {
  extern __shared__ float smem[];
  constexpr int T = kBwdThreads;
  const int col = blockIdx.x, ncol = nx * ny;
  const int ci = col / ny, cj = col - ci * ny;
  const int tid = threadIdx.x;
  const int nch = B + 4;
  float* s_g = smem;                  // [T][3] grij of the chunk
  float* s_src = s_g + 3 * T;         // [9][P][3] source-row sums
  float* s_dst = s_src + 27 * P;      // [9][P][3] destination-row sums
  int* s_q = reinterpret_cast<int*>(s_dst + 27 * P);  // [T] (-1 pad)
  int* s_dv = s_q + T;                                // [T]

  for (int t = tid; t < 54 * P; t += T) s_src[t] = 0.f;  // and s_dst
  const float pi_rc = kPi / rc;
  const int* qc = qcol + (size_t)col * Ktot;
  const int* dc = dcol + (size_t)col * Ktot;
  const float* Rown = R + (size_t)col * P * 3;

  for (int base = 0; base < Ktot; base += T) {
    __syncthreads();  // the previous chunk's fold is done (and the zeroing)
    const int k = base + tid;
    int q = -1, dv = 0;
    if (k < Ktot) {
      q = qc[k];
      dv = dc[k];
    }
    if (q >= 0) {
      const int c9 = bucket_of(ko, k);
      const float* Rs =
          R + ((size_t)source_col(ci, cj, c9, nx, ny) * P + q) * 3;
      const float* oc = coff + (size_t)col * 3 * Ktot + k;
      const float rx = Rs[0] + oc[0] - Rown[dv * 3 + 0];
      const float ry = Rs[1] + oc[Ktot] - Rown[dv * 3 + 1];
      const float rz = Rs[2] + oc[2 * Ktot] - Rown[dv * 3 + 2];
      const float d = sqrtf(rx * rx + ry * ry + rz * rz);
      const float inv = 1.f / d;
      const float dfc = d < rc ? -0.5f * pi_rc * sinf(d * pi_rc) : 0.f;
      const float* g = ggeo + (size_t)col * nch * Ktot + k;
      float gd = g[(size_t)B * Ktot] * dfc;
      for (int b = 0; b < B; ++b) {
        const float df = d - cw[2 * b];
        const float phi = expf(cw[2 * b + 1] * df * df);
        gd = fmaf(g[(size_t)b * Ktot], 2.f * cw[2 * b + 1] * df * phi, gd);
      }
      const float gx = g[(size_t)(B + 1) * Ktot];
      const float gy = g[(size_t)(B + 2) * Ktot];
      const float gz = g[(size_t)(B + 3) * Ktot];
      const float gdr = (gx * rx + gy * ry + gz * rz) * inv * inv * inv;
      const float gdi = gd * inv;
      s_g[tid * 3 + 0] = gx * inv - rx * gdr + gdi * rx;
      s_g[tid * 3 + 1] = gy * inv - ry * gdr + gdi * ry;
      s_g[tid * 3 + 2] = gz * inv - rz * gdr + gdi * rz;
    }
    s_q[tid] = q;
    s_dv[tid] = dv;
    __syncthreads();
    if (tid < 54) {
      // thread (bucket c9, end: source or destination, component c) adds
      // the chunk's slots of its bucket in slot order
      const int c9 = tid / 6, end = (tid % 6) / 3, c = tid % 3;
      const int lo = max(base, ko.o[c9]);
      const int hi = min(min(base + T, ko.o[c9 + 1]), Ktot);
      float* acc = (end == 0 ? s_src : s_dst) + c9 * P * 3 + c;
      for (int kk = lo; kk < hi; ++kk) {
        const int t = kk - base;
        const int qv = s_q[t];
        if (qv < 0) continue;
        const float v = s_g[t * 3 + c];
        if (end == 0)
          acc[qv * 3] += v;
        else
          acc[s_dv[t] * 3] -= v;
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < 3 * P; t += T) {
    float s = 0.f;
    for (int c9 = 0; c9 < 9; ++c9) s += s_dst[c9 * 3 * P + t];
    dRo[(size_t)col * 3 * P + t] = s;
  }
  for (int t = tid; t < 27 * P; t += T) {
    const int c9 = t / (3 * P), r = t - c9 * 3 * P;
    const int scol = source_col(ci, cj, c9, nx, ny);
    part[((size_t)c9 * ncol + scol) * 3 * P + r] = s_src[t];
  }
}

}  // namespace

extern "C" int spk_geo_fwd(const float* R, const float* coff, const float* cw,
                           const int* qcol, const int* dcol, float* geo,
                           int nx, int ny, int P, int Ktot, const int* koffs,
                           int B, int nch, int raw, float rc,
                           cudaStream_t stream) {
  KOffs ko;
  for (int i = 0; i < 10; ++i) ko.o[i] = koffs[i];
  dim3 grid((Ktot + kThreads - 1) / kThreads, nx * ny);
  geo_fwd_kernel<<<grid, kThreads, 0, stream>>>(R, coff, cw, qcol, dcol, geo,
                                                nx, ny, P, Ktot, ko, B, nch,
                                                raw, rc);
  return (int)cudaGetLastError();
}

extern "C" int spk_geo_bwd(const float* R, const float* coff, const float* cw,
                           const int* qcol, const int* dcol,
                           const float* ggeo, float* dRo, float* part, int nx,
                           int ny, int P, int Ktot, const int* koffs, int B,
                           float rc, cudaStream_t stream) {
  KOffs ko;
  for (int i = 0; i < 10; ++i) ko.o[i] = koffs[i];
  const size_t smem =
      (size_t)(3 * kBwdThreads + 54 * P) * sizeof(float) +
      2 * kBwdThreads * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      geo_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  geo_bwd_kernel<<<nx * ny, kBwdThreads, smem, stream>>>(
      R, coff, cw, qcol, dcol, ggeo, dRo, part, nx, ny, P, Ktot, ko, B, rc);
  return (int)cudaGetLastError();
}
