// Packed per-edge geometry of the column layout for Hopper (sm_90a), f32.
//
// K5 geo_fwd_kernel replaces the TPU kernel
//   schnetpack_tpu/ops/colblock_geo.py:202 _geo_fwd_kernel
//   (launcher :155 _geo_fwd_call) in the form the hybrid PaiNN path uses:
//   packed along Ktot, channels [phi*fcut (B), fcut, dir (3)] and, with
//   nch = B+5, the distance d (``with_d``).
//
// Layout as in colblock_message.cu: slot k of column (i, j) lies in bucket
// c9 = (dx+1)*3 + (dy+1), [koffs[c9], koffs[c9+1]); its source is row qcol
// of column ((i+dx) mod nx, (j+dy) mod ny), its destination row dcol of
// column (i, j).  Output geo [nx, ny, nch, Ktot] is channel-major: channel
// ch of slot k of column col lies at (col * nch + ch) * Ktot + k.
// Padded slots (qcol < 0) get d = 1 (sqrt(|0|^2 + 1)), dir = 0, fcut = 0
// and phi*fcut = 0, exactly as column_geometry_xla(..., with_d=True).
//
// What bounds it on the H100: one thread per edge slot does B exp and a
// cos and stores B+5 floats; at the 10k-atom bench the output is ~25 MB,
// so the kernel is bound by that store stream (a few microseconds of HBM
// time at 3.35 TB/s) and by the scattered position loads.  Stores are
// channel-major along Ktot, so the 32 threads of a warp write 32
// neighbouring addresses of every channel.  The TPU selected positions
// with one-hot matmuls in 3 bf16 pieces for exact f32 (an MXU device);
// here the two position rows are read by index in f32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kPi = 3.14159265358979323846f;

struct KOffs {
  int o[10];
};

__global__ void __launch_bounds__(kThreads)
geo_fwd_kernel(const float* __restrict__ R, const float* __restrict__ coff,
               const float* __restrict__ cw, const int* __restrict__ qcol,
               const int* __restrict__ dcol, float* __restrict__ geo, int nx,
               int ny, int P, int Ktot, KOffs ko, int B, int nch, float rc) {
  const int col = blockIdx.y;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= Ktot) return;
  const int ci = col / ny, cj = col - ci * ny;
  const size_t e = (size_t)col * Ktot + k;
  const int q = qcol[e];
  float rx = 0.f, ry = 0.f, rz = 0.f, pad = 1.f;
  if (q >= 0) {
    int c9 = 0;
    while (k >= ko.o[c9 + 1]) ++c9;
    const int si = (ci + c9 / 3 - 1 + nx) % nx;
    const int sj = (cj + c9 % 3 - 1 + ny) % ny;
    const size_t src = ((size_t)(si * ny + sj) * P + q) * 3;
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
  float* out = geo + (size_t)col * nch * Ktot + k;
  for (int b = 0; b < B; ++b) {
    const float df = d - cw[2 * b];
    out[(size_t)b * Ktot] = expf(cw[2 * b + 1] * df * df) * fcut;
  }
  out[(size_t)B * Ktot] = fcut;
  out[(size_t)(B + 1) * Ktot] = rx * inv;
  out[(size_t)(B + 2) * Ktot] = ry * inv;
  out[(size_t)(B + 3) * Ktot] = rz * inv;
  if (nch > B + 4) out[(size_t)(B + 4) * Ktot] = d;
}

}  // namespace

extern "C" int spk_geo_fwd(const float* R, const float* coff, const float* cw,
                           const int* qcol, const int* dcol, float* geo,
                           int nx, int ny, int P, int Ktot, const int* koffs,
                           int B, int nch, float rc, cudaStream_t stream) {
  KOffs ko;
  for (int i = 0; i < 10; ++i) ko.o[i] = koffs[i];
  dim3 grid((Ktot + kThreads - 1) / kThreads, nx * ny);
  geo_fwd_kernel<<<grid, kThreads, 0, stream>>>(R, coff, cw, qcol, dcol, geo,
                                                nx, ny, P, Ktot, ko, B, nch,
                                                rc);
  return (int)cudaGetLastError();
}
