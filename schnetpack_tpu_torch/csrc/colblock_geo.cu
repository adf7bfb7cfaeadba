// Per-edge geometry of the column layout for Hopper (sm_90a), f32.
//
// K5 geo_fwd_kernel replaces the TPU kernel
//   schnetpack_tpu/ops/colblock_geo.py:202 _geo_fwd_kernel
//   (launcher :155 _geo_fwd_call), packed along Ktot, in both of its forms:
//   channels [phi*fcut (B), fcut, dir (3)] for PaiNN and, ``raw``, the
//   raw-phi form [phi*emask (B), fcut, dir (3)] for SchNet, whose filter
//   network is nonlinear in phi (schnetpack_tpu/ops/schnet_columns.py:
//   10-12); with nch = B+5 the distance d follows (``with_d``).
// K8 geo_bwd_slot_kernel and geo_bwd_row_kernel replace
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
// K8 is two kernels, both without atomics or shared memory, for any P.
// (a) geo_bwd_slot_kernel runs on K5's grid, one thread per real edge
// slot: it reads the slot's B+4 cotangent channels (coalesced along Ktot),
// recomputes rij, d, fcut and phi as K5 does and chains the cotangent
// g = [gphi (B), gfc, gdir (3)] back to rij:
//   gd   = sum_b gphi_b 2 coeff_b (d - c_b) phi_b + gfc dfcut/dd
//   grij = gdir / d - rij (gdir . rij) / d^3 + gd dir
// (the raw-phi branch of colblock_geo.py:253-257; phi carries emask, which
// is 1 on every real slot), and stores grij as a float4 of a scratch
// [nx * ny * Ktot] (padded slots are left unwritten and never read).
// (b) geo_bwd_row_kernel: one thread per atom row r adds grij over r's
// run of slots in the source order (``ops/colblock.py::source_order``)
// and, apart, over its run in the destination order (``destination_order``)
// -- each in slot order, one 16-byte load a slot -- and writes dR[r] =
// source sum - destination sum once.  Both orders are those that K10 and
// K9 already cached on the SchNet step's refs: the step sorts nothing more.
// The TPU's 9 per-source-column partials (colblock_geo.py:267-269,
// 302-304) would write and read back 9 tables more.

#include <cuda_runtime.h>

#include "colblock_message.cuh"   // KOffs, bucket_of, kPi

namespace {

constexpr int kThreads = 128;     // slots a K5 / K8 (a) block
constexpr int kRowThreads = 64;   // rows a K8 (b) block

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
    const int scol = source_col(ci, cj, bucket_of(k, ko), nx, ny);
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

// K8 (a): grij of slot k of column blockIdx.y, one thread a slot.
__global__ void __launch_bounds__(kThreads)
geo_bwd_slot_kernel(const float* __restrict__ R,
                    const float* __restrict__ coff,
                    const float* __restrict__ cw, const int* __restrict__ qcol,
                    const int* __restrict__ dcol,
                    const float* __restrict__ ggeo, float4* __restrict__ grij,
                    int nx, int ny, int P, int Ktot, KOffs ko, int B,
                    float rc) {
  const int col = blockIdx.y;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= Ktot) return;
  const int ci = col / ny, cj = col - ci * ny;
  const size_t e = (size_t)col * Ktot + k;
  const int q = qcol[e];
  if (q < 0) return;
  const float* Rs =
      R + ((size_t)source_col(ci, cj, bucket_of(k, ko), nx, ny) * P + q) * 3;
  const float* Rd = R + ((size_t)col * P + dcol[e]) * 3;
  const float* oc = coff + (size_t)col * 3 * Ktot + k;
  const float rx = Rs[0] + oc[0] - Rd[0];
  const float ry = Rs[1] + oc[Ktot] - Rd[1];
  const float rz = Rs[2] + oc[2 * Ktot] - Rd[2];
  const float d = sqrtf(rx * rx + ry * ry + rz * rz);
  const float inv = 1.f / d;
  const float pi_rc = kPi / rc;
  const float dfc = d < rc ? -0.5f * pi_rc * sinf(d * pi_rc) : 0.f;
  const float* g = ggeo + (size_t)col * (B + 4) * Ktot + k;
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
  grij[e] = make_float4(gx * inv - rx * gdr + gdi * rx,
                        gy * inv - ry * gdr + gdi * ry,
                        gz * inv - rz * gdr + gdi * rz, 0.f);
}

// the sum of grij over the slots sorted[begin] .. sorted[end - 1]
__device__ __forceinline__ float3 run_sum(const float4* __restrict__ grij,
                                          const int* __restrict__ sorted,
                                          int begin, int end) {
  float3 s = make_float3(0.f, 0.f, 0.f);
#pragma unroll 4
  for (int p = begin; p < end; ++p) {
    const float4 v = grij[sorted[p]];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
  }
  return s;
}

// K8 (b): dR of row r, its source run's grij less its destination run's.
__global__ void __launch_bounds__(kRowThreads)
geo_bwd_row_kernel(const float4* __restrict__ grij,
                   const int* __restrict__ esorted,
                   const int* __restrict__ rowptr,
                   const int* __restrict__ dsorted,
                   const int* __restrict__ rowptr_dst,
                   float* __restrict__ dR, int A) {
  const int r = blockIdx.x * kRowThreads + threadIdx.x;
  if (r >= A) return;
  const float3 src = run_sum(grij, esorted, rowptr[r], rowptr[r + 1]);
  const float3 dst = run_sum(grij, dsorted, rowptr_dst[r], rowptr_dst[r + 1]);
  dR[(size_t)r * 3 + 0] = src.x - dst.x;
  dR[(size_t)r * 3 + 1] = src.y - dst.y;
  dR[(size_t)r * 3 + 2] = src.z - dst.z;
}

}  // namespace

extern "C" int spk_geo_fwd(const float* R, const float* coff, const float* cw,
                           const int* qcol, const int* dcol, float* geo,
                           int nx, int ny, int P, int Ktot, const int* koffs,
                           int B, int nch, int raw, float rc,
                           cudaStream_t stream) {
  dim3 grid((Ktot + kThreads - 1) / kThreads, nx * ny);
  geo_fwd_kernel<<<grid, kThreads, 0, stream>>>(R, coff, cw, qcol, dcol, geo,
                                                nx, ny, P, Ktot,
                                                make_koffs(koffs), B, nch,
                                                raw, rc);
  return (int)cudaGetLastError();
}

// K8: grij [nx * ny * Ktot] float4 is the caller's scratch; esorted /
// rowptr and dsorted / rowptr_dst the source and destination runs of the
// A = nx * ny * P rows.
extern "C" int spk_geo_bwd(const float* R, const float* coff, const float* cw,
                           const int* qcol, const int* dcol,
                           const float* ggeo, float* grij,
                           const int* esorted, const int* rowptr,
                           const int* dsorted, const int* rowptr_dst,
                           float* dR, int nx, int ny, int P, int Ktot,
                           const int* koffs, int B, float rc,
                           cudaStream_t stream) {
  const int A = nx * ny * P;
  if (A == 0) return 0;
  float4* g4 = reinterpret_cast<float4*>(grij);
  if (Ktot > 0) {
    const dim3 grid((Ktot + kThreads - 1) / kThreads, nx * ny);
    geo_bwd_slot_kernel<<<grid, kThreads, 0, stream>>>(
        R, coff, cw, qcol, dcol, ggeo, g4, nx, ny, P, Ktot,
        make_koffs(koffs), B, rc);
  }
  geo_bwd_row_kernel<<<(A + kRowThreads - 1) / kRowThreads, kRowThreads, 0,
                       stream>>>(g4, esorted, rowptr, dsorted, rowptr_dst, dR,
                                 A);
  return (int)cudaGetLastError();
}
