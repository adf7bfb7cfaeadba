// PaiNN message of the 27-cell atom layout for Hopper (sm_90a), f32, and
// its VJP.
//
// K18 cell_msg_fwd_kernel replaces schnetpack_tpu/ops/painn_fused.py:116
//   _fwd_kernel (launcher :149 _fused_fwd_call, pallas_call :161);
// K19 cell_msg_bwd_kernel<W> replaces :185 _bwd_kernel (launcher :283
//   _fused_bwd, pallas_call :300, folded by the rolls at :333-339);
//   W = kWgrad: false without, true with the filter-weight cotangent.
//
// For destination row a and its slots k (source row j, layout and decode
// in cellblock.cuh), with x = xmu[:, :3F] and mu = xmu[:, 3F:] (components
// c = 0..2 of F each):
//   W      = rbf_aug[a, k] @ FW_aug                    [3F]
//   xW     = x[j] * W = [dqe, dmuR, dmumu]             (F each)
//   K18    dq[a]      = sum_k dqe
//          dmu[a, c]  = sum_k dmuR * dir[a, k, c] + dmumu * mu[j, c]
//   K19    gxW        = [g_dq[a], sum_c g_dmu[a, c] dir_c,
//                        sum_c g_dmu[a, c] mu[j, c]]
//          dxmu[j]   += [gxW * W, g_dmu[a, c] * dmumu (c = 0..2)]
//          grbf[a, k] = (gxW * x[j]) @ FW_aug^T          [B+1]
//          gdir[a, k, c] = sum_f g_dmu[a, c] * dmuR
//          gFW       += rbf_aug[a, k]^T (gxW * x[j])     (kWgrad)
//
// The TPU kernels gather x_j and mu_j with one-hot matrix products over
// the 27C candidates of a cell and fold dxmu back the same way into 9
// halo'd partials; here rows are read by index.  Per real edge the work is
// the filter (B+1)*3F FMAs and a few feature loads, twice that backward,
// and the kernels are bound by the latency of those scattered row loads
// and of the dependent FMA chains (the feature table, 49 MB at the 10k
// bench, mostly stays in the 50 MB L2), not by HBM bandwidth.  Designs:
//
// * K18 is destination-major and needs no atomics: one block per cell of
//   3F threads, thread part*F + f owns column part*F + f of W (its B+1
//   filter weights in registers, no redundant filter work).  The block
//   walks the cell's C rows; per row it stages the K slots' basis, dir and
//   decoded source rows in shared memory, each thread sums its column over
//   the K slots in registers (kU slots in flight), and parts 1 (dmuR) and
//   2 (dmumu) meet in shared memory before the row is written once.
// * K19 is source-centric, as K15 (colblock_message.cu) is: one block per
//   source cell walks that cell's edges in source-sorted order (esorted /
//   rowptr, ops/cellblock_gather.py::source_order), 32 at a time.  Thread
//   part*F + f keeps the current source row's dxmu sums (column part*F+f,
//   and for part 2 the three mu columns of f) in registers while the row's
//   run lasts and stores them once: one writer per row, deterministic, no
//   atomics.  grbf and gdir belong to one edge each and are written at the
//   edge's own slot (the wrapper zero-fills, so padded slots stay 0).
//   kWgrad adds gFW as K2, K7 and K15 sum it: f32 sums over a chunk's 32
//   edges in registers, added to the block's f64 sums in shared memory,
//   one f64 [B+1, 3F] partial per block that the wrapper sums.
// Tensor cores for the filter product are later work.

#include <cuda_runtime.h>

#include "cellblock.cuh"

namespace {

constexpr int kMaxThreads = 384;  // 3F threads, F <= 128
constexpr int kEdges = 32;        // K19 edges per chunk
constexpr int kU = 4;             // edges in flight per thread
constexpr int kMaxB1 = 32;        // B+1 bound (filter weights in registers)

// K18: one block per destination cell, 3F threads
__global__ void __launch_bounds__(kMaxThreads)
    cell_msg_fwd_kernel(const float* __restrict__ xmu,
                        const float* __restrict__ rbf,
                        const float* __restrict__ dir,
                        const float* __restrict__ FW,
                        const int* __restrict__ qidx, float* __restrict__ dq,
                        float* __restrict__ dmu, int nx, int ny, int nz,
                        int C, int K, int F, int B) {
  extern __shared__ float smem[];
  const int B1 = B + 1, D3 = 3 * F, D6 = 6 * F;
  const int cell = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int part = tid / F, f = tid - part * F;
  float* s_rbf = smem;                 // [K][B1]
  float* s_dir = s_rbf + K * B1;       // [K][3]
  float* s_mix = s_dir + K * 3;        // [3][F] part 1's dmu sums
  int* s_src = reinterpret_cast<int*>(s_mix + 3 * F);  // [K] (-1 pad)

  float fw[kMaxB1];                    // FW_aug[:, tid]
#pragma unroll
  for (int b = 0; b < kMaxB1; ++b) fw[b] = b < B1 ? FW[b * D3 + tid] : 0.f;

  for (int r = 0; r < C; ++r) {
    const int a = cell * C + r;
    const size_t e0 = (size_t)a * K;
    __syncthreads();                   // the previous row's readers are done
    for (int t = tid; t < K * B1; t += nth) s_rbf[t] = rbf[e0 * B1 + t];
    for (int t = tid; t < K * 3; t += nth) s_dir[t] = dir[e0 * 3 + t];
    for (int t = tid; t < K; t += nth) {
      const int q = qidx[e0 + t];
      s_src[t] = q >= 0 ? cell_source_row((int)e0 + t, q, nx, ny, nz, C, K)
                        : -1;
    }
    __syncthreads();
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
    for (int k0 = 0; k0 < K; k0 += kU) {
      int src[kU];
      float w[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        src[u] = k0 + u < K ? s_src[k0 + u] : -1;
        w[u] = 0.f;
      }
#pragma unroll
      for (int b = 0; b < kMaxB1; ++b)
        if (b < B1) {
#pragma unroll
          for (int u = 0; u < kU; ++u)
            w[u] = fmaf(s_rbf[min(k0 + u, K - 1) * B1 + b], fw[b], w[u]);
        }
      float xw[kU], m0[kU], m1[kU], m2[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const size_t row = (size_t)max(src[u], 0) * D6;
        xw[u] = xmu[row + tid] * w[u];
        if (part == 2) {
          m0[u] = xmu[row + D3 + f];
          m1[u] = xmu[row + D3 + F + f];
          m2[u] = xmu[row + D3 + 2 * F + f];
        } else if (part == 1) {
          const float* dv = s_dir + min(k0 + u, K - 1) * 3;
          m0[u] = dv[0];
          m1[u] = dv[1];
          m2[u] = dv[2];
        } else {
          m0[u] = m1[u] = m2[u] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (src[u] < 0) continue;
        if (part == 0) {
          acc0 += xw[u];
        } else {
          acc0 = fmaf(xw[u], m0[u], acc0);
          acc1 = fmaf(xw[u], m1[u], acc1);
          acc2 = fmaf(xw[u], m2[u], acc2);
        }
      }
    }
    if (part == 1) {
      s_mix[f] = acc0;
      s_mix[F + f] = acc1;
      s_mix[2 * F + f] = acc2;
    }
    __syncthreads();
    if (part == 0) {
      dq[(size_t)a * F + f] = acc0;
    } else if (part == 2) {
      float* o = dmu + (size_t)a * D3;
      o[f] = s_mix[f] + acc0;
      o[F + f] = s_mix[F + f] + acc1;
      o[2 * F + f] = s_mix[2 * F + f] + acc2;
    }
  }
}

// K19: one block per source cell, 3F threads
template <bool kWgrad>
__global__ void __launch_bounds__(kMaxThreads)
    cell_msg_bwd_kernel(const float* __restrict__ xmu,
                        const float* __restrict__ rbf,
                        const float* __restrict__ dir,
                        const float* __restrict__ FW,
                        const int* __restrict__ qidx,
                        const int* __restrict__ esorted,
                        const int* __restrict__ rowptr,
                        const float* __restrict__ g_dq,
                        const float* __restrict__ g_dmu,
                        float* __restrict__ dxmu, float* __restrict__ grbf,
                        float* __restrict__ gdir, double* __restrict__ gFWp,
                        int nx, int ny, int nz, int C, int K, int F, int B) {
  extern __shared__ float smem[];
  constexpr int E = kEdges;
  const int B1 = B + 1, D3 = 3 * F, D6 = 6 * F, LD = D3 + 1;  // LD: pad
  const int NW = F / 32;                                       // warps/part
  const int cell = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, part = tid / F, f = tid - part * F;
  const int row0 = cell * C;
  const int e0 = rowptr[row0], e1 = rowptr[row0 + C];

  double* s_gfw = reinterpret_cast<double*>(smem);  // [B1][D3] (kWgrad)
  float* s_fw = smem + (kWgrad ? 2 * B1 * D3 : 0);  // [B1][LD]
  float* s_gw = s_fw + B1 * LD;        // [E][LD] filter cotangent per edge
  float* s_rbf = s_gw + E * LD;        // [E][B1]
  float* s_dir = s_rbf + E * B1;       // [E][3]
  float* s_gdir = s_dir + E * 3;       // [E][NW][3] per-warp partials
  int* s_src = reinterpret_cast<int*>(s_gdir + E * NW * 3);  // [E] (-1 pad)
  int* s_slot = s_src + E;             // [E] edge slot a*K + k

  for (int r = row0; r < row0 + C; ++r) {  // rows without edges stay zero
    dxmu[(size_t)r * D6 + tid] = 0.f;
    if (part == 2) {
      dxmu[(size_t)r * D6 + D3 + f] = 0.f;
      dxmu[(size_t)r * D6 + D3 + F + f] = 0.f;
      dxmu[(size_t)r * D6 + D3 + 2 * F + f] = 0.f;
    }
  }
  for (int t = tid; t < B1 * D3; t += nth)
    s_fw[(t / D3) * LD + t % D3] = FW[t];

  int run = -1;                        // source row of the open run
  float a_dx = 0.f, a_m0 = 0.f, a_m1 = 0.f, a_m2 = 0.f;
  float a_fw[kWgrad ? kMaxB1 : 1];     // gFW column tid, this chunk
  if constexpr (kWgrad) {
#pragma unroll
    for (int b = 0; b < kMaxB1; ++b) a_fw[b] = 0.f;
    for (int b = 0; b < B1; ++b) s_gfw[(size_t)b * D3 + tid] = 0.0;
  }
  for (int base = e0; base < e1; base += E) {
    __syncthreads();  // previous chunk finished (and the set-up above)
    if (tid < E) {    // decode, one edge per thread of warp 0
      const int p = base + tid;
      int src = -1;
      if (p < e1) {
        const int e = esorted[p];
        src = cell_source_row(e, qidx[e], nx, ny, nz, C, K);
        s_slot[tid] = e;
      }
      s_src[tid] = src;
    }
    __syncthreads();
    const int n = min(E, e1 - base);
    for (int idx = tid; idx < n * (B1 + 3); idx += nth) {
      const int t = idx / (B1 + 3), c = idx - t * (B1 + 3);
      const size_t e = s_slot[t];
      if (c < B1)
        s_rbf[t * B1 + c] = rbf[e * B1 + c];
      else
        s_dir[t * 3 + c - B1] = dir[e * 3 + c - B1];
    }
    __syncthreads();
    // message backward, kU edges in flight per thread: loads and products
    // first, then the run sums in edge order
    for (int t0 = 0; t0 < n; t0 += kU) {
      int sv[kU];
      size_t so[kU], sd[kU];
      float w[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const bool ok = t0 + u < n;
        sv[u] = ok ? s_src[t0 + u] : -1;
        so[u] = (size_t)max(sv[u], 0) * D6;
        sd[u] = ok ? (size_t)(s_slot[t0 + u] / K) : 0;
        w[u] = 0.f;
      }
      for (int b = 0; b < B1; ++b) {
        const float fw = s_fw[b * LD + tid];
#pragma unroll
        for (int u = 0; u < kU; ++u)
          w[u] = fmaf(s_rbf[min(t0 + u, E - 1) * B1 + b], fw, w[u]);
      }
      float gx[kU], gwv[kU], gm0[kU], gm1[kU], gm2[kU], xw[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float xv = xmu[so[u] + tid];
        xw[u] = xv * w[u];                 // dmuR (part 1), dmumu (part 2)
        float gpart;
        if (part == 0) {
          gm0[u] = gm1[u] = gm2[u] = 0.f;
          gpart = g_dq[sd[u] * F + f];
        } else {
          const float* gm = g_dmu + sd[u] * D3;
          gm0[u] = gm[f];
          gm1[u] = gm[F + f];
          gm2[u] = gm[2 * F + f];
          if (part == 1) {
            const float* dv = s_dir + min(t0 + u, E - 1) * 3;
            gpart = gm0[u] * dv[0] + gm1[u] * dv[1] + gm2[u] * dv[2];
          } else {
            const float* ms = xmu + so[u] + D3;
            gpart = gm0[u] * ms[f] + gm1[u] * ms[F + f] + gm2[u] * ms[2 * F + f];
          }
        }
        gx[u] = gpart * w[u];
        gwv[u] = gpart * xv;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (sv[u] < 0) continue;
        if (sv[u] != run) {            // the run of row `run` ended
          if (run >= 0) {
            float* o = dxmu + (size_t)run * D6;
            o[tid] = a_dx;
            if (part == 2) {
              o[D3 + f] = a_m0;
              o[D3 + F + f] = a_m1;
              o[D3 + 2 * F + f] = a_m2;
            }
          }
          run = sv[u];
          a_dx = a_m0 = a_m1 = a_m2 = 0.f;
        }
        a_dx += gx[u];
        a_m0 = fmaf(gm0[u], xw[u], a_m0);
        a_m1 = fmaf(gm1[u], xw[u], a_m1);
        a_m2 = fmaf(gm2[u], xw[u], a_m2);
        if constexpr (kWgrad) {        // gFW[:, tid] += rbf_aug_e gW_e[tid]
          const float* rb = s_rbf + (t0 + u) * B1;
#pragma unroll
          for (int b = 0; b < kMaxB1; ++b)
            if (b < B1) a_fw[b] = fmaf(rb[b], gwv[u], a_fw[b]);
        }
        s_gw[(t0 + u) * LD + tid] = gwv[u];
      }
      if (part == 1) {  // dir cotangent: sum_f g_dmu_c * dmuR over the part
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          float p0 = gm0[u] * xw[u], p1 = gm1[u] * xw[u], p2 = gm2[u] * xw[u];
          for (int sh = 16; sh > 0; sh >>= 1) {
            p0 += __shfl_xor_sync(0xffffffffu, p0, sh);
            p1 += __shfl_xor_sync(0xffffffffu, p1, sh);
            p2 += __shfl_xor_sync(0xffffffffu, p2, sh);
          }
          if (lane == 0 && sv[u] >= 0) {
            float* gd = s_gdir + ((t0 + u) * NW + (f >> 5)) * 3;
            gd[0] = p0;
            gd[1] = p1;
            gd[2] = p2;
          }
        }
      }
    }
    if constexpr (kWgrad) {  // the chunk's f32 sums into the block's f64
#pragma unroll
      for (int b = 0; b < kMaxB1; ++b)
        if (b < B1) {
          s_gfw[(size_t)b * D3 + tid] += (double)a_fw[b];
          a_fw[b] = 0.f;
        }
    }
    __syncthreads();
    // per-edge cotangents at the edge's own slot: grbf[t][b] = sum over
    // the 3F columns of gw[t] * FW[b], gdir[t] = the warps' partials
    for (int idx = tid; idx < n * (B1 + 3); idx += nth) {
      const int t = idx / (B1 + 3), c = idx - t * (B1 + 3);
      const size_t e = s_slot[t];
      if (c < B1) {
        const float* gw = s_gw + t * LD;
        const float* fw = s_fw + c * LD;
        float acc = 0.f;
        for (int k = 0; k < D3; ++k) acc = fmaf(gw[k], fw[k], acc);
        grbf[e * B1 + c] = acc;
      } else {
        float v = 0.f;
        for (int w = 0; w < NW; ++w) v += s_gdir[(t * NW + w) * 3 + c - B1];
        gdir[e * 3 + c - B1] = v;
      }
    }
  }
  if (run >= 0) {                      // close the last run
    float* o = dxmu + (size_t)run * D6;
    o[tid] = a_dx;
    if (part == 2) {
      o[D3 + f] = a_m0;
      o[D3 + F + f] = a_m1;
      o[D3 + 2 * F + f] = a_m2;
    }
  }
  if constexpr (kWgrad) {              // this block's gFW partial
    double* out = gFWp + (size_t)cell * B1 * D3 + tid;
    for (int b = 0; b < B1; ++b)
      out[(size_t)b * D3] = s_gfw[(size_t)b * D3 + tid];
  }
}

template <bool kWgrad>
int launch_bwd(const float* xmu, const float* rbf, const float* dir,
               const float* FW, const int* qidx, const int* esorted,
               const int* rowptr, const float* g_dq, const float* g_dmu,
               float* dxmu, float* grbf, float* gdir, double* gFWp, int nx,
               int ny, int nz, int C, int K, int F, int B,
               cudaStream_t stream) {
  const int E = kEdges, B1 = B + 1, LD = 3 * F + 1;
  const size_t smem =
      sizeof(double) * (kWgrad ? (size_t)B1 * 3 * F : 0) +
      sizeof(float) * ((size_t)B1 * LD + (size_t)E * LD + E * B1 + E * 3 +
                       E * (F / 32) * 3) +
      sizeof(int) * 2 * E;
  cudaError_t err = cudaFuncSetAttribute(
      cell_msg_bwd_kernel<kWgrad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cell_msg_bwd_kernel<kWgrad><<<nx * ny * nz, 3 * F, smem, stream>>>(
      xmu, rbf, dir, FW, qidx, esorted, rowptr, g_dq, g_dmu, dxmu, grbf, gdir,
      gFWp, nx, ny, nz, C, K, F, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spk_cell_msg_fwd(const float* xmu, const float* rbf,
                                const float* dir, const float* FW,
                                const int* qidx, float* dq, float* dmu,
                                int nx, int ny, int nz, int C, int K, int F,
                                int B, cudaStream_t stream) {
  if (B + 1 > kMaxB1 || F % 32 || 3 * F > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)K * (B + 1) + K * 3 + 3 * F) +
                      sizeof(int) * K;
  cudaError_t err = cudaFuncSetAttribute(
      cell_msg_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cell_msg_fwd_kernel<<<nx * ny * nz, 3 * F, smem, stream>>>(
      xmu, rbf, dir, FW, qidx, dq, dmu, nx, ny, nz, C, K, F, B);
  return (int)cudaGetLastError();
}

// the kWgrad instance when a gFW partial buffer is given, else the plain one
extern "C" int spk_cell_msg_bwd(const float* xmu, const float* rbf,
                                const float* dir, const float* FW,
                                const int* qidx, const int* esorted,
                                const int* rowptr, const float* g_dq,
                                const float* g_dmu, float* dxmu, float* grbf,
                                float* gdir, double* gFWp, int nx, int ny,
                                int nz, int C, int K, int F, int B,
                                cudaStream_t stream) {
  if (B + 1 > kMaxB1 || F % 32 || 3 * F > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  auto* fn = gFWp != nullptr ? launch_bwd<true> : launch_bwd<false>;
  return fn(xmu, rbf, dir, FW, qidx, esorted, rowptr, g_dq, g_dmu, dxmu, grbf,
            gdir, gFWp, nx, ny, nz, C, K, F, B, stream);
}
