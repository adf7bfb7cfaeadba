// PaiNN mixing kernels for Hopper (sm_90a), f32, flat [A, 3F] layout.
//
// K3 mix_fwd_kernel replaces the TPU kernel
//   schnetpack_tpu/ops/painn_mixing.py:73 _mix_fwd_kernel
// K4 mix_bwd_kernel replaces
//   schnetpack_tpu/ops/painn_mixing.py:83 _mix_bwd_kernel
//   (input cotangents only: no weight cotangents).
//
// Forward per row: q' = q + dq, mu' = mu + dmu (the interaction residual,
// fused into the prologue); V_c = mu'_c Wv, W_c = mu'_c Ww;
// Vn = sqrt(sum_c V_c^2 + eps); h = act(q' k0[:F] + Vn k0[F:] + b0);
// (a, b, c) = h k1 + b1; q_out = q' + a + c * sum_c V_c W_c;
// mu_out_c = mu'_c + b * W_c.  The backward recomputes the forward and
// chains the cotangents; q and dq (mu and dmu) share one cotangent.
//
// What bounds them on the H100: eleven [rows, F] x [F, F] products per
// row block, ~11 F^2 FMAs per row forward and ~2x that backward — FP32
// CUDA-core throughput with weights re-read from L2 by every block.  The
// design keeps a row block's intermediates in shared memory (one pass over
// device memory for the feature tables, as on the TPU), one thread per
// output feature with ROWS accumulators in registers, weights read
// coalesced from L2 (the backward takes transposed copies from the wrapper
// so its transposed products stay coalesced).  Tensor cores (wgmma) and
// TMA staging are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsFwd = 16;
constexpr int kRowsBwd = 8;

__device__ __forceinline__ float act_f(float x, int act) {
  if (act == 1) return x / (1.f + expf(-x));  // silu
  // shifted softplus: softplus(x) - ln 2
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))) - 0.69314718055994531f;
}

__device__ __forceinline__ float dact_f(float x, int act) {
  const float s = 1.f / (1.f + expf(-x));
  return act == 1 ? s * (1.f + x * (1.f - s)) : s;
}

// Shared intermediates of one row block: qp [ROWS][F], mup/V/W [ROWS][3F],
// Vn/pre/h [ROWS][F] — 13 F floats per row.
struct Tiles {
  float *qp, *mup, *V, *W, *Vn, *pre, *h;
};

__device__ Tiles carve(float* smem, int rows, int F) {
  Tiles s;
  s.qp = smem;
  s.mup = s.qp + rows * F;
  s.V = s.mup + rows * 3 * F;
  s.W = s.V + rows * 3 * F;
  s.Vn = s.W + rows * 3 * F;
  s.pre = s.Vn + rows * F;
  s.h = s.pre + rows * F;
  return s;
}

template <int ROWS>
__device__ void mix_recompute(const float* __restrict__ q,
                              const float* __restrict__ mu,
                              const float* __restrict__ dq,
                              const float* __restrict__ dmu,
                              const float* __restrict__ kmix,
                              const float* __restrict__ k0,
                              const float* __restrict__ b0, int row0, int A,
                              int F, float eps, int act, const Tiles& s) {
  const int tid = threadIdx.x, D3 = 3 * F, F2 = 2 * F;
  for (int t = tid; t < ROWS * D3; t += kThreads) {
    const int r = t / D3, row = row0 + r;
    const size_t g = (size_t)row * D3 + (t - r * D3);
    s.mup[t] = row < A ? mu[g] + dmu[g] : 0.f;
  }
  for (int t = tid; t < ROWS * F; t += kThreads) {
    const int r = t / F, row = row0 + r;
    const size_t g = (size_t)row * F + (t - r * F);
    s.qp[t] = row < A ? q[g] + dq[g] : 0.f;
  }
  __syncthreads();
  for (int c = 0; c < 3; ++c) {
    for (int f = tid; f < F; f += kThreads) {
      float av[ROWS], aw[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) av[r] = aw[r] = 0.f;
      for (int k = 0; k < F; ++k) {
        const float wv = kmix[(size_t)k * F2 + f];
        const float ww = kmix[(size_t)k * F2 + F + f];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float m = s.mup[r * D3 + c * F + k];
          av[r] = fmaf(m, wv, av[r]);
          aw[r] = fmaf(m, ww, aw[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        s.V[r * D3 + c * F + f] = av[r];
        s.W[r * D3 + c * F + f] = aw[r];
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < ROWS * F; t += kThreads) {
    const int r = t / F, f = t - r * F;
    const float v0 = s.V[r * D3 + f], v1 = s.V[r * D3 + F + f],
                v2 = s.V[r * D3 + 2 * F + f];
    s.Vn[t] = sqrtf(v0 * v0 + v1 * v1 + v2 * v2 + eps);
  }
  __syncthreads();
  for (int f = tid; f < F; f += kThreads) {
    float a[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) a[r] = b0[f];
    for (int k = 0; k < F; ++k) {
      const float w = k0[(size_t)k * F + f];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) a[r] = fmaf(s.qp[r * F + k], w, a[r]);
    }
    for (int k = 0; k < F; ++k) {
      const float w = k0[(size_t)(F + k) * F + f];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) a[r] = fmaf(s.Vn[r * F + k], w, a[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      s.pre[r * F + f] = a[r];
      s.h[r * F + f] = act_f(a[r], act);
    }
  }
  __syncthreads();
}

// (a, b, c)[r] = h[r] k1[:, {f, F+f, 2F+f}] + b1 for one feature f
template <int ROWS>
__device__ void mix_intra(const float* __restrict__ k1,
                          const float* __restrict__ b1, const float* s_h,
                          int F, int f, float* a, float* b, float* c) {
  const int F3 = 3 * F;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    a[r] = b1[f];
    b[r] = b1[F + f];
    c[r] = b1[2 * F + f];
  }
  for (int k = 0; k < F; ++k) {
    const float w0 = k1[(size_t)k * F3 + f];
    const float w1 = k1[(size_t)k * F3 + F + f];
    const float w2 = k1[(size_t)k * F3 + 2 * F + f];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float hv = s_h[r * F + k];
      a[r] = fmaf(hv, w0, a[r]);
      b[r] = fmaf(hv, w1, b[r]);
      c[r] = fmaf(hv, w2, c[r]);
    }
  }
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
mix_fwd_kernel(const float* __restrict__ q, const float* __restrict__ mu,
               const float* __restrict__ dq, const float* __restrict__ dmu,
               const float* __restrict__ kmix, const float* __restrict__ k0,
               const float* __restrict__ b0, const float* __restrict__ k1,
               const float* __restrict__ b1, float* __restrict__ qo,
               float* __restrict__ muo, int A, int F, float eps, int act) {
  extern __shared__ float smem[];
  const Tiles s = carve(smem, ROWS, F);
  const int row0 = blockIdx.x * ROWS, D3 = 3 * F;
  mix_recompute<ROWS>(q, mu, dq, dmu, kmix, k0, b0, row0, A, F, eps, act, s);
  for (int f = threadIdx.x; f < F; f += kThreads) {
    float a[ROWS], b[ROWS], c[ROWS];
    mix_intra<ROWS>(k1, b1, s.h, F, f, a, b, c);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = row0 + r;
      if (row >= A) break;
      float vw = 0.f;
      for (int cc = 0; cc < 3; ++cc)
        vw = fmaf(s.V[r * D3 + cc * F + f], s.W[r * D3 + cc * F + f], vw);
      qo[(size_t)row * F + f] = s.qp[r * F + f] + a[r] + c[r] * vw;
      for (int cc = 0; cc < 3; ++cc)
        muo[(size_t)row * D3 + cc * F + f] =
            s.mup[r * D3 + cc * F + f] + b[r] * s.W[r * D3 + cc * F + f];
    }
  }
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
mix_bwd_kernel(const float* __restrict__ q, const float* __restrict__ mu,
               const float* __restrict__ dq, const float* __restrict__ dmu,
               const float* __restrict__ gq, const float* __restrict__ gmu,
               const float* __restrict__ kmix, const float* __restrict__ k0,
               const float* __restrict__ b0, const float* __restrict__ k1,
               const float* __restrict__ b1, const float* __restrict__ kmixT,
               const float* __restrict__ k0T, const float* __restrict__ k1T,
               float* __restrict__ gqi, float* __restrict__ gmui, int A,
               int F, float eps, int act) {
  extern __shared__ float smem[];
  const Tiles s = carve(smem, ROWS, F);
  const int D3 = 3 * F, F2 = 2 * F;
  float* s_gcat = s.h + ROWS * F;     // [ROWS][3F]: g, g_dmu_i, g_dqmu_i
  float* s_gpre = s_gcat + ROWS * D3; // [ROWS][F]
  float* s_gV = s_gpre + ROWS * F;    // [ROWS][3F]
  float* s_gW = s_gV + ROWS * D3;     // [ROWS][3F]
  const int row0 = blockIdx.x * ROWS, tid = threadIdx.x;
  mix_recompute<ROWS>(q, mu, dq, dmu, kmix, k0, b0, row0, A, F, eps, act, s);

  // cotangents of the gated update, per feature f
  for (int f = tid; f < F; f += kThreads) {
    float a[ROWS], b[ROWS], c[ROWS];
    mix_intra<ROWS>(k1, b1, s.h, F, f, a, b, c);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = row0 + r;
      const bool ok = row < A;
      const float g = ok ? gq[(size_t)row * F + f] : 0.f;
      float gm[3], V[3], W[3];
      float vw = 0.f, gdmu_i = 0.f;
      for (int cc = 0; cc < 3; ++cc) {
        gm[cc] = ok ? gmu[(size_t)row * D3 + cc * F + f] : 0.f;
        V[cc] = s.V[r * D3 + cc * F + f];
        W[cc] = s.W[r * D3 + cc * F + f];
        vw = fmaf(V[cc], W[cc], vw);
        gdmu_i = fmaf(gm[cc], W[cc], gdmu_i);
      }
      const float gvw = g * c[r];
      s_gcat[r * D3 + f] = g;
      s_gcat[r * D3 + F + f] = gdmu_i;
      s_gcat[r * D3 + 2 * F + f] = g * vw;
      for (int cc = 0; cc < 3; ++cc) {
        s_gW[r * D3 + cc * F + f] = gm[cc] * b[r] + gvw * V[cc];
        s_gV[r * D3 + cc * F + f] = gvw * W[cc];
      }
    }
  }
  __syncthreads();
  // gh = gcat k1^T ; gpre = gh * act'(pre)
  for (int k = tid; k < F; k += kThreads) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int n = 0; n < D3; ++n) {
      const float w = k1T[(size_t)n * F + k];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(s_gcat[r * D3 + n], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      s_gpre[r * F + k] = acc[r] * dact_f(s.pre[r * F + k], act);
  }
  __syncthreads();
  // gq' = g + gpre k0[:F]^T ; gVn = gpre k0[F:]^T -> gV_c += gVn V_c / Vn
  for (int k = tid; k < F; k += kThreads) {
    float aq[ROWS], an[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) aq[r] = an[r] = 0.f;
    for (int f = 0; f < F; ++f) {
      const float w0 = k0T[(size_t)f * F2 + k];
      const float w1 = k0T[(size_t)f * F2 + F + k];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float gp = s_gpre[r * F + f];
        aq[r] = fmaf(gp, w0, aq[r]);
        an[r] = fmaf(gp, w1, an[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = row0 + r;
      if (row < A) gqi[(size_t)row * F + k] = s_gcat[r * D3 + k] + aq[r];
      const float scale = an[r] / s.Vn[r * F + k];
      for (int cc = 0; cc < 3; ++cc)
        s_gV[r * D3 + cc * F + k] += scale * s.V[r * D3 + cc * F + k];
    }
  }
  __syncthreads();
  // gmu'_c = gmu_c + gV_c Wv^T + gW_c Ww^T
  for (int cc = 0; cc < 3; ++cc) {
    for (int k = tid; k < F; k += kThreads) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      for (int f = 0; f < F; ++f) {
        const float wv = kmixT[(size_t)f * F + k];
        const float ww = kmixT[(size_t)(F + f) * F + k];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r] = fmaf(s_gV[r * D3 + cc * F + f], wv,
                        fmaf(s_gW[r * D3 + cc * F + f], ww, acc[r]));
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int row = row0 + r;
        if (row < A)
          gmui[(size_t)row * D3 + cc * F + k] =
              gmu[(size_t)row * D3 + cc * F + k] + acc[r];
      }
    }
  }
}

}  // namespace

extern "C" int spk_mix_fwd(const float* q, const float* mu, const float* dq,
                           const float* dmu, const float* kmix,
                           const float* k0, const float* b0, const float* k1,
                           const float* b1, float* qo, float* muo, int A,
                           int F, float eps, int act, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)kRowsFwd * 13 * F;
  cudaError_t err =
      cudaFuncSetAttribute(mix_fwd_kernel<kRowsFwd>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (A + kRowsFwd - 1) / kRowsFwd;
  mix_fwd_kernel<kRowsFwd><<<grid, kThreads, smem, stream>>>(
      q, mu, dq, dmu, kmix, k0, b0, k1, b1, qo, muo, A, F, eps, act);
  return (int)cudaGetLastError();
}

extern "C" int spk_mix_bwd(const float* q, const float* mu, const float* dq,
                           const float* dmu, const float* gq, const float* gmu,
                           const float* kmix, const float* k0,
                           const float* b0, const float* k1, const float* b1,
                           const float* kmixT, const float* k0T,
                           const float* k1T, float* gqi, float* gmui, int A,
                           int F, float eps, int act, cudaStream_t stream) {
  // 13 F (forward tiles) + 3F gcat + F gpre + 3F gV + 3F gW per row
  const size_t smem = sizeof(float) * (size_t)kRowsBwd * 23 * F;
  cudaError_t err =
      cudaFuncSetAttribute(mix_bwd_kernel<kRowsBwd>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (A + kRowsBwd - 1) / kRowsBwd;
  mix_bwd_kernel<kRowsBwd><<<grid, kThreads, smem, stream>>>(
      q, mu, dq, dmu, gq, gmu, kmix, k0, b0, k1, b1, kmixT, k0T, k1T, gqi,
      gmui, A, F, eps, act);
  return (int)cudaGetLastError();
}
