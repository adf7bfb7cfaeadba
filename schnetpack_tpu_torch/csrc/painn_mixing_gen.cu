// General instances of the PaiNN mixing kernels for Hopper (sm_90a), f32,
// flat [A, 3F] layout: every feature width F >= 1.
//
// The tuned instances (painn_mixing.cu) keep each block's 16-row tiles in
// shared memory: K3 10 FP floats a row (F <= 352), K4 13F (F % 32 == 0,
// F <= 256).  These take every other width and replace the same TPU
// kernels:
// K3 mix_fwd_gen_kernel: schnetpack_tpu/ops/painn_mixing.py:73
//   _mix_fwd_kernel;
// K4 mix_bwd_gen_kernel: schnetpack_tpu/ops/painn_mixing.py:83
//   _mix_bwd_kernel, the input cotangents, and with a factor table S the
//   weight cotangents (mix_wgrad.cuh, the tuned wgrad instance's
//   reduction).
// The arithmetic is the tuned kernels' (their header): the forward q' = q +
// dq, mu' = mu + dmu, (V_c | W_c) = mu'_c kmix, Vn, h = act(q' k0[:F] + Vn
// k0[F:] + b0), (a | b | c) = h k1 + b1, q_out = q' + a + c vw, mu_out_c =
// mu'_c + b W_c; the backward recomputes it and chains the cotangents, the
// transposed products on the wrapper's transposed weight copies.
//
// The design: a block takes kRows rows and runs each product as plain
// FMA loops over f32 factors with f64 sums, a thread an output column
// (k-loop in order, the weight row read once for the block's rows from
// L2; f32 sums missed the float64 twin by more than 1e-5 where q_out
// cancels, from F = 130 on the H100, as the tuned K3's uncompensated sums
// did at F = 256); the rows' intermediates live in
// a workspace in global memory (the wrapper's [A, 13F] forward, [A, 26F]
// backward, read back from L1/L2), so no width meets a shared memory limit.
//
// What bounds them on the H100: the products, 22 F^2 FLOP a row forward
// and 42 F^2 backward, at the FP32 rate (these instances run them at the
// FP64 rate, half of it); these instances also read each
// weight once a block of kRows rows from L2.

#include <cuda_runtime.h>

#include "mix_wgrad.cuh"

namespace {

constexpr int kRows = 4;        // rows a block
constexpr int kThreads = 128;   // threads a block
constexpr float kLn2 = 0.69314718055994531f;

__device__ __forceinline__ float act_g(float x, int act) {
  if (act == 1) return x / (1.f + expf(-x));  // silu
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))) - kLn2;  // ssp
}

__device__ __forceinline__ float dact_g(float x, int act) {
  const float s = 1.f / (1.f + expf(-x));
  return act == 1 ? s * (1.f + x * (1.f - s)) : s;
}

// The forward's first three products for the block's rows [row0, row0 +
// nr) into the workspace rows w + r * ld: mu' [3F] at 9F, q' [F] at 12F, V
// [3F] at 0, W [3F] at 3F, Vn [F] at 6F, vw [F] at 7F, pre [F] at 13F
// (ld >= 14F) when keep_pre, h [F] at 8F
__device__ void mix_front(const float* __restrict__ q,
                          const float* __restrict__ mu,
                          const float* __restrict__ dq,
                          const float* __restrict__ dmu,
                          const float* __restrict__ kmix,
                          const float* __restrict__ k0,
                          const float* __restrict__ b0, float* w, int ld,
                          int row0, int nr, int F, float eps, int act,
                          bool keep_pre) {
  const int tid = threadIdx.x, D3 = 3 * F, F2 = 2 * F;
  for (int i = tid; i < nr * D3; i += kThreads) {
    const int r = i / D3, c = i - r * D3;
    const size_t g = (size_t)(row0 + r) * D3 + c;
    w[r * ld + 9 * F + c] = mu[g] + dmu[g];
  }
  for (int i = tid; i < nr * F; i += kThreads) {
    const int r = i / F, f = i - r * F;
    const size_t g = (size_t)(row0 + r) * F + f;
    w[r * ld + 12 * F + f] = q[g] + dq[g];
  }
  __syncthreads();
  for (int j = tid; j < F2; j += kThreads) {  // (V_c | W_c) = mu'_c kmix
    double acc[kRows][3] = {};
    for (int k = 0; k < F; ++k) {
      const double wv = __ldg(kmix + (size_t)k * F2 + j);
      for (int r = 0; r < nr; ++r)
        for (int c = 0; c < 3; ++c)
          acc[r][c] = fma((double)w[r * ld + 9 * F + c * F + k], wv, acc[r][c]);
    }
    for (int r = 0; r < nr; ++r)
      for (int c = 0; c < 3; ++c)
        w[r * ld + (j < F ? c * F + j : 3 * F + c * F + j - F)] =
            (float)acc[r][c];
  }
  __syncthreads();
  for (int i = tid; i < nr * F; i += kThreads) {  // Vn, vw
    const int r = i / F, f = i - r * F;
    const float* V = w + r * ld + f;
    const float* W = V + 3 * F;
    const float v0 = V[0], v1 = V[F], v2 = V[2 * F];
    w[r * ld + 6 * F + f] = sqrtf(v0 * v0 + v1 * v1 + v2 * v2 + eps);
    w[r * ld + 7 * F + f] = fmaf(v2, W[2 * F], fmaf(v1, W[F], v0 * W[0]));
  }
  __syncthreads();
  for (int j = tid; j < F; j += kThreads) {  // h = act(q' k0 + Vn k0 + b0)
    double acc[kRows] = {};
    for (int k = 0; k < F; ++k) {
      const double a = __ldg(k0 + (size_t)k * F + j);
      const double b = __ldg(k0 + (size_t)(F + k) * F + j);
      for (int r = 0; r < nr; ++r)
        acc[r] = fma((double)w[r * ld + 6 * F + k], b,
                     fma((double)w[r * ld + 12 * F + k], a, acc[r]));
    }
    for (int r = 0; r < nr; ++r) {
      const float p = (float)(acc[r] + __ldg(b0 + j));
      if (keep_pre) w[r * ld + 13 * F + j] = p;
      w[r * ld + 8 * F + j] = act_g(p, act);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    mix_fwd_gen_kernel(const float* __restrict__ q,
                       const float* __restrict__ mu,
                       const float* __restrict__ dq,
                       const float* __restrict__ dmu,
                       const float* __restrict__ kmix,
                       const float* __restrict__ k0,
                       const float* __restrict__ b0,
                       const float* __restrict__ k1,
                       const float* __restrict__ b1, float* __restrict__ qo,
                       float* __restrict__ muo, float* __restrict__ ws, int A,
                       int F, float eps, int act) {
  const int row0 = blockIdx.x * kRows, nr = min(kRows, A - row0);
  const int ld = 13 * F, D3 = 3 * F;
  float* w = ws + (size_t)row0 * ld;
  mix_front(q, mu, dq, dmu, kmix, k0, b0, w, ld, row0, nr, F, eps, act,
            false);
  // (a | b | c) = h k1 + b1, then the outputs of feature f
  for (int f = threadIdx.x; f < F; f += kThreads) {
    double a[kRows], b[kRows], c[kRows];
    for (int r = 0; r < nr; ++r) a[r] = b[r] = c[r] = 0.0;
    for (int k = 0; k < F; ++k) {
      const float* kr = k1 + (size_t)k * D3 + f;
      const double ka = __ldg(kr), kb = __ldg(kr + F), kc = __ldg(kr + 2 * F);
      for (int r = 0; r < nr; ++r) {
        const double h = w[r * ld + 8 * F + k];
        a[r] = fma(h, ka, a[r]);
        b[r] = fma(h, kb, b[r]);
        c[r] = fma(h, kc, c[r]);
      }
    }
    for (int r = 0; r < nr; ++r) {
      const float* wr = w + r * ld;
      const size_t row = (size_t)(row0 + r);
      const double av = a[r] + __ldg(b1 + f), bv = b[r] + __ldg(b1 + F + f);
      const double cv = c[r] + __ldg(b1 + 2 * F + f);
      qo[row * F + f] =
          (float)(wr[12 * F + f] + av + cv * wr[7 * F + f]);
      for (int cc = 0; cc < 3; ++cc)
        muo[row * D3 + cc * F + f] =
            (float)(wr[9 * F + cc * F + f] + bv * wr[3 * F + cc * F + f]);
    }
  }
}

// the backward's workspace row: the forward's front (0..14F), then b [F]
// at 14F, c [F] at 15F, gcat [3F] at 16F (g, gdmu_i, g vw), gW [3F] at
// 19F, gV [3F] at 22F, gpre [F] at 25F: 26F floats
__global__ void __launch_bounds__(kThreads)
    mix_bwd_gen_kernel(const float* __restrict__ q,
                       const float* __restrict__ mu,
                       const float* __restrict__ dq,
                       const float* __restrict__ dmu,
                       const float* __restrict__ gq,
                       const float* __restrict__ gmu,
                       const float* __restrict__ kmix,
                       const float* __restrict__ k0,
                       const float* __restrict__ b0,
                       const float* __restrict__ k1,
                       const float* __restrict__ b1,
                       const float* __restrict__ kmixT,
                       const float* __restrict__ k0T,
                       const float* __restrict__ k1T,
                       float* __restrict__ gqi, float* __restrict__ gmui,
                       float* __restrict__ S, float* __restrict__ ws, int A,
                       int F, float eps, int act) {
  const int row0 = blockIdx.x * kRows, nr = min(kRows, A - row0);
  const int ld = 26 * F, D3 = 3 * F, F2 = 2 * F, tid = threadIdx.x;
  float* w = ws + (size_t)row0 * ld;
  mix_front(q, mu, dq, dmu, kmix, k0, b0, w, ld, row0, nr, F, eps, act,
            true);
  for (int j = tid; j < F2; j += kThreads) {  // (b | c) = h k1[:, F:] + b1
    double acc[kRows] = {};
    for (int k = 0; k < F; ++k) {
      const double kv = __ldg(k1 + (size_t)k * D3 + F + j);
      for (int r = 0; r < nr; ++r)
        acc[r] = fma((double)w[r * ld + 8 * F + k], kv, acc[r]);
    }
    for (int r = 0; r < nr; ++r)
      w[r * ld + 14 * F + j] = (float)(acc[r] + __ldg(b1 + F + j));
  }
  __syncthreads();
  // the gated update's cotangents: gcat = (g, gdmu_i, g vw), gW_c = gm_c b
  // + g c V_c, gV_c = g c W_c
  for (int i = tid; i < nr * F; i += kThreads) {
    const int r = i / F, f = i - r * F;
    float* wr = w + r * ld;
    const size_t row = (size_t)(row0 + r);
    const float b = wr[14 * F + f], c = wr[15 * F + f];
    const float g = gq[row * F + f], gvw = g * c;
    float vw = 0.f, gdmu_i = 0.f;
    for (int cc = 0; cc < 3; ++cc) {
      const float gm = gmu[row * D3 + cc * F + f];
      const float v = wr[cc * F + f], wv = wr[3 * F + cc * F + f];
      vw = fmaf(v, wv, vw);
      gdmu_i = fmaf(gm, wv, gdmu_i);
      wr[19 * F + cc * F + f] = gm * b + gvw * v;
      wr[22 * F + cc * F + f] = gvw * wv;
    }
    wr[16 * F + f] = g;
    wr[17 * F + f] = gdmu_i;
    wr[18 * F + f] = g * vw;
  }
  __syncthreads();
  for (int n = tid; n < F; n += kThreads) {  // gpre = (gcat k1^T) act'(pre)
    double acc[kRows] = {};
    for (int k = 0; k < D3; ++k) {
      const double kv = __ldg(k1T + (size_t)k * F + n);
      for (int r = 0; r < nr; ++r)
        acc[r] = fma((double)w[r * ld + 16 * F + k], kv, acc[r]);
    }
    for (int r = 0; r < nr; ++r)
      w[r * ld + 25 * F + n] =
          (float)acc[r] * dact_g(w[r * ld + 13 * F + n], act);
  }
  __syncthreads();
  // (gq' - g | gVn) = gpre k0^T; gq' out, gV_c += gVn V_c / Vn
  for (int m = tid; m < F2; m += kThreads) {
    double acc[kRows] = {};
    for (int n = 0; n < F; ++n) {
      const double kv = __ldg(k0T + (size_t)n * F2 + m);
      for (int r = 0; r < nr; ++r)
        acc[r] = fma((double)w[r * ld + 25 * F + n], kv, acc[r]);
    }
    for (int r = 0; r < nr; ++r) {
      float* wr = w + r * ld;
      if (m < F) {
        gqi[(size_t)(row0 + r) * F + m] = (float)(wr[16 * F + m] + acc[r]);
      } else {
        const int f = m - F;
        const float scale = (float)(acc[r] / wr[6 * F + f]);
        for (int cc = 0; cc < 3; ++cc)
          wr[22 * F + cc * F + f] += scale * wr[cc * F + f];
      }
    }
  }
  __syncthreads();
  // gmu'_c = gmu_c + gV_c Wv^T + gW_c Ww^T
  for (int k = tid; k < F; k += kThreads) {
    double acc[kRows][3] = {};
    for (int j = 0; j < F; ++j) {
      const double kv = __ldg(kmixT + (size_t)j * F + k);
      const double kw = __ldg(kmixT + (size_t)(F + j) * F + k);
      for (int r = 0; r < nr; ++r)
        for (int c = 0; c < 3; ++c)
          acc[r][c] = fma((double)w[r * ld + 19 * F + c * F + j], kw,
                          fma((double)w[r * ld + 22 * F + c * F + j], kv,
                              acc[r][c]));
    }
    for (int r = 0; r < nr; ++r)
      for (int c = 0; c < 3; ++c) {
        const size_t i = (size_t)(row0 + r) * D3 + c * F + k;
        gmui[i] = (float)(gmu[i] + acc[r][c]);
      }
  }
  if (S == nullptr) return;
  // the wgrad factors (mix_wgrad.cuh's S): [mu' | q' | Vn | h | gV | gW |
  // gpre | gcat]
  const int D16 = 16 * F;
  for (int i = tid; i < nr * D16; i += kThreads) {
    const int r = i / D16, c = i - r * D16;
    const float* wr = w + r * ld;
    float v;
    if (c < 3 * F) v = wr[9 * F + c];                    // mu'
    else if (c < 4 * F) v = wr[12 * F + c - 3 * F];      // q'
    else if (c < 5 * F) v = wr[6 * F + c - 4 * F];       // Vn
    else if (c < 6 * F) v = wr[8 * F + c - 5 * F];       // h
    else if (c < 9 * F) v = wr[22 * F + c - 6 * F];      // gV
    else if (c < 12 * F) v = wr[19 * F + c - 9 * F];     // gW
    else if (c < 13 * F) v = wr[25 * F + c - 12 * F];    // gpre
    else v = wr[16 * F + c - 13 * F];                    // gcat
    S[(size_t)(row0 + r) * D16 + c] = v;
  }
}

}  // namespace

// workspace floats a row of the general forward (bwd 0) or backward
extern "C" int spk_mix_gen_ws(int F, int bwd) { return (bwd ? 26 : 13) * F; }

extern "C" int spk_mix_fwd_gen(const float* q, const float* mu,
                               const float* dq, const float* dmu,
                               const float* kmix, const float* k0,
                               const float* b0, const float* k1,
                               const float* b1, float* qo, float* muo,
                               float* ws, int A, int F, float eps, int act,
                               cudaStream_t stream) {
  if (A < 1 || F < 1) return (int)cudaErrorInvalidValue;
  mix_fwd_gen_kernel<<<(A + kRows - 1) / kRows, kThreads, 0, stream>>>(
      q, mu, dq, dmu, kmix, k0, b0, k1, b1, qo, muo, ws, A, F, eps, act);
  return (int)cudaGetLastError();
}

// S [A, 16F] and wpart [nsplit][7F^2 + 4F] f64 for the weight cotangents,
// or S null without them
extern "C" int spk_mix_bwd_gen(const float* q, const float* mu,
                               const float* dq, const float* dmu,
                               const float* gq, const float* gmu,
                               const float* kmix, const float* k0,
                               const float* b0, const float* k1,
                               const float* b1, const float* kmixT,
                               const float* k0T, const float* k1T,
                               float* gqi, float* gmui, float* S,
                               double* wpart, float* ws, int nsplit, int A,
                               int F, float eps, int act,
                               cudaStream_t stream) {
  if (A < 1 || F < 1) return (int)cudaErrorInvalidValue;
  mix_bwd_gen_kernel<<<(A + kRows - 1) / kRows, kThreads, 0, stream>>>(
      q, mu, dq, dmu, gq, gmu, kmix, k0, b0, k1, b1, kmixT, k0T, k1T, gqi,
      gmui, S, ws, A, F, eps, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == nullptr) return (int)err;
  return launch_mix_wgrad(S, wpart, A, F, nsplit, stream);
}
