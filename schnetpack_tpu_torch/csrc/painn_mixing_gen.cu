// General instances of the PaiNN mixing kernels for Hopper (sm_90a), f32,
// flat [A, 3F] layout: every feature width F >= 1.
//
// The tuned instances (painn_mixing.cu) keep each block's 16-row tiles in
// shared memory: K3 10 FP floats a row (F <= 352), K4 13F (F % 32 == 0,
// F <= 256).  These take every other width and replace the same TPU
// kernels:
// K3 mix_fwd_gen_kernel: schnetpack_tpu/ops/painn_mixing.py:73
//   _mix_fwd_kernel;
// K4 mix_bwd_gen_kernel<NT1, NT2, kScr>:
//   schnetpack_tpu/ops/painn_mixing.py:83 _mix_bwd_kernel, the input
//   cotangents, and with a factor table S the weight cotangents
//   (mix_wgrad.cuh, the tuned wgrad instance's reduction).
// The arithmetic is the tuned kernels' (their header): the forward q' = q +
// dq, mu' = mu + dmu, (V_c | W_c) = mu'_c kmix, Vn, h = act(q' k0[:F] + Vn
// k0[F:] + b0), (a | b | c) = h k1 + b1, q_out = q' + a + c vw, mu_out_c =
// mu'_c + b W_c; the backward recomputes it and chains the cotangents.
//
// K3's design: a block takes kRows rows and runs each product as plain
// FMA loops over f32 factors with f64 sums, a thread an output column
// (k-loop in order, the weight row read once for the block's rows from
// L2; f32 sums missed the float64 twin by more than 1e-5 where q_out
// cancels, from F = 130 on the H100, as the tuned K3's uncompensated sums
// did at F = 256); the rows' intermediates live in a workspace in global
// memory (the wrapper's [A, 13F], read back from L1/L2), so no width meets
// a shared memory limit.  What bounds it: the products, 22 F^2 FLOP a row,
// at the FP32 rate (it runs them at the FP64 rate, half of it); it also
// reads each weight once a block of kRows rows from L2.
//
// K4's design: the tuned body (painn_mixing_bwd_body.cuh: 3xTF32 on
// rows_mma, 8 warps on one m16 tile of rows, the epilogues in registers)
// at the padded width FP = F rounded up to 32, on the weights zero-padded
// to it (ops/painn_mixing.py::pad_weights) and their transposed copies,
// both made once per parameter version by the wrapper; every padded lane
// gives exact zeros (the body's header).  What bounds it: the products, 42
// F^2 FLOP a row (FP^2 at the tensor cores' TF32 rate, three times over).
// The products' sums are compensated (Kahan's, rows_mma's COMP): with
// plain f32 sums gmu' missed the float64 twin by 1.17x the mixing
// tolerance at F = 130 on 12,800 rows on the H100 (the CPU walk's 3xTF32
// model: 1.21x, compensated 0.78x), so a warp takes 2 n8-tiles at a time
// (4 in the 2FP-wide products spill with compensated sums), 1 in the
// FP-wide ones at FP <= 64, so that every warp of the block has one.
//   * FP <= 256: the body's 13 FP floats a row, 16 rows (213 KB at 256),
//     in shared memory; the weights' B fragments read from L2.
//   * FP > 256 (kScr): the same body with the row tiles in the block's
//     slice of a scratch in global memory (gen_launch.cuh::in_waves), read
//     through L1.
//   The wgrad instance writes S [A, 16F] at the unpadded F (lanes past F
//   not at all), which mix_wgrad.cuh reduces in f64 partials, as the
//   tuned one.  No atomics: every run repeats bit for bit.

#include <cuda_runtime.h>

#include "gen_launch.cuh"
#include "mix_wgrad.cuh"
#include "painn_mixing_bwd_body.cuh"

namespace {

// K4's padded width: F rounded up to 32
__host__ __device__ inline int bwd_width(int F) { return (F + 31) / 32 * 32; }

constexpr int kRows = 4;        // K3: rows a block
constexpr int kThreads = 128;   // K3: threads a block

// K3's first three products for the block's rows [row0, row0 + nr) into
// the workspace rows w + r * ld: mu' [3F] at 9F, q' [F] at 12F, V [3F] at
// 0, W [3F] at 3F, Vn [F] at 6F, vw [F] at 7F, h [F] at 8F
__device__ void mix_front(const float* __restrict__ q,
                          const float* __restrict__ mu,
                          const float* __restrict__ dq,
                          const float* __restrict__ dmu,
                          const float* __restrict__ kmix,
                          const float* __restrict__ k0,
                          const float* __restrict__ b0, float* w, int ld,
                          int row0, int nr, int F, float eps, int act) {
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
      w[r * ld + 8 * F + j] = act_f((float)(acc[r] + __ldg(b0 + j)), act);
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
  mix_front(q, mu, dq, dmu, kmix, k0, b0, w, ld, row0, nr, F, eps, act);
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

// K4's general instance: the body on the padded weights at FP, its sums
// compensated, its row tiles in shared memory or (kScr) in block b's
// slice of scr; block b takes rows 16 (v0 + b) (v0: the wave's first; 0
// without kScr)
template <int NT1, int NT2, bool kScr>
__global__ void __launch_bounds__(kBwdThreads, 2)
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
                       float* __restrict__ S, int A, int F, float eps,
                       int act, float* __restrict__ scr, int v0) {
  extern __shared__ float smem[];
  const int FP = bwd_width(F);
  float* tiles = kScr ? scr + (size_t)blockIdx.x * bwd_tile_floats(FP) : smem;
  mix_bwd_body<NT1, NT2, true, true>(tiles, (v0 + blockIdx.x) * kBwdRows, q,
                                     mu, dq, dmu, gq, gmu, kmix, k0, b0, k1,
                                     b1, kmixT, k0T, k1T, gqi, gmui, S, A, F,
                                     FP, eps, act);
}

}  // namespace

// workspace floats a row of the general forward
extern "C" int spk_mix_gen_ws(int F) { return 13 * F; }

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

// the weights padded to FP = F rounded up to 32 (kmix [FP, 2FP], k0 [2FP,
// FP], b0 [FP], k1 [FP, 3FP], b1 [3FP]) and their transposes; S [A, 16F]
// and wpart [nsplit][7F^2 + 4F] f64 for the weight cotangents, or S null
// without them
extern "C" int spk_mix_bwd_gen(const float* q, const float* mu,
                               const float* dq, const float* dmu,
                               const float* gq, const float* gmu,
                               const float* kmix, const float* k0,
                               const float* b0, const float* k1,
                               const float* b1, const float* kmixT,
                               const float* k0T, const float* k1T,
                               float* gqi, float* gmui, float* S,
                               double* wpart, int nsplit, int A, int F,
                               float eps, int act, cudaStream_t stream) {
  if (A < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const int FP = bwd_width(F);
  const size_t tile = sizeof(float) * bwd_tile_floats(FP);
  const bool scr = tile > (size_t)optin_smem();
  auto* kern = scr        ? mix_bwd_gen_kernel<2, 2, true>
               : FP <= 64 ? mix_bwd_gen_kernel<1, 2, false>
                          : mix_bwd_gen_kernel<2, 2, false>;
  cudaError_t err = allow_smem((const void*)kern);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (A + kBwdRows - 1) / kBwdRows;
  auto run = [&](float* s, int v0, int n) {
    kern<<<n, kBwdThreads, scr ? 0 : tile, stream>>>(
        q, mu, dq, dmu, gq, gmu, kmix, k0, b0, k1, b1, kmixT, k0T, k1T, gqi,
        gmui, S, A, F, eps, act, s, v0);
  };
  if (scr) {
    err = in_waves(blocks, tile, stream, run);
  } else {
    run(nullptr, 0, blocks);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || S == nullptr) return (int)err;
  return launch_mix_wgrad(S, wpart, A, F, nsplit, stream);
}
