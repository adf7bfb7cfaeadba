// K4's body, the PaiNN mixing backward on one block's 16 rows: one copy
// for the tuned instance (painn_mixing.cu::mix_bwd_kernel, F % 32 == 0
// and F <= 256) and the general one (painn_mixing_gen.cu::
// mix_bwd_gen_kernel, every other F), and the activations both mixing
// sources share.  Its design is the tuned instance's (painn_mixing.cu's
// header): the products on the tensor cores in 3xTF32 (tf32_mma.cuh,
// rows_mma), 8 warps on one m16 tile of rows, each product a [16, K] row
// tile (rows padded to a stride of 4 mod 32 floats) times a weight read
// from L2 in B fragments, the epilogues in registers, the row tiles
// aliased as they die.  Everything here has internal linkage; each source
// includes it once.
//
// The body runs at a padded width FP (a multiple of 32; FP = F for the
// tuned instance) on weights zero-padded to it (ops/painn_mixing.py::
// pad_weights: kmix [FP, 2FP], k0 [2FP, FP], b0 [FP], k1 [FP, 3FP], b1
// [3FP], each block of F rows or columns padded on its own) and their
// transposed copies; the rows' lanes f >= F load zeros and store nothing.
// Each padded lane gives exact zeros: V = W = 0 there (zero columns of
// kmix), so Vn = sqrt(eps) != 0 meets the zero rows FP + f of k0; pre = 0
// and act(0) meets zero rows of k1; b = c = 0, so the gated update's
// cotangents gW, gV and gcat are 0 there; gpre = 0 (zero columns of k1^T),
// gVn = 0 (zero columns of k0^T) and gVn V / Vn = 0; gq' and gmu' are
// stored at f < F only.
#pragma once

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

// K4: 8 warps a block on one m16 tile of rows, two blocks an SM at F = 128
// (two tiles, 32 rows and one block an SM, took 0.61 ms against 0.40 at
// 12,800 rows: scripts/time_mixing_kernels.py on the H100)
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRows = 16;

__device__ __forceinline__ float act_f(float x, int act) {
  if (act == 1) return x / (1.f + expf(-x));  // silu
  // shifted softplus: softplus(x) - ln 2
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))) - 0.69314718055994531f;
}

__device__ __forceinline__ float vnorm(float v0, float v1, float v2,
                                       float eps) {
  return sqrtf(v0 * v0 + v1 * v1 + v2 * v2 + eps);
}

__device__ __forceinline__ float dact_f(float x, int act) {
  const float s = 1.f / (1.f + expf(-x));
  return act == 1 ? s * (1.f + x * (1.f - s)) : s;
}

// K4's row tiles at width FP, 13 FP floats a row: T0 [R][3FP] mu' ->
// (b | c) -> gV, T1 [R][3FP] V, T2 [R][3FP] W -> gW, T3 [R][FP] q' -> g,
// T4 [R][FP] Vn -> gdmu_i, T5 [R][2FP] (pre | h) -> (gpre | gdqmu_i); each
// row padded by 4
__host__ __device__ inline size_t bwd_tile_floats(int FP) {
  return (size_t)kBwdRows * (13 * FP + 24);
}

// The backward of rows [row0, row0 + 16) on the row tiles at `tiles`
// (shared memory, or the block's slice of global scratch): gqi, gmui, and
// with S the rows' 16F wgrad factors (mix_wgrad.cuh).  NT1 and NT2: the
// n8-tiles a warp takes at a time in the FP- and 2FP-wide products; COMP:
// the products' sums with Kahan's compensation (rows_mma); kPad: FP may
// exceed F (the general instance).  Without it FP is F, and the lane tests
// and the component splits fold away at compile time.
template <int NT1, int NT2, bool COMP, bool kPad>
__device__ __forceinline__ void mix_bwd_body(
    float* tiles, int row0, const float* __restrict__ q,
    const float* __restrict__ mu, const float* __restrict__ dq,
    const float* __restrict__ dmu, const float* __restrict__ gq,
    const float* __restrict__ gmu, const float* __restrict__ kmix,
    const float* __restrict__ k0, const float* __restrict__ b0,
    const float* __restrict__ k1, const float* __restrict__ b1,
    const float* __restrict__ kmixT, const float* __restrict__ k0T,
    const float* __restrict__ k1T, float* __restrict__ gqi,
    float* __restrict__ gmui, float* __restrict__ S, int A, int F,
    int padded, float eps, int act) {
  constexpr int R = kBwdRows, RT = R / 16, NW = kBwdWarps;
  const int FP = kPad ? padded : F;
  // lane f holds a real feature
  auto real = [&](int f) { return !kPad || f < F; };
  const int F2 = 2 * FP, D3 = 3 * FP, G3 = 3 * F, D16 = 16 * F;
  const size_t FF = (size_t)FP * FP;
  const int L1 = FP + 4, L2 = F2 + 4, L3 = D3 + 4;
  float* T0 = tiles;
  float* T1 = T0 + R * L3;
  float* T2 = T1 + R * L3;
  float* T3 = T2 + R * L3;
  float* T4 = T3 + R * L1;
  float* T5 = T4 + R * L1;
  const int tid = threadIdx.x;
  // the wgrad instance's factor row of a block row (null past A)
  auto srow = [&](int r) -> float* {
    const int row = row0 + r;
    return S != nullptr && row < A ? S + (size_t)row * D16 : nullptr;
  };

  // mu' -> T0, q' -> T3 (rows past A and lanes past F zero-filled)
  for (int t = tid; t < R * D3; t += kBwdThreads) {
    const int r = t / D3, col = t - r * D3, row = row0 + r;
    // unpadded, c * F + f is col.  The loads stand alone under their
    // condition, apart from the stores: the compiler predicates and
    // unrolls such a loop, and keeps several loads in flight
    const int c = kPad ? col / FP : 0, f = kPad ? col - c * FP : col;
    const size_t g = (size_t)row * G3 + c * F + f;
    float v = 0.f;
    if (row < A && real(f)) v = mu[g] + dmu[g];
    T0[r * L3 + col] = v;
    if (real(f))
      if (float* s = srow(r)) s[c * F + f] = v;
  }
  for (int t = tid; t < R * FP; t += kBwdThreads) {
    const int r = t / FP, f = t - r * FP, row = row0 + r;
    float v = 0.f;
    if (row < A && real(f))
      v = q[(size_t)row * F + f] + dq[(size_t)row * F + f];
    T3[r * L1 + f] = v;
    if (real(f))
      if (float* s = srow(r)) s[3 * F + f] = v;
  }
  __syncthreads();
  {  // (V_c | W_c) = mu'_c kmix, the components as three m-tiles
    const MmaSeg seg[1] = {{T0, L3, FP, kmix, F2, FP}};
    rows_mma<RT, 3, NT2, NW, COMP>(seg, F2, [&](int c, int r, int n, float v) {
      if (n < FP) T1[r * L3 + c * FP + n] = v;
      else T2[r * L3 + c * FP + n - FP] = v;
    });
  }
  __syncthreads();
  for (int t = tid; t < R * FP; t += kBwdThreads) {
    const int r = t / FP, f = t - r * FP;
    const float* V = T1 + r * L3 + f;
    const float vn = vnorm(V[0], V[FP], V[F2], eps);
    T4[r * L1 + f] = vn;
    if (real(f))
      if (float* s = srow(r)) s[4 * F + f] = vn;
  }
  __syncthreads();
  {  // pre = q' k0[:FP] + Vn k0[FP:] + b0, h = act(pre)
    const MmaSeg seg[2] = {{T3, L1, 0, k0, FP, FP},
                           {T4, L1, 0, k0 + FF, FP, FP}};
    rows_mma<RT, 1, NT1, NW, COMP>(seg, FP, [&](int, int r, int n, float v) {
      const float p = v + b0[n], h = act_f(p, act);
      T5[r * L2 + n] = p;
      T5[r * L2 + FP + n] = h;
      if (real(n))
        if (float* s = srow(r)) s[5 * F + n] = h;
    });
  }
  __syncthreads();
  {  // (b | c) = h k1[:, FP:] + b1[FP:] (the q update a has cotangent g)
    const MmaSeg seg[1] = {{T5 + FP, L2, 0, k1 + FP, D3, FP}};
    rows_mma<RT, 1, NT2, NW, COMP>(seg, F2, [&](int, int r, int n, float v) {
      T0[r * L3 + n] = v + b1[FP + n];
    });
  }
  __syncthreads();
  // the gated update's cotangents: gcat = (g, gdmu_i, g vw), gW_c =
  // gm_c b + g c V_c over W_c, gV_c = g c W_c over (b | c)
  for (int t = tid; t < R * FP; t += kBwdThreads) {
    const int r = t / FP, f = t - r * FP, row = row0 + r;
    const bool ok = row < A && real(f);
    float* gV = T0 + r * L3 + f;
    const float* V = T1 + r * L3 + f;
    float* W = T2 + r * L3 + f;
    const float b = gV[0], c = gV[FP];
    const float g = ok ? gq[(size_t)row * F + f] : 0.f;
    const float gvw = g * c;
    float* s = real(f) ? srow(r) : nullptr;
    float vw = 0.f, gdmu_i = 0.f;
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      const float gm = ok ? gmu[(size_t)row * G3 + cc * F + f] : 0.f;
      const float v = V[cc * FP], w = W[cc * FP];
      vw = fmaf(v, w, vw);
      gdmu_i = fmaf(gm, w, gdmu_i);
      const float gw = gm * b + gvw * v;
      W[cc * FP] = gw;
      gV[cc * FP] = gvw * w;
      if (s) s[9 * F + cc * F + f] = gw;
    }
    const float gqmu = g * vw;
    T3[r * L1 + f] = g;
    T4[r * L1 + f] = gdmu_i;
    T5[r * L2 + FP + f] = gqmu;
    if (s) {
      s[13 * F + f] = g;
      s[14 * F + f] = gdmu_i;
      s[15 * F + f] = gqmu;
    }
  }
  __syncthreads();
  {  // gpre = (gcat k1^T) act'(pre), over pre
    const MmaSeg seg[3] = {{T3, L1, 0, k1T, FP, FP},
                           {T4, L1, 0, k1T + FF, FP, FP},
                           {T5 + FP, L2, 0, k1T + 2 * FF, FP, FP}};
    rows_mma<RT, 1, NT1, NW, COMP>(seg, FP, [&](int, int r, int n, float v) {
      float* p = T5 + r * L2 + n;
      const float gp = v * dact_f(*p, act);
      *p = gp;
      if (real(n))
        if (float* s = srow(r)) s[12 * F + n] = gp;
    });
  }
  __syncthreads();
  {  // (gq' - g | gVn) = gpre k0^T; gq' out, gV_c += gVn V_c / Vn
    const MmaSeg seg[1] = {{T5, L2, 0, k0T, F2, FP}};
    rows_mma<RT, 1, NT2, NW, COMP>(seg, F2, [&](int, int r, int n, float v) {
      const int row = row0 + r;
      if (n < FP) {
        if (row < A && real(n)) gqi[(size_t)row * F + n] = T3[r * L1 + n] + v;
        return;
      }
      const int f = n - FP;
      const float* V = T1 + r * L3 + f;
      float* gV = T0 + r * L3 + f;
      const float scale = v / vnorm(V[0], V[FP], V[F2], eps);
      float* s = real(f) ? srow(r) : nullptr;
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        const float gv = gV[cc * FP] + scale * V[cc * FP];
        gV[cc * FP] = gv;
        if (s) s[6 * F + cc * F + f] = gv;
      }
    });
  }
  __syncthreads();
  {  // gmu'_c = gmu_c + gV_c Wv^T + gW_c Ww^T
    const MmaSeg seg[2] = {{T0, L3, FP, kmixT, FP, FP},
                           {T2, L3, FP, kmixT + FF, FP, FP}};
    rows_mma<RT, 3, NT1, NW, COMP>(seg, FP, [&](int c, int r, int n, float v) {
      const int row = row0 + r;
      if (row < A && real(n)) {
        const size_t i = (size_t)row * G3 + c * F + n;
        gmui[i] = gmu[i] + v;
      }
    });
  }
}

}  // namespace
