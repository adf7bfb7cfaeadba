// PaiNN mixing kernels for Hopper (sm_90a), f32, flat [A, 3F] layout.
//
// K3 mix_fwd_kernel replaces the TPU kernel
//   schnetpack_tpu/ops/painn_mixing.py:73 _mix_fwd_kernel
// K4 mix_bwd_kernel replaces
//   schnetpack_tpu/ops/painn_mixing.py:83 _mix_bwd_kernel: the input
//   cotangents, and in its wgrad instance (a factor table S given) also the
//   weight cotangents gkmix [F, 2F], gk0 [2F, F], gb0, gk1 [F, 3F], gb1
//   (``painn_mixing.py:133-150``).
//
// Forward per row: q' = q + dq, mu' = mu + dmu (the interaction residual,
// fused into the prologue); V_c = mu'_c Wv, W_c = mu'_c Ww;
// Vn = sqrt(sum_c V_c^2 + eps); h = act(q' k0[:F] + Vn k0[F:] + b0);
// (a, b, c) = h k1 + b1; q_out = q' + a + c * sum_c V_c W_c;
// mu_out_c = mu'_c + b * W_c.  The backward recomputes the forward and
// chains the cotangents; q and dq (mu and dmu) share one cotangent.
//
// What bounds them on the H100: arithmetic.  Per row K3 does the eleven
// F x F-class products of the forward (11 F^2 FMAs) and K4 the forward's
// ten it needs again (a's columns of k1 have the cotangent g itself) and
// eleven transposed ones (21 F^2 FMAs), against 8F floats in and out (K4:
// 16F with the cotangents): ~85 FLOP a byte at F = 128, above the FP32
// ridge (20), and ~255 in 3xTF32's three tensor-core products, above the
// TF32 ridge (148).
//
// K3 runs its three products on the tensor cores in 3xTF32 (tf32_mma.cuh,
// rows_mma): 16 rows a block (one m16 tile) of 8 warps; (V | W) = mu'
// kmix with the three components as m-tiles, pre = [q' | Vn] k0 with the
// bias and activation in its epilogue, (a | b | c) = h k1 whose epilogue
// stages q' + a, b and c vw in dead tiles, so that one coalesced pass
// writes both outputs.  Each fragment goes into its f32 sum with Kahan's
// compensation (rows_mma's COMP), without which q_out, where it cancels
// to near 0, missed the float64 twin at F = 256.  The row tiles alias as
// they die (10 FP floats a row, FP = F rounded up to 32, zero-padded: 83
// KB at 16 rows and F = 128, two blocks an SM); at F % 32 != 0, which no
// PaiNN path takes, the wrapper passes a zero-padded copy of the weights.
// What holds it back (0.29 ms at 12,800 rows and F = 128, 4.2x its FP32
// bound): the compensated sums (0.24 ms without), and as K4, the B
// fragments loaded from L2 and split for one m16 tile and the A fragments
// split again by every warp.
//
// K4 (its body in painn_mixing_bwd_body.cuh, which the general instance
// shares) runs its products on the tensor cores in 3xTF32 (tf32_mma.cuh,
// rows_mma): a block takes 16 rows (one m16 tile) with 8 warps, whose
// n-tiles split each product's columns; each product is a
// [rows, K] tile in shared memory (rows padded to a stride of 4 mod 32
// floats, so the A fragments' loads meet no bank conflict) times a weight
// read from L2 in B fragments, each loaded and split once for all of the
// block's m16 tiles (the three components of V, W, gV and gW are three
// m-tiles of one product).  The epilogues work on the accumulator
// fragments in registers, at the (row, feature) each thread holds: the
// bias and activation, the gated update's cotangents' inputs, gpre =
// gh act'(pre), the gVn V / Vn correction, and the output rows.  The row
// tiles alias as they die (13F floats a row: 106 KB at 16 rows and F =
// 128, two blocks an SM); the transposed products read the wrapper's
// transposed weight copies so that every B fragment load has one form.
// What holds it back now (0.44 ms at 12,800 rows and F = 128, 3.2x its
// FP32 bound; the tensor cores at ~12% of the TF32 rate): the work around
// each mma.sync, with one m16 tile a block each B fragment is loaded from
// L2 and split (two cvt and a subtract a value) for one A tile, the A
// fragments are split again by every warp, and each k-step's fragment is
// added to the f32 sum; two column passes instead of one (NT = 2) cost
// 0.04 ms, and the f32 sums 0.04 ms.
//
// The weight cotangents are sums over all rows of outer products of a
// row's forward factors (mu'_c, q', Vn, h) with its cotangent factors (gV_c,
// gW_c, gpre, [g, gdmu_i, gdqmu_i]): 115k sums at F = 128, 0.46 MB in f32,
// more than a block's shared memory, where the TPU keeps them resident in
// VMEM over its sequential grid.  So the wgrad instance runs in two
// kernels behind one entry point: mix_bwd_kernel also writes each row's 16F
// factors to a table S [A, 16F], each as soon as it is final, and
// mix_wgrad_kernel forms the products from S as a split-K reduction: one
// block per (64 x 64 output tile, row range), 4 x 4 outputs per thread
// summed in f32 over 32 rows at a time and in f64 over the range; each row
// range writes one f64 partial set that the wrapper sums (deterministic, no
// atomics).  A bias is the product with a column of ones (an extra output
// row of the tile).  Both instances run the same arithmetic: S only adds
// stores.

#include <cuda_runtime.h>

#include "mix_wgrad.cuh"
#include "painn_mixing_bwd_body.cuh"
#include "tf32_mma.cuh"

namespace {

// K3: 8 warps a block on one m16 tile of rows, two blocks an SM at F =
// 128; the n8-tiles a warp takes at a time in the F-, 2F- and 3F-wide
// products (scripts/time_mixing_kernels.py on the H100, PERF.md: 32 rows
// lost, and 4 tiles in the 2F-wide product spill with compensated sums)
constexpr int kFwdWarps = 8;
constexpr int kFwdRows = 16;
constexpr int kFwdNT1 = 2, kFwdNT2 = 2, kFwdNT3 = 6;
constexpr int kFwdBlocks = 2;
// K3 pads F to FP, a multiple of kFwdPad, so that each product's N (FP,
// 2FP, 3FP) is a whole number of its NT n8-tiles (rows_mma's column step)
constexpr int kFwdPad = 32;
static_assert(kFwdPad % (8 * kFwdNT1) == 0 &&
                  2 * kFwdPad % (8 * kFwdNT2) == 0 &&
                  3 * kFwdPad % (8 * kFwdNT3) == 0,
              "K3's pad");
// the opt-in dynamic shared memory limit, bytes a block (ops/_build.py)
constexpr size_t kMaxSmem = SPK_MAX_DYN_SMEM;

// K3's row tiles, 10 FP floats a row (FP: F rounded up to kFwdPad; the
// columns past F are zeros): T0 [R][3FP] mu', T1 [R][3FP] V -> (Vn | vw |
// h) -> (b | c vw | h), T2 [R][3FP] W, T3 [R][FP] q' -> q' + a; each row
// padded by 4
__host__ __device__ inline int fwd_width(int F) {
  return (F + kFwdPad - 1) / kFwdPad * kFwdPad;
}

__host__ __device__ inline size_t fwd_smem_bytes(int rows, int F) {
  return sizeof(float) * (size_t)rows * (10 * fwd_width(F) + 16);
}

// The weights arrive padded to FP (kmix [FP, 2FP], k0 [2FP, FP], b0 [FP],
// k1 [FP, 3FP], b1 [3FP], every block of F rows or columns zero-padded on
// its own): the originals when F = FP, else the wrapper's copy.
template <int ROWS, int NW>
__global__ void __launch_bounds__(32 * NW, kFwdBlocks)
mix_fwd_kernel(const float* __restrict__ q, const float* __restrict__ mu,
               const float* __restrict__ dq, const float* __restrict__ dmu,
               const float* __restrict__ kmix, const float* __restrict__ k0,
               const float* __restrict__ b0, const float* __restrict__ k1,
               const float* __restrict__ b1, float* __restrict__ qo,
               float* __restrict__ muo, int A, int F, float eps, int act) {
  constexpr int RT = ROWS / 16, NTH = 32 * NW;
  extern __shared__ float smem[];
  const int FP = fwd_width(F), E2 = 2 * FP, E3 = 3 * FP, D3 = 3 * F;
  const int L1 = FP + 4, L3 = E3 + 4;
  float* T0 = smem;
  float* T1 = T0 + ROWS * L3;
  float* T2 = T1 + ROWS * L3;
  float* T3 = T2 + ROWS * L3;
  const int row0 = blockIdx.x * ROWS, tid = threadIdx.x;

  // mu' -> T0, q' -> T3 (padding columns and rows past A zero-filled)
  for (int t = tid; t < ROWS * E3; t += NTH) {
    const int r = t / E3, col = t - r * E3, row = row0 + r;
    const int c = col / FP, f = col - c * FP;
    float v = 0.f;
    if (row < A && f < F) {
      const size_t g = (size_t)row * D3 + c * F + f;
      v = mu[g] + dmu[g];
    }
    T0[r * L3 + col] = v;
  }
  for (int t = tid; t < ROWS * FP; t += NTH) {
    const int r = t / FP, f = t - r * FP, row = row0 + r;
    float v = 0.f;
    if (row < A && f < F) v = q[(size_t)row * F + f] + dq[(size_t)row * F + f];
    T3[r * L1 + f] = v;
  }
  __syncthreads();
  {  // (V_c | W_c) = mu'_c kmix, the components as three m-tiles
    const MmaSeg seg[1] = {{T0, L3, FP, kmix, E2, FP}};
    rows_mma<RT, 3, kFwdNT2, NW, true>(
        seg, E2, [&](int c, int r, int n, float v) {
          if (n < FP) T1[r * L3 + c * FP + n] = v;
          else T2[r * L3 + c * FP + n - FP] = v;
        });
  }
  __syncthreads();
  // Vn over V_0, vw = sum_c V_c W_c over V_1 (V dies); a padding column
  // has Vn = sqrt(eps), which meets a zero row of k0
  for (int t = tid; t < ROWS * FP; t += NTH) {
    const int r = t / FP, f = t - r * FP;
    float* V = T1 + r * L3 + f;
    const float* W = T2 + r * L3 + f;
    const float v0 = V[0], v1 = V[FP], v2 = V[E2];
    V[0] = vnorm(v0, v1, v2, eps);
    V[FP] = fmaf(v2, W[E2], fmaf(v1, W[FP], v0 * W[0]));
  }
  __syncthreads();
  {  // h = act(q' k0[:F] + Vn k0[F:] + b0) over V_2
    const MmaSeg seg[2] = {{T3, L1, 0, k0, FP, FP},
                           {T1, L3, 0, k0 + (size_t)FP * FP, FP, FP}};
    rows_mma<RT, 1, kFwdNT1, NW, true>(
        seg, FP, [&](int, int r, int n, float v) {
          T1[r * L3 + E2 + n] = act_f(v + b0[n], act);
        });
  }
  __syncthreads();
  {  // (a | b | c) = h k1 + b1: q' + a over q', b over Vn, c vw over vw
    const MmaSeg seg[1] = {{T1 + E2, L3, 0, k1, E3, FP}};
    rows_mma<RT, 1, kFwdNT3, NW, true>(
        seg, E3, [&](int, int r, int n, float v) {
          v += b1[n];
          if (n < FP) T3[r * L1 + n] += v;
          else if (n < E2) T1[r * L3 + n - FP] = v;
          else T1[r * L3 + n - FP] *= v;
        });
  }
  __syncthreads();
  // q_out = q' + a + c vw, mu_out_c = mu'_c + b W_c
  for (int t = tid; t < ROWS * F; t += NTH) {
    const int r = t / F, f = t - r * F, row = row0 + r;
    if (row < A)
      qo[(size_t)row * F + f] = T3[r * L1 + f] + T1[r * L3 + FP + f];
  }
  for (int t = tid; t < ROWS * D3; t += NTH) {
    const int r = t / D3, col = t - r * D3, row = row0 + r;
    const int c = col / F, f = col - c * F, i = r * L3 + c * FP + f;
    if (row < A) muo[(size_t)row * D3 + col] = T0[i] + T1[r * L3 + f] * T2[i];
  }
}

// K4 at F % 32 == 0, F <= 256: the body (painn_mixing_bwd_body.cuh) on
// the unpadded weights, its row tiles in shared memory
__global__ void __launch_bounds__(kBwdThreads, 2)
mix_bwd_kernel(const float* __restrict__ q, const float* __restrict__ mu,
               const float* __restrict__ dq, const float* __restrict__ dmu,
               const float* __restrict__ gq, const float* __restrict__ gmu,
               const float* __restrict__ kmix, const float* __restrict__ k0,
               const float* __restrict__ b0, const float* __restrict__ k1,
               const float* __restrict__ b1, const float* __restrict__ kmixT,
               const float* __restrict__ k0T, const float* __restrict__ k1T,
               float* __restrict__ gqi, float* __restrict__ gmui,
               float* __restrict__ S, int A, int F, float eps, int act) {
  extern __shared__ float smem[];
  mix_bwd_body<2, 4, false, false>(smem, blockIdx.x * kBwdRows, q, mu, dq,
                                   dmu, gq, gmu, kmix, k0, b0, k1, b1, kmixT,
                                   k0T, k1T, gqi, gmui, S, A, F, F, eps, act);
}

}  // namespace

// dynamic shared memory of K3 (bwd 0) or K4 at width F, bytes a block
extern "C" int spk_mix_smem_bytes(int F, int bwd) {
  return (int)(bwd ? sizeof(float) * bwd_tile_floats(F)
                   : fwd_smem_bytes(kFwdRows, F));
}

extern "C" int spk_mix_fwd(const float* q, const float* mu, const float* dq,
                           const float* dmu, const float* kmix,
                           const float* k0, const float* b0, const float* k1,
                           const float* b1, float* qo, float* muo, int A,
                           int F, float eps, int act, cudaStream_t stream) {
  // the wrapper passes the weights padded to FP and checks the limit
  const size_t smem = spk_mix_smem_bytes(F, 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mix_fwd_kernel<kFwdRows, kFwdWarps>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (A + kFwdRows - 1) / kFwdRows;
  mix_fwd_kernel<kFwdRows, kFwdWarps>
      <<<grid, 32 * kFwdWarps, smem, stream>>>(q, mu, dq, dmu, kmix, k0, b0,
                                               k1, b1, qo, muo, A, F, eps,
                                               act);
  return (int)cudaGetLastError();
}

extern "C" int spk_mix_bwd(const float* q, const float* mu, const float* dq,
                           const float* dmu, const float* gq, const float* gmu,
                           const float* kmix, const float* k0,
                           const float* b0, const float* k1, const float* b1,
                           const float* kmixT, const float* k0T,
                           const float* k1T, float* gqi, float* gmui,
                           float* S, double* wpart, int nsplit, int A, int F,
                           float eps, int act, cudaStream_t stream) {
  // the wrapper passes F % 32 == 0, F <= 256 (ops/painn_mixing.py)
  const size_t smem = spk_mix_smem_bytes(F, 1);
  if (F % 32 != 0 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mix_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mix_bwd_kernel<<<(A + kBwdRows - 1) / kBwdRows, kBwdThreads, smem,
                   stream>>>(q, mu, dq, dmu, gq, gmu, kmix, k0, b0, k1, b1,
                             kmixT, k0T, k1T, gqi, gmui, S, A, F, eps, act);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == nullptr) return (int)err;
  // the weight cotangents from S (mix_wgrad.cuh)
  return launch_mix_wgrad(S, wpart, A, F, nsplit, stream);
}
