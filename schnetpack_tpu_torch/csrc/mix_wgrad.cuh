// The weight cotangents of the PaiNN mixing backward (K4's wgrad instance
// in painn_mixing.cu and the general instance in painn_mixing_gen.cu): both
// write each row's 16F forward and cotangent factors to a table S [A, 16F]
// (columns [mu' 0 | q' 3F | Vn 4F | h 5F | gV 6F | gW 9F | gpre 12F |
// gcat 13F]), and mix_wgrad_kernel forms the products from S as a split-K
// reduction: one block per (64 x 64 output tile, row range), 4 x 4 outputs
// per thread summed in f32 over 32 rows at a time and in f64 over the
// range; each row range writes one f64 partial set [gkmix F x 2F | gk0 2F
// x F | gb0 F | gk1 F x 3F | gb1 3F] that the wrapper sums (deterministic,
// no atomics).  Internal linkage; each source includes it once.
#pragma once

#include <cuda_runtime.h>

namespace {

// One weight cotangent out[i][j] = sum_rows sum_t X_t[row][i] Y_t[row][j]
// with X_t, Y_t column ranges of S (term t shifts both by `step`), written
// at out_off + i * out_ld + j; with bias_off >= 0 also the bias cotangent
// sum_rows Y[row][j] at bias_off + j (output row i = M).
struct WProb {
  int x_off, y_off, M, N, terms, step, out_off, out_ld, bias_off;
  int tiles_n, tile0;
};
constexpr int kWProbs = 4;
struct WProbs {
  WProb p[kWProbs];
};
constexpr int kWT = 64;   // output tile edge
constexpr int kWR = 32;   // rows per f32 step

__global__ void __launch_bounds__(256)
mix_wgrad_kernel(const float* __restrict__ S, double* __restrict__ part,
                 int A, int F, WProbs probs, int rows_per_split,
                 int part_stride) {
  __shared__ __align__(16) float sx[kWR][kWT];
  __shared__ __align__(16) float sy[kWR][kWT];
  int pi = 0;
  while (pi + 1 < kWProbs && (int)blockIdx.x >= probs.p[pi + 1].tile0) ++pi;
  const WProb& pb = probs.p[pi];
  const int t = blockIdx.x - pb.tile0;
  const int i0 = (t / pb.tiles_n) * kWT, j0 = (t % pb.tiles_n) * kWT;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(A, r0 + rows_per_split);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t D16 = 16 * (size_t)F;
  const bool bias = pb.bias_off >= 0;
  double acc64[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc64[a][b] = 0.0;
  for (int term = 0; term < pb.terms; ++term) {
    const int xo = pb.x_off + term * pb.step, yo = pb.y_off + term * pb.step;
    for (int rb = r0; rb < r1; rb += kWR) {
      __syncthreads();  // the previous step's readers are done
      for (int idx = tid; idx < kWR * kWT; idx += 256) {
        const int r = idx / kWT, c = idx - r * kWT, row = rb + r;
        const int i = i0 + c, j = j0 + c;
        float xv = 0.f, yv = 0.f;
        if (row < r1) {
          if (i < pb.M) xv = S[row * D16 + xo + i];
          else if (i == pb.M && bias) xv = 1.f;
          if (j < pb.N) yv = S[row * D16 + yo + j];
        }
        sx[r][c] = xv;
        sy[r][c] = yv;
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
      for (int r = 0; r < kWR; ++r) {
        const float4 xa = *reinterpret_cast<const float4*>(&sx[r][ty * 4]);
        const float4 ya = *reinterpret_cast<const float4*>(&sy[r][tx * 4]);
        const float xs[4] = {xa.x, xa.y, xa.z, xa.w};
        const float ys[4] = {ya.x, ya.y, ya.z, ya.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xs[a], ys[b], acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc64[a][b] += (double)acc[a][b];
    }
  }
  double* out = part + (size_t)blockIdx.y * part_stride;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx * 4 + b;
      if (j >= pb.N) continue;
      if (i < pb.M)
        out[pb.out_off + (size_t)i * pb.out_ld + j] = acc64[a][b];
      else if (i == pb.M && bias)
        out[pb.bias_off + j] = acc64[a][b];
    }
  }
}

// The reduction of the weight cotangents from S over nsplit row ranges
// into wpart [nsplit][7F^2 + 4F] f64
inline int launch_mix_wgrad(const float* S, double* wpart, int A, int F,
                            int nsplit, cudaStream_t stream) {
  // partial layout [gkmix F x 2F | gk0 2F x F | gb0 F | gk1 F x 3F |
  // gb1 3F]; S columns [mu' 0 | q' 3F | Vn 4F | h 5F | gV 6F | gW 9F |
  // gpre 12F | gcat 13F]
  const int FF = F * F;
  WProbs pr;
  pr.p[0] = {0, 6 * F, F, F, 3, F, 0, 2 * F, -1, 0, 0};          // gWv
  pr.p[1] = {0, 9 * F, F, F, 3, F, F, 2 * F, -1, 0, 0};          // gWw
  pr.p[2] = {3 * F, 12 * F, 2 * F, F, 1, 0, 2 * FF, F, 4 * FF, 0, 0};
  pr.p[3] = {5 * F, 13 * F, F, 3 * F, 1, 0, 4 * FF + F, 3 * F,
             7 * FF + F, 0, 0};                                  // gk1, gb1
  int tiles = 0;
  for (int i = 0; i < kWProbs; ++i) {
    WProb& p = pr.p[i];
    const int m = p.M + (p.bias_off >= 0 ? 1 : 0);
    p.tiles_n = (p.N + kWT - 1) / kWT;
    p.tile0 = tiles;
    tiles += ((m + kWT - 1) / kWT) * p.tiles_n;
  }
  const int rows_per_split = (A + nsplit - 1) / nsplit;
  mix_wgrad_kernel<<<dim3(tiles, nsplit), 256, 0, stream>>>(
      S, wpart, A, F, pr, rows_per_split, 7 * FF + 4 * F);
  return (int)cudaGetLastError();
}

}  // namespace
