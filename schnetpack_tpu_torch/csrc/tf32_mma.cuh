// 3xTF32 products on Hopper's tensor cores (mma.sync m16n8k8), shared by
// the PaiNN column message backward (colblock_message_bwd.cu: K2, K7, K15,
// K21), the PaiNN mixing forward and backward (painn_mixing.cu: K3, K4)
// and the SchNet cfconv and its VJP (schnet_columns.cu: K9, K10).  Everything here
// has internal linkage; each source includes it once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 3xTF32 on the tensor cores: v = big + small, big = v rounded to TF32,
// small = the remainder rounded to TF32; a product keeps big*big +
// big*small + small*big (three mma_tf32, into three accumulators in K2's
// grbf product or one in rows_mma), which is f32-accurate (~2^-22
// relative against the ~2^-11 of one TF32 product).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  uint32_t b, s;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(v));
  const float rest = v - __uint_as_float(b);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(s) : "f"(rest));
  big = b;
  small = s;
}

// c += a b for one m16n8k8 tile (a: A fragment, 4 TF32 registers; b: B
// fragment, 2)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One K-segment of a row-tile product: X [16 RT, K] per component c at
// x + c * cs in shared memory (row stride ld; ld = 4 mod 32 keeps the A
// fragments' 8 rows x 4 columns on 32 banks), times W [K, N] (row stride
// ldw): row-major in global memory, read through L1 from L2 (kWGlobal),
// or in shared memory, row-major (kWShared) or as its transpose, W[k][n]
// at w[n * ldw + k] (kWSharedT).
struct MmaSeg {
  const float* x;
  int ld, cs;
  const float* w;
  int ldw, K;
};
constexpr int kWGlobal = 0, kWShared = 1, kWSharedT = 2;

// out[c][r][n] = sum over the segments of X_c[r][:] W[:, n] for a block's
// 16 RT rows and C components, in 3xTF32 with f32 sums.  The NW warps take
// NT n8-tiles at a time (N % 8 == 0, K % 8 == 0): each B fragment is
// loaded (the next k-step's while this one's products run) and split once
// and serves every m16 tile of the block, an RT x C x NT set of f32
// accumulators.  A k-step's three products (the small cross terms first,
// then the big product) go into a fresh fragment that is then added to
// the tile's sum: the tensor cores' own f32 accumulation is not rounded
// to nearest, and carried over K = 768 it missed the float64 twin of the
// mixing VJP by 5.6e-5 where f32 arithmetic misses by ~2e-5 (H100).
// With COMP the fragments are added to the sum with Kahan's compensation
// (four adds for one): K3's q_out = q' + a + c vw cancels to near 0 where
// c vw is large, and with plain f32 sums it missed the float64 twin there
// by up to 1.15x the mixing tolerance at F = 256 and 12,800 rows (0.65x
// compensated; H100, scripts/time_mixing_kernels.py --tol).
// epi(c, r, n, v) receives every output element once, in registers; it
// may write any shared memory the segments do not read.  The NW warps
// are those of the calling thread's group of 32 NW threads.
// WM says where W lies (kWGlobal, kWShared or kWSharedT, above).
template <int RT, int C, int NT, int NW, bool COMP = false,
          int WM = kWGlobal, int NSEG, class Epi>
__device__ __forceinline__ void rows_mma(const MmaSeg (&seg)[NSEG], int N,
                                         Epi&& epi) {
  constexpr int MT = RT * C;
  static_assert((NW & (NW - 1)) == 0, "NW: a power of two");
  // the warp within its group of NW (a block may run several groups)
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & (NW - 1);
  const int gid = lane >> 2, tig = lane & 3;
  for (int n0 = warp * NT * 8; n0 < N; n0 += NW * NT * 8) {
    float acc[MT][NT][4] = {};
    float cmp[COMP ? MT : 1][COMP ? NT : 1][4] = {};
#pragma unroll
    for (int s = 0; s < NSEG; ++s) {
      const MmaSeg sg = seg[s];
      // W[k][n] of the lane at wp, W[k + 4][n] at wp + w4, the next
      // k-step at wp + w8, the next n-tile at wp + wj
      constexpr bool tr = WM == kWSharedT;
      const float* wp = tr ? sg.w + (size_t)(n0 + gid) * sg.ldw + tig
                           : sg.w + (size_t)tig * sg.ldw + n0 + gid;
      const size_t w4 = tr ? 4 : (size_t)4 * sg.ldw;
      const size_t w8 = tr ? 8 : (size_t)8 * sg.ldw;
      const size_t wj = tr ? (size_t)8 * sg.ldw : 8;
      auto wload = [](const float* p) {
        if constexpr (WM == kWGlobal) return __ldg(p);
        else return *p;
      };
      float wr[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        wr[j][0] = wload(wp + wj * j);
        wr[j][1] = wload(wp + w4 + wj * j);
      }
      const float* xp = sg.x + gid * sg.ld + tig;
      for (int k = 0; k < sg.K; k += 8) {
        uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          split_tf32(wr[j][0], bb[j][0], bs[j][0]);
          split_tf32(wr[j][1], bb[j][1], bs[j][1]);
        }
        if (k + 8 < sg.K) {
          wp += w8;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            wr[j][0] = wload(wp + wj * j);
            wr[j][1] = wload(wp + w4 + wj * j);
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float* a = xp + (i % RT) * 16 * sg.ld + (i / RT) * sg.cs + k;
          uint32_t ab[4], as[4];
          split_tf32(a[0], ab[0], as[0]);
          split_tf32(a[8 * sg.ld], ab[1], as[1]);
          split_tf32(a[4], ab[2], as[2]);
          split_tf32(a[8 * sg.ld + 4], ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float t[4] = {};
            mma_tf32(t, as, bb[j]);
            mma_tf32(t, ab, bs[j]);
            mma_tf32(t, ab, bb[j]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if constexpr (COMP) {
                const float y = t[e] - cmp[i][j][e];
                const float sum = acc[i][j][e] + y;
                cmp[i][j][e] = (sum - acc[i][j][e]) - y;
                acc[i][j][e] = sum;
              } else {
                acc[i][j][e] += t[e];
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int c = i / RT, r = (i % RT) * 16 + gid;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + 8 * j + 2 * tig;
        epi(c, r, n, acc[i][j][0]);
        epi(c, r, n + 1, acc[i][j][1]);
        epi(c, r + 8, n, acc[i][j][2]);
        epi(c, r + 8, n + 1, acc[i][j][3]);
      }
    }
  }
}

}  // namespace
