// General instances of SchNet's cfconv on the column layout for Hopper
// (sm_90a), f32: every filter width F and basis size B that the tuned
// instances (schnet_columns.cu: F = 64 or 128, B <= 32) do not take.
// They replace the same TPU kernels:
// K9 cf_fwd_gen_kernel<kWide, kScr>: schnetpack_tpu/ops/schnet_columns.py
//   :79 _cf_fwd_kernel;
// K10 cf_bwd_gen_kernel<W, kWide, kScr>: schnetpack_tpu/ops/
//   schnet_columns.py:145 _cf_bwd_kernel: dh and the geometry cotangent, and with W the filter
//   weight cotangents gW1 [B, F], gb1, gW2 [F, F], gb2.
// The per-slot math, the layout and the schedules are the tuned kernels'
// (their header): z1 = phi W1 + b1, h1 = ssp(z1), pre = h1 W2 + b2, out_i
// += h_j pre fcut; the VJP gW = g_i h_j, gfcut = sum_f gW pre, gpre = gW
// fcut, gh1 = gpre W2^T, gz1 = gh1 sigmoid(z1), gphi = gz1 W1^T.
//
// The design (the tuned kernels', at any width): what bounds them is the
// filter MLP, B F + F^2 FMAs a slot, recomputed by K10 and twice that
// backward, ~4 (B F + F^2) FMAs in all; the products run on the tensor
// cores in 3xTF32 (tf32_mma.cuh's splits and mma_tf32; each k-step's three
// products in a fresh fragment added to an f32 sum with Kahan's
// compensation where K is the wide F, so that those sums keep f32
// accuracy).
//   * Zero padding: F to Fp = F rounded up to 32 and the basis to Bp = B+1
//     rounded up to 8 (a column of ones at B: its row of W1 is zero, and
//     the wgrad product's row B is gb1).  The wrapper pads W1, b1, W2 and
//     b2 once per parameter version (ops/schnet_columns.py::
//     gen_padded_weights); a padded filter is ssp(0) = 0 (up to the fast
//     log's rounding) times a zero row of W2, gpre and gz1 are 0 there, so
//     the padded terms add exact zeros.
//   * A block runs QG row-range groups of 4 warps, each on its own named
//     barrier (QG = 4 at Fp <= 64, 2 at 128, else 1; K10's wgrad 1),
//     sharing the padded weights in shared memory where they fit; else (the
//     kWide
//     instances) it reads them through L1 from L2 and adds the k-steps'
//     fragments with Kahan's compensation (F = 512: K = 512).  In each
//     product a warp takes 4, 2 or 1 n8-tiles at a time, a compile-time
//     count that divides the product's tiles (cfg_mma): no tile is cut,
//     and the k-loop has no branch.  A chunk is one m16 tile of 16 slots,
//     staged by cp.async into the other of two buffers while the chunk
//     before runs.  K9 walks the destination schedule (a slot's source
//     row: qcol in the column of its bucket), first dropping each range's
//     slots with fcut = 0 (past the cutoff, a third of the bench box's:
//     they add exact zeros; a ballot a warp, in slot order, into the
//     wrapper's list `kept`), K10 the source schedule.  Per chunk:
//     P1  z1 = [phi | 1] W1 + b1 (K = Bp: any B) -> h1 = ssp(z1) (K10 also
//         sigmoid(z1)), once a slot;
//     P2  pre = h1 W2 + b2;
//   K9 then folds: thread f (features f, f + 128, ...) sums h_j (pre
//     fcut) of the chunk's slots in slot order onto the open destination
//     row (feature f's source rows read from L2, for the thread's first
//     feature issued before P1 so that they land under it), the open sum
//     kept across chunks (a register, or shared memory for a thread's
//     further features) and stored once when the row's run ends: every
//     row of the range is written once (rows without a slot get 0), with
//     no atomics.
//   K10 goes on:
//     E1  per (slot, feature) over all the group's threads (their
//         operands, the destination rows' cotangents and the source rows,
//         loaded eight pairs a thread at a time, the first eight under
//         P2's barrier): ghj, gpre over pre, and gW pre's warp sums (a
//         warp: 32 features of one slot), whose Fp / 32 partials a slot
//         are added in order into gfcut;
//     F1  thread f (features f, f + 128, ...) folds ghj onto the open
//         source row in slot order (stored once when its run ends: every
//         row of the range written once, no zero fill) and sums gb2;
//     P3  gz1 = (gpre W2^T) sigmoid(z1), and in the wgrad instance gW2 +=
//         h1^T gpre;
//     P4  gphi = gz1 W1^T, written at the slot's channels b < B, and
//         [gW1; gb1] += [phi | 1]^T gz1.
//   * The weight cotangents are the block's f32 sums, in shared memory
//     where they fit (else in the block's own slice of the partial in
//     global memory, each thread's elements loaded before the chunk's
//     products so that their latency hides under them), each element
//     added to by one thread per chunk in a fixed order, written to the
//     partial once at the block's end; the wrapper adds the partials in
//     f64.  Every ggeo element and dh row has one writer; no atomics, so a
//     run repeats bit for bit.
//   Measured on the H100 (chip_smoke.py phase 17, PERF.md): at F = 30 the
//   chunk's fixed latency bounds it (16 slots between five barriers,
//   products of K = 24-32 on one m16 tile); at F = 512 the weights streamed
//   from L2 every chunk; at B = 300 the geometry's 304 channels a slot, read
//   and written as 4-byte accesses at slots out of their column order (the
//   geometry is channel-major), a 32-byte sector each.
//   Every F >= 1 and B >= 1 runs.  Where one group's tiles and staged
//   basis rows do not fit a block's shared memory (F above 832 at B = 20,
//   B above 1663 at F = 64) the kScr instances run the same phases with
//   one group a block, its chunk buffers, tiles and sums in the block's
//   slice of a scratch in global memory (gen_launch.cuh::in_waves), the
//   weights through L1.

#include <cuda_runtime.h>

// KOffs, bucket_of, warp_sum; cp.async and the 3xTF32 pieces through it
#include "colblock_message.cuh"
#include "gen_launch.cuh"

namespace {

constexpr float kLn2g = 0.69314718055994531f;
// slots a chunk (one m16 tile), warps a row-range group, groups a block at
// most
constexpr int kCfE = 16;
constexpr int kCfWarps = 4;
constexpr int kCfNTH = 32 * kCfWarps;
constexpr int kCfMaxGroups = 4;
constexpr int kCfE1 = 8;  // K10's E1: (slot, feature) pairs a thread loads

// the padded widths: Fp (F to 32), Bp (B + 1 to 8), MP (Bp to 16: the
// rows of the [gW1; gb1] sum)
__host__ __device__ inline int cfg_fp(int F) { return (F + 31) / 32 * 32; }
__host__ __device__ inline int cfg_bp(int B) { return (B + 1 + 7) / 8 * 8; }
__host__ __device__ inline int cfg_mp(int B) {
  return (cfg_bp(B) + 15) / 16 * 16;
}

// floats of one group: two buffers of the staged chunk (phi [E][MP+4],
// fcut and four int arrays [E]), the tiles h1 (the plain instance's ghj
// over it), sigmoid(z1) -> gz1 and pre -> gpre [E][Fp+4] (wgrad: a ghj
// tile too), the gfcut partials [E][Fp/32], the fold's open sums and gb2
// [Fp]; with `sums` the weight cotangents' f32 sums [MP+Fp][Fp+8]
__host__ __device__ inline size_t cfg_group_floats(int Fp, int B,
                                                    bool wgrad, bool sums) {
  const int MP = cfg_mp(B);
  return 2 * ((size_t)kCfE * (MP + 4) + 5 * kCfE) +
         (wgrad ? 4 : 3) * (size_t)kCfE * (Fp + 4) +
         (size_t)kCfE * (Fp / 32) + 2 * (size_t)Fp +
         (sums ? (size_t)(MP + Fp) * (Fp + 8) : 0);
}

// floats of one K9 group: two buffers of the staged chunk, the tiles h1
// and pre [E][Fp+4], the fold's open sums [Fp], the compaction's warp
// counts [kCfWarps]
__host__ __device__ inline size_t cff_group_floats(int Fp, int B) {
  return 2 * ((size_t)kCfE * (cfg_mp(B) + 4) + 5 * kCfE) +
         2 * (size_t)kCfE * (Fp + 4) + Fp + kCfWarps;
}

// the padded weights W2 [Fp][Fp+4] and W1 [Bp][Fp+4] in shared memory
inline size_t cfg_weight_floats(int Fp, int B) {
  return (size_t)(Fp + cfg_bp(B)) * (Fp + 4);
}

// how a launch runs: groups a block, weights and sums in shared memory,
// the group's tiles in global scratch (scr: not even one group fits),
// bytes of shared memory
struct CfgPlan {
  int qg, wsm, ssm, scr;
  size_t smem;
};

// (K9: fwd; its groups' floats cff_group_floats)
inline CfgPlan cfg_plan(int F, int B, bool wgrad, int optin,
                        bool fwd = false) {
  const int Fp = cfg_fp(F);
  const int pref = wgrad ? 1 : Fp <= 64 ? 4 : Fp <= 128 ? 2 : 1;
  const size_t w = cfg_weight_floats(Fp, B);
  auto bytes = [&](int qg, int wsm, int ssm) {
    const size_t gf =
        fwd ? cff_group_floats(Fp, B) : cfg_group_floats(Fp, B, wgrad, ssm);
    return sizeof(float) * ((wsm ? w : 0) + (size_t)qg * gf);
  };
  // sums in shared memory first (added to every chunk), then the weights
  // (read every chunk), then fewer groups; then one group a block in
  // global scratch, the weights read through L1 (they are larger still)
  const int order[4][2] = {{1, 1}, {0, 1}, {1, 0}, {0, 0}};
  for (const auto& o : order) {
    const int wsm = o[0], ssm = wgrad ? o[1] : 0;
    for (int qg = pref; qg >= 1; --qg)
      if (bytes(qg, wsm, ssm) <= (size_t)optin)
        return {qg, wsm, ssm, 0, bytes(qg, wsm, ssm)};
  }
  return {1, 0, 0, 1, 0};
}

// the named barrier of a group of n threads
__device__ __forceinline__ void cfg_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// out[r][n] = X [16, K] (row stride ld) times W [K, N] (row stride ldw;
// kTr: W[k][n] at w[n * ldw + k]) for one m16 tile, K % 8 == 0, in 3xTF32:
// tf32_mma.cuh's rows_mma with NT n8-tiles a warp at a time over a runtime
// N (N % (8 NT) == 0: no tile is cut).  kWide: W in global memory, read
// through L1 (__ldg), and the k-steps' fragments added with Kahan's
// compensation (the K = Fp-long sums of wide filters); else W in shared
// memory and plain f32 sums, as the tuned K10's.  epi(r, n, v) receives
// every output element once.
template <int NT, int NW, bool kTr, bool kWide, class Epi>
__device__ __forceinline__ void cfg_mma_nt(const float* x, int ld,
                                           const float* w, int ldw, int K,
                                           int N, Epi& epi) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & (NW - 1);
  const int gid = lane >> 2, tig = lane & 3;
  auto wload = [](const float* p) {
    if constexpr (kWide) return __ldg(p);
    else return *p;
  };
  for (int n0 = warp * NT * 8; n0 < N; n0 += NW * NT * 8) {
    float acc[NT][4] = {}, cmp[kWide ? NT : 1][4] = {};
    const float* wp = kTr ? w + (size_t)(n0 + gid) * ldw + tig
                          : w + (size_t)tig * ldw + n0 + gid;
    const size_t w4 = kTr ? 4 : (size_t)4 * ldw;
    const size_t w8 = kTr ? 8 : (size_t)8 * ldw;
    const size_t wj = kTr ? (size_t)8 * ldw : 8;
    float wr[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      wr[j][0] = wload(wp + wj * j);
      wr[j][1] = wload(wp + w4 + wj * j);
    }
    const float* xp = x + gid * ld + tig;
    for (int k = 0; k < K; k += 8) {
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        split_tf32(wr[j][0], bb[j][0], bs[j][0]);
        split_tf32(wr[j][1], bb[j][1], bs[j][1]);
      }
      if (k + 8 < K) {  // the next k-step's weights load under this one
        wp += w8;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          wr[j][0] = wload(wp + wj * j);
          wr[j][1] = wload(wp + w4 + wj * j);
        }
      }
      const float* a = xp + k;
      uint32_t ab[4], as[4];
      split_tf32(a[0], ab[0], as[0]);
      split_tf32(a[8 * ld], ab[1], as[1]);
      split_tf32(a[4], ab[2], as[2]);
      split_tf32(a[8 * ld + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float t[4] = {};
        mma_tf32(t, as, bb[j]);
        mma_tf32(t, ab, bs[j]);
        mma_tf32(t, ab, bb[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kWide) {
            const float y = t[e] - cmp[j][e];
            const float s = acc[j][e] + y;
            cmp[j][e] = (s - acc[j][e]) - y;
            acc[j][e] = s;
          } else {
            acc[j][e] += t[e];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + 2 * tig;
      epi(gid, n, acc[j][0]);
      epi(gid, n + 1, acc[j][1]);
      epi(gid + 8, n, acc[j][2]);
      epi(gid + 8, n + 1, acc[j][3]);
    }
  }
}

// cfg_mma_nt with the most n8-tiles a warp takes at a time (4, 2 or 1)
// that divides N's tiles and gives every warp one where N is narrow
template <int NW, bool kTr, bool kWide, class Epi>
__device__ __forceinline__ void cfg_mma(const float* x, int ld,
                                        const float* w, int ldw, int K,
                                        int N, Epi&& epi) {
  const int tiles = N >> 3, per = (tiles + NW - 1) / NW;
  if (per >= 4 && tiles % 4 == 0)
    cfg_mma_nt<4, NW, kTr, kWide>(x, ld, w, ldw, K, N, epi);
  else if (per >= 2 && tiles % 2 == 0)
    cfg_mma_nt<2, NW, kTr, kWide>(x, ld, w, ldw, K, N, epi);
  else
    cfg_mma_nt<1, NW, kTr, kWide>(x, ld, w, ldw, K, N, epi);
}

// out[m][n] += sum over the chunk's 16 slots e of A[e][m] Bm[e][n], for M
// rows (M % 16 == 0) and N columns (N % 32 == 0), A and Bm in shared memory
// (row strides lda, ldb), out in shared or global memory (row stride ldo):
// the wgrad products.  The warps take (m16 tile, 4 n8-tiles) items in
// turn; a thread loads its elements of out first (in global memory their
// latency then hides under the products), per k-step of 8 slots the three
// products of a tile go into a fresh fragment added to the chunk's f32
// sum, which the thread adds to its own elements of out (the same thread
// every chunk).
template <int NW>
__device__ __forceinline__ void cfg_acc_tn(const float* A, int lda, int M,
                                           const float* Bm, int ldb, int N,
                                           float* out, int ldo) {
  constexpr int NG = 4;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & (NW - 1);
  const int gid = lane >> 2, tig = lane & 3;
  const int ng = N / (8 * NG), items = (M >> 4) * ng;
  for (int it = warp; it < items; it += NW) {
    const int m0 = (it / ng) * 16, n0 = (it % ng) * 8 * NG;
    float acc[NG][4], old[NG][4];
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const float* o = out + (size_t)(m0 + gid) * ldo + n0 + 8 * j + 2 * tig;
      old[j][0] = o[0];
      old[j][1] = o[1];
      old[j][2] = o[8 * (size_t)ldo];
      old[j][3] = o[8 * (size_t)ldo + 1];
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kCfE; k += 8) {
      const float* a = A + (k + tig) * lda + m0 + gid;
      uint32_t ab[4], as[4];
      split_tf32(a[0], ab[0], as[0]);
      split_tf32(a[8], ab[1], as[1]);
      split_tf32(a[4 * lda], ab[2], as[2]);
      split_tf32(a[4 * lda + 8], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const float* b = Bm + (k + tig) * ldb + n0 + 8 * j + gid;
        uint32_t bb[2], bs[2];
        split_tf32(b[0], bb[0], bs[0]);
        split_tf32(b[4 * ldb], bb[1], bs[1]);
        float t[4] = {};
        mma_tf32(t, as, bb);
        mma_tf32(t, ab, bs);
        mma_tf32(t, ab, bb);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += t[e];
      }
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      float* o = out + (size_t)(m0 + gid) * ldo + n0 + 8 * j + 2 * tig;
      o[0] = old[j][0] + acc[j][0];
      o[1] = old[j][1] + acc[j][1];
      o[8 * (size_t)ldo] = old[j][2] + acc[j][2];
      o[8 * (size_t)ldo + 1] = old[j][3] + acc[j][3];
    }
  }
}

// A group's staged chunks: two buffers of kCfE slots (slot i of buffer b
// at b * kCfE + i)
struct CfgChunk {
  float* phi;  // [2][E][ldp] phi | 1 | 0
  float* fc;   // [2][E] fcut
  int* k;      // [2][E] the slot in its destination column
  int* q;      // [2][E] qcol
  int* d;      // [2][E] dcol
  int* col;    // [2][E] the destination column
  int ldp;
};

__device__ __forceinline__ CfgChunk cfg_carve(float* base, int B) {
  constexpr int E = kCfE;
  CfgChunk c;
  c.ldp = cfg_mp(B) + 4;
  c.phi = base;
  c.fc = c.phi + 2 * E * c.ldp;
  c.k = reinterpret_cast<int*>(c.fc + 2 * E);
  c.q = c.k + 2 * E;
  c.d = c.q + 2 * E;
  c.col = c.d + 2 * E;
  return c;
}

// 4 bytes from global memory to a staging buffer: by cp.async into
// shared memory, or (kScr) a load and a store into global scratch
template <bool kScr>
__device__ __forceinline__ void cfg_cp4(void* dst, const void* src) {
  if constexpr (kScr)
    *static_cast<unsigned*>(dst) = __ldg(static_cast<const unsigned*>(src));
  else
    cp_async4(dst, src);
}

// Stage slot s (``ok``: a real slot of the range; else zeros) at chunk
// position tid % E of buffer b (cfg_cp4): the group's threads take
// kCfNTH / E channels of each slot, thread tid < E also its fcut, qcol and
// dcol, and ``col_of(its column, k)`` (schnet_columns.cu's stage)
template <bool kScr, class ColOf>
__device__ __forceinline__ void cfg_stage(const CfgChunk& c, int b, int tid,
                                          bool ok, int s, const float* geo,
                                          const int* qcol, const int* dcol,
                                          int Ktot, int B, ColOf col_of) {
  constexpr int E = kCfE, kSt = kCfNTH / kCfE;
  const int st_e = tid % E, st_p = tid / E;
  const int dc = s / Ktot, k = s - dc * Ktot;
  const size_t goff = (size_t)dc * (B + 4) * Ktot + k;
  float* ph = c.phi + (b * E + st_e) * c.ldp;
  for (int ch = st_p; ch < c.ldp; ch += kSt) {
    if (ok && ch < B) cfg_cp4<kScr>(ph + ch, geo + goff + (size_t)ch * Ktot);
    else ph[ch] = ok && ch == B ? 1.f : 0.f;
  }
  if (st_p == 0) {
    const int i = b * E + st_e;
    if (ok) {
      cfg_cp4<kScr>(c.fc + i, geo + goff + (size_t)B * Ktot);
      cfg_cp4<kScr>(c.q + i, qcol + s);
      cfg_cp4<kScr>(c.d + i, dcol + s);
    } else {
      c.fc[i] = 0.f;
      c.q[i] = 0;
      c.d[i] = 0;
    }
    c.k[i] = k;
    c.col[i] = col_of(dc, k);
  }
  cp_async_commit();
}

// The padded weights W1p [Bp][Fp], W2p [Fp][Fp] of a launch's blocks: in
// shared memory at row stride Fp + 4 (W2 first, then W1), loaded by the
// whole block, or (kWide) left in global memory, read through L1
template <bool kWide>
__device__ __forceinline__ float* cfg_weights(float* smem, const float* W1p,
                                              const float* W2p, int Fp,
                                              int Bp) {
  const int LDF = Fp + 4;
  if constexpr (!kWide) {
    float* W1s = smem + (size_t)Fp * LDF;
    for (int t = threadIdx.x; t < Fp * Fp; t += blockDim.x)
      smem[(t / Fp) * LDF + t % Fp] = __ldg(W2p + t);
    for (int t = threadIdx.x; t < Bp * Fp; t += blockDim.x)
      W1s[(t / Fp) * LDF + t % Fp] = __ldg(W1p + t);
    __syncthreads();
    return W1s + (size_t)Bp * LDF;  // the groups' floats follow
  }
  return smem;
}

// K9's general instance on the padded weights (kWide, kScr: K10's); block
// b takes row ranges v0 + b QG + q of the grid's nx * ny * G (v0: the
// wave's first; 0 without kScr), one a group of kCfNTH threads.
template <bool kWide, bool kScr>
__global__ void __launch_bounds__(kCfNTH * kCfMaxGroups, 1)
    cf_fwd_gen_kernel(const float* __restrict__ h,
                      const float* __restrict__ geo,
                      const float* __restrict__ W1p,
                      const float* __restrict__ b1p,
                      const float* __restrict__ W2p,
                      const float* __restrict__ b2p,
                      const int* __restrict__ qcol,
                      const int* __restrict__ dcol,
                      const int* __restrict__ dsorted,
                      const int* __restrict__ grp, float* __restrict__ out,
                      int nx, int ny, int P, int Ktot, KOffs ko, int G, int B,
                      int F, float* __restrict__ scr, int v0, int* kept) {
  static_assert(kWide || !kScr, "scratch only with the weights in L2");
  constexpr int E = kCfE, NW = kCfWarps, NTH = kCfNTH;
  extern __shared__ __align__(16) float cf_smem[];
  const int Fp = cfg_fp(F), Bp = cfg_bp(B), LDF = Fp + 4;
  const int QG = blockDim.x / NTH;
  float* gmem = cfg_weights<kWide>(cf_smem, W1p, W2p, Fp, Bp);
  const float* w2 = kWide ? W2p : cf_smem;
  const float* w1 = kWide ? W1p : cf_smem + (size_t)Fp * LDF;
  const int ldw = kWide ? Fp : LDF;
  // group q takes row range vb of the grid's nx * ny * G
  const int q = threadIdx.x / NTH, tid = threadIdx.x - q * NTH;
  const int vb = v0 + blockIdx.x * QG + q;
  if (vb >= nx * ny * G) return;
  const int col = vb / G, grow = vb - col * G;
  const int ci = col / ny, cj = col - ci * ny;
  auto sync = [&]() { cfg_sync(1 + q, NTH); };
  const size_t gfl = cff_group_floats(Fp, B);
  const CfgChunk ch = cfg_carve(
      kScr ? scr + (size_t)blockIdx.x * gfl : gmem + (size_t)q * gfl, B);
  float* H1 = reinterpret_cast<float*>(ch.col + 2 * E);  // [E][LDF] h1
  float* PR = H1 + E * LDF;                              // [E][LDF] pre
  float* s_racc = PR + E * LDF;  // [Fp] the fold's open sums past NTH

  const int* gb = grp + ((size_t)col * (G + 1) + grow) * 2;
  const int r0 = gb[0], e0 = gb[1], r1 = gb[2];
  int e1 = gb[3];
  // the range's slots with fcut != 0, in order, to kept[e0, e1) (a slot
  // with fcut = 0 adds exactly 0): NTH slots a pass, each warp's by its
  // ballot, the warps' counts added in order
  int* wcnt = reinterpret_cast<int*>(s_racc + Fp);  // [NW]
  const int lane = tid & 31, w = tid >> 5;
  int m = 0;
  for (int b = e0; b < e1; b += NTH) {
    int sl = 0;
    bool keep = false;
    if (b + tid < e1) {
      sl = dsorted[b + tid];
      const int dc = sl / Ktot, k = sl - dc * Ktot;
      keep = __ldg(geo + ((size_t)dc * (B + 4) + B) * Ktot + k) != 0.f;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) wcnt[w] = __popc(bal);
    sync();
    int off = m;
    for (int i = 0; i < NW; ++i) {
      if (i < w) off += wcnt[i];
      m += wcnt[i];
    }
    if (keep) kept[e0 + off + __popc(bal & ((1u << lane) - 1))] = sl;
    sync();  // the counts read, kept written (plain loads read it back)
  }
  e1 = e0 + m;
  const int* order = kept;  // the slots the range walks
  // a slot of column col: the source column of its bucket
  auto src_col = [&](int, int k) {
    const int c9 = bucket_of(k, ko), c3 = c9 / 3;
    int si = ci + c3 - 1, sj = cj + c9 - 3 * c3 - 1;
    si += si < 0 ? nx : (si >= nx ? -nx : 0);
    sj += sj < 0 ? ny : (sj >= ny ? -ny : 0);
    return si * ny + sj;
  };
  const int st_e = tid % E;
  auto slot_at = [&](int e) { return e < e1 ? order[e] : 0; };
  cfg_stage<kScr>(ch, 0, tid, e0 + st_e < e1, slot_at(e0 + st_e), geo, qcol,
                  dcol, Ktot, B, src_col);
  int sl_nxt = slot_at(e0 + E + st_e);

  // the fold: the open destination row and the first row of the range not
  // yet written (the same in every thread); thread tid's first feature's
  // open sum in a register, its others' in s_racc
  float* o = out + (size_t)col * P * F;
  int run = -1, next = r0;
  float racc = 0.f;
  for (int base = e0, it = 0; base < e1; base += E, ++it) {
    const int buf = it & 1, n = min(E, e1 - base);
    const float* fc = ch.fc + buf * E;
    const int* cs = ch.col + buf * E;
    const int* qs = ch.q + buf * E;
    const int* ds = ch.d + buf * E;
    cp_async_wait<0>();
    sync();  // (A) this chunk staged; the last one's fold done with PR
    if (base + E < e1) {  // the next chunk's loads run under this one
      cfg_stage<kScr>(ch, buf ^ 1, tid, base + E + st_e < e1, sl_nxt, geo,
                      qcol, dcol, Ktot, B, src_col);
      sl_nxt = slot_at(base + 2 * E + st_e);
    }
    // feature f of the chunk's source rows, from L2
    auto h_rows = [&](int f, float (&hv)[kCfE]) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        hv[e] = e < n ? __ldg(h + ((size_t)cs[e] * P + qs[e]) * F + f) : 0.f;
    };
    float hv[kCfE];
    if (tid < F) h_rows(tid, hv);  // lands under P1
    // P1: h1 = ssp(z1 + b1), by the fast intrinsics (the tuned K9's)
    cfg_mma<NW, false, kWide>(
        ch.phi + buf * E * ch.ldp, ch.ldp, w1, ldw, Bp, Fp,
        [&](int r, int f, float v) {
          const float z = v + __ldg(b1p + f);
          H1[r * LDF + f] =
              fmaxf(z, 0.f) + __logf(1.f + __expf(-fabsf(z))) - kLn2g;
        });
    sync();  // (B)
    // P2: pre = h1 W2 + b2
    cfg_mma<NW, false, kWide>(H1, LDF, w2, ldw, Fp, Fp,
                              [&](int r, int f, float v) {
                                PR[r * LDF + f] = v + __ldg(b2p + f);
                              });
    sync();  // (C)
    // feature f's fold of the chunk onto the destination rows in slot
    // order, from the open row rn (the first row not written nxr) and its
    // sum acc; returns the sum
    auto fold = [&](int f, const float(&hv)[kCfE], int rn, int nxr,
                    float acc) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e >= n) break;
        const int d = ds[e];
        if (d != rn) {  // the run of row rn ended
          if (rn >= 0) {
            o[(size_t)rn * F + f] = acc;
            nxr = rn + 1;
          }
          for (; nxr < d; ++nxr) o[(size_t)nxr * F + f] = 0.f;
          rn = d;
          acc = 0.f;
        }
        acc += hv[e] * (PR[e * LDF + f] * fc[e]);
      }
      return acc;
    };
    if (tid < F) racc = fold(tid, hv, run, next, racc);
    for (int f = tid + NTH; f < F; f += NTH) {
      float hw[kCfE];
      h_rows(f, hw);
      s_racc[f] = fold(f, hw, run, next, s_racc[f]);
    }
    for (int e = 0; e < n; ++e) {  // every thread follows the runs
      const int d = ds[e];
      if (d != run) run = next = d;
    }
  }
  for (int f = tid; f < F; f += NTH) {  // close the last run; then zeros
    int r = next;
    if (run >= 0) {
      o[(size_t)run * F + f] = f == tid ? racc : s_racc[f];
      r = run + 1;
    }
    for (; r < r1; ++r) o[(size_t)r * F + f] = 0.f;
  }
}

// kWide: the padded weights read through L1 from L2 (they do not fit a
// block's shared memory), the products' sums compensated; else the weights
// in shared memory, shared by the block's groups.  kScr (with kWide): one
// group a block, its chunk buffers, tiles and sums in the block's slice of
// scr (global memory), the shapes whose tiles do not fit shared memory.
// Block b takes row range v0 + b of the grid's ncol * G (v0: the wave's
// first; 0 without kScr).
template <bool kWgrad, bool kWide, bool kScr>
__global__ void __launch_bounds__(kCfNTH * kCfMaxGroups, 1)
    cf_bwd_gen_kernel(const float* __restrict__ h,
                      const float* __restrict__ geo,
                      const float* __restrict__ W1p,
                      const float* __restrict__ b1p,
                      const float* __restrict__ W2p,
                      const float* __restrict__ b2p,
                      const int* __restrict__ qcol,
                      const int* __restrict__ dcol,
                      const int* __restrict__ esorted,
                      const int* __restrict__ grp,
                      const float* __restrict__ g, float* __restrict__ dh,
                      float* __restrict__ ggeo, float* __restrict__ wpart,
                      int ncol, int P, int Ktot, int G, int B, int F,
                      int ssm, float* __restrict__ scr, int v0) {
  static_assert(kWide || !kScr, "scratch only with the weights in L2");
  constexpr int E = kCfE, NW = kCfWarps, NTH = kCfNTH;
  extern __shared__ __align__(16) float cf_smem[];
  const int Fp = cfg_fp(F), Bp = cfg_bp(B), MP = cfg_mp(B), nch = B + 4;
  const int LDF = Fp + 4, LDS = Fp + 8, kQ = Fp >> 5;
  const int QG = blockDim.x / NTH;
  // the padded weights: in shared memory for the block's groups, or read
  // through L1 from L2 (kWide)
  float* gmem = cfg_weights<kWide>(cf_smem, W1p, W2p, Fp, Bp);
  const float* w2 = kWide ? W2p : cf_smem;
  const float* w1 = kWide ? W1p : cf_smem + (size_t)Fp * LDF;
  const int ldw = kWide ? Fp : LDF;
  // group q takes row range vb of the grid's ncol * G
  const int q = threadIdx.x / NTH, tid = threadIdx.x - q * NTH;
  const int vb = v0 + blockIdx.x * QG + q;
  if (vb >= ncol * G) return;
  const int col = vb / G, grow = vb - col * G;
  auto sync = [&]() { cfg_sync(1 + q, NTH); };
  const bool own_sums = kWgrad && ssm;
  const size_t gfl = cfg_group_floats(Fp, B, kWgrad, own_sums);
  const CfgChunk ch = cfg_carve(
      kScr ? scr + (size_t)blockIdx.x * gfl : gmem + (size_t)q * gfl, B);
  float* H1 = reinterpret_cast<float*>(ch.col + 2 * E);  // [E][LDF] h1
  float* SG = H1 + E * LDF;       // sigmoid(z1) -> gz1
  float* PR = SG + E * LDF;       // pre -> gpre
  float* GH = kWgrad ? PR + E * LDF : H1;  // ghj (plain: h1 is dead then)
  float* s_gfc = PR + (kWgrad ? 2 : 1) * E * LDF;  // [E][kQ] gfcut partials
  float* s_racc = s_gfc + E * kQ; // [Fp] the fold's open sums
  float* s_gb2 = s_racc + Fp;     // [Fp] gb2
  // the weight cotangents' sums: [MP][LDS] gW1 | gb1 | 0, [Fp][LDS] gW2
  // and in the partial a last row gb2
  const size_t wrows = (size_t)MP + Fp + 1;
  float* wout = kWgrad ? wpart + (size_t)vb * wrows * LDS : nullptr;
  float* S = own_sums ? s_gb2 + Fp : wout;
  if constexpr (kWgrad)
    for (int t = tid; t < (MP + Fp) * LDS; t += NTH) S[t] = 0.f;
  for (int f = tid; f < Fp; f += NTH) s_racc[f] = s_gb2[f] = 0.f;

  const int* gb = grp + ((size_t)col * (G + 1) + grow) * 2;
  const int r0 = gb[0], e0 = gb[1], r1 = gb[2], e1 = gb[3];
  const size_t row0 = (size_t)col * P;  // the column's first row of h, dh
  const int st_e = tid % E;
  auto slot_at = [&](int e) { return e < e1 ? esorted[e] : 0; };
  auto dst_col = [](int dc, int) { return dc; };
  cfg_stage<kScr>(ch, 0, tid, e0 + st_e < e1, slot_at(e0 + st_e), geo, qcol,
                  dcol, Ktot, B, dst_col);
  int sl_nxt = slot_at(e0 + E + st_e);

  // the padded slots of destination column col: 0 in every channel, its
  // G ranges taking every G-th run of NTH slots
  for (int k = grow * NTH + tid; k < Ktot; k += G * NTH)
    if (qcol[(size_t)col * Ktot + k] < 0)
      for (int c = 0; c < nch; ++c)
        ggeo[((size_t)col * nch + c) * Ktot + k] = 0.f;

  // the fold's open source row and the first row of the range not yet
  // written (the same in every thread; each feature's sum in s_racc)
  int run = -1, next = r0;
  for (int base = e0, it = 0; base < e1; base += E, ++it) {
    const int buf = it & 1, n = min(E, e1 - base);
    const float* phi = ch.phi + buf * E * ch.ldp;
    const float* fc = ch.fc + buf * E;
    const int* ks = ch.k + buf * E;
    const int* cs = ch.col + buf * E;
    const int* qs = ch.q + buf * E;
    const int* ds = ch.d + buf * E;
    // channel c of the chunk's slot r in geo and ggeo
    auto at = [&](int r, int c) {
      return ((size_t)cs[r] * nch + c) * Ktot + ks[r];
    };
    cp_async_wait<0>();
    sync();  // (A) this chunk staged; the last one done with every tile
    if (base + E < e1) {  // the next chunk's loads run under this one
      cfg_stage<kScr>(ch, buf ^ 1, tid, base + E + st_e < e1, sl_nxt, geo,
                      qcol, dcol, Ktot, B, dst_col);
      sl_nxt = slot_at(base + 2 * E + st_e);
    }
    // P1: z1 -> h1 = ssp(z1) and sigmoid(z1), from one exp(-|z|) by the
    // fast intrinsics (the tuned K10's epilogue)
    cfg_mma<NW, false, kWide>(phi, ch.ldp, w1, ldw, Bp, Fp,
                       [&](int r, int f, float v) {
                         const float z = v + __ldg(b1p + f);
                         const float ez = __expf(-fabsf(z));
                         H1[r * LDF + f] =
                             fmaxf(z, 0.f) + __logf(1.f + ez) - kLn2g;
                         const float inv = __fdividef(1.f, 1.f + ez);
                         SG[r * LDF + f] = z >= 0.f ? inv : ez * inv;
                       });
    sync();  // (B)
    // P2: pre = h1 W2 + b2
    cfg_mma<NW, false, kWide>(H1, LDF, w2, ldw, Fp, Fp,
                              [&](int r, int f, float v) {
                                PR[r * LDF + f] = v + __ldg(b2p + f);
                              });
    // E1's operands, kE1 (slot, feature) pairs i = tid + k NTH a thread at
    // a time: the destination rows' cotangents and the source rows (the
    // first batch loaded before the barrier, landing under it)
    float gm[kCfE1], hv[kCfE1];
    auto e1_load = [&](int k0) {
#pragma unroll
      for (int j = 0; j < kCfE1; ++j) {
        const int i = tid + (k0 + j) * NTH, e = i / Fp, f = i - e * Fp;
        const bool ok = e < n && f < F;
        gm[j] = ok ? __ldg(g + ((size_t)cs[e] * P + ds[e]) * F + f) : 0.f;
        hv[j] = ok ? __ldg(h + (row0 + qs[e]) * F + f) : 0.f;
      }
    };
    e1_load(0);
    sync();  // (C)
    // E1: per (slot, feature) ghj, gpre over pre, and gW pre's warp sums
    // (a warp's 32 lanes: 32 features of one slot), the Fp / 32 partials of
    // gfcut; rows past the chunk's slots get zeros
    const int npair = E * Fp / NTH;
    for (int k0 = 0; k0 < npair; k0 += kCfE1) {
#pragma unroll
      for (int j = 0; j < kCfE1; ++j) {
        if (k0 + j >= npair) break;
        const int i = tid + (k0 + j) * NTH, e = i / Fp, f = i - e * Fp;
        float* pr = PR + e * LDF + f;
        const float p = *pr, gw = gm[j] * hv[j], fce = fc[e];
        GH[e * LDF + f] = __fmul_rn(gm[j] * p, fce);
        *pr = gw * fce;
        const float s = warp_sum(gw * p);
        if ((tid & 31) == 0) s_gfc[e * kQ + (f >> 5)] = s;
      }
      if (k0 + kCfE1 < npair) e1_load(k0 + kCfE1);
    }
    sync();  // (D)
    if (tid < n) {  // gfcut and the dir channels of the chunk's slots
      float s = 0.f;
      for (int qq = 0; qq < kQ; ++qq) s += s_gfc[tid * kQ + qq];
      float* o = ggeo + at(tid, B);
      o[0] = s;
      o[Ktot] = 0.f;
      o[2 * (size_t)Ktot] = 0.f;
      o[3 * (size_t)Ktot] = 0.f;
    }
    // the fold of ghj onto the source rows, feature f's open sum in slot
    // order (stored once when its row's run ends), and gb2
    for (int f = tid; f < F; f += NTH) {
      int rn = run, nx = next;
      float acc = s_racc[f], gb2 = 0.f;
      for (int e = 0; e < n; ++e) {
        const int qe = qs[e];
        if (qe != rn) {  // the run of row rn ended
          if (rn >= 0) {
            dh[(row0 + rn) * F + f] = acc;
            nx = rn + 1;
          }
          for (; nx < qe; ++nx) dh[(row0 + nx) * F + f] = 0.f;
          rn = qe;
          acc = 0.f;
        }
        acc += GH[e * LDF + f];
        if constexpr (kWgrad) gb2 += PR[e * LDF + f];
      }
      s_racc[f] = acc;
      if constexpr (kWgrad) s_gb2[f] += gb2;
    }
    for (int e = 0; e < n; ++e) {  // every thread follows the runs
      const int qe = qs[e];
      if (qe != run) run = next = qe;
    }
    // P3: gh1 = gpre W2^T; gz1 = gh1 sigmoid(z1) over sigmoid(z1)
    cfg_mma<NW, true, kWide>(PR, LDF, w2, ldw, Fp, Fp,
                             [&](int r, int f, float v) {
                               float* sg = SG + r * LDF + f;
                               *sg = v * *sg;
                             });
    if constexpr (kWgrad)  // gW2 += h1^T gpre
      cfg_acc_tn<NW>(H1, LDF, Fp, PR, LDF, Fp, S + (size_t)MP * LDS, LDS);
    sync();  // (E) gz1 complete
    // P4: gphi = gz1 W1^T at the slots' channels b < B
    cfg_mma<NW, true, kWide>(SG, LDF, w1, ldw, Fp, Bp,
                             [&](int r, int b, float v) {
                               if (b < B && r < n) ggeo[at(r, b)] = v;
                             });
    if constexpr (kWgrad)  // [gW1; gb1] += [phi | 1]^T gz1
      cfg_acc_tn<NW>(phi, ch.ldp, MP, SG, LDF, Fp, S, LDS);
  }
  for (int f = tid; f < F; f += NTH) {  // close the last run; then zeros
    int r = next;
    if (run >= 0) {
      dh[(row0 + run) * F + f] = s_racc[f];
      r = run + 1;
    }
    for (; r < r1; ++r) dh[(row0 + r) * F + f] = 0.f;
  }
  if constexpr (kWgrad) {  // the group's partial [gW1 | gb1 | gW2 | gb2]
    sync();  // every product is in the sums
    if (own_sums)
      for (int t = tid; t < (MP + Fp) * LDS; t += NTH) wout[t] = S[t];
    for (int f = tid; f < LDS; f += NTH)
      wout[(size_t)(MP + Fp) * LDS + f] = f < Fp ? s_gb2[f] : 0.f;
  }
}

}  // namespace

// dynamic shared memory of the general K9 (mode 0), K10 (mode 1) or K10's
// wgrad instance (mode 2) at F filters and B basis functions, bytes a
// block: their plan's (cfg_plan), 0 where the group's tiles lie in global
// scratch (kScr)
extern "C" int spk_cf_gen_smem(int F, int B, int mode) {
  return (int)cfg_plan(F, B, mode == 2, optin_smem(), mode == 0).smem;
}

// K9's general instance: dsorted and grp the destination schedule of the
// nx * ny columns in G row ranges each; the padded weights W1p [Bp][Fp],
// b1p [Fp], W2p [Fp][Fp], b2p [Fp] (as K10's); out [A', F], every element
// written once; kept (as dsorted) the ranges' slots with fcut != 0, which
// the kernel writes and walks
extern "C" int spk_cf_fwd_gen(const float* h, const float* geo,
                              const float* W1p, const float* b1p,
                              const float* W2p, const float* b2p,
                              const int* qcol, const int* dcol,
                              const int* dsorted, const int* grp, float* out,
                              int nx, int ny, int P, int Ktot,
                              const int* koffs, int G, int B, int F,
                              int* kept, cudaStream_t stream) {
  if (F < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const CfgPlan pl = cfg_plan(F, B, false, optin_smem(), true);
  auto* kern = pl.scr   ? cf_fwd_gen_kernel<true, true>
               : pl.wsm ? cf_fwd_gen_kernel<false, false>
                        : cf_fwd_gen_kernel<true, false>;
  const cudaError_t err = allow_smem((const void*)kern);
  if (err != cudaSuccess) return (int)err;
  const int nv = nx * ny * G;
  const KOffs ko = make_koffs(koffs);
  auto run = [&](float* scr, int v0, int blocks) {
    kern<<<blocks, kCfNTH * pl.qg, pl.smem, stream>>>(
        h, geo, W1p, b1p, W2p, b2p, qcol, dcol, dsorted, grp, out, nx, ny, P,
        Ktot, ko, G, B, F, scr, v0, kept);
  };
  if (pl.scr)
    return (int)in_waves(
        nv, sizeof(float) * cff_group_floats(cfg_fp(F), B), stream, run);
  run(nullptr, 0, (nv + pl.qg - 1) / pl.qg);
  return (int)cudaGetLastError();
}

// K10's general instance: esorted and grp the source schedule; the padded
// weights W1p [Bp][Fp], b1p [Fp], W2p [Fp][Fp], b2p [Fp]; dh [A', F] and
// ggeo [nx, ny, B+4, Ktot], every element written once; wpart [nx * ny *
// G][MP + Fp + 1][Fp + 8] f32 (the wgrad instance: each row range's
// [gW1 | gb1 | 0; gW2; gb2], filled by the kernel) or null
extern "C" int spk_cf_bwd_gen(const float* h, const float* geo,
                              const float* W1p, const float* b1p,
                              const float* W2p, const float* b2p,
                              const int* qcol, const int* dcol,
                              const int* esorted, const int* grp,
                              const float* g, float* dh, float* ggeo,
                              float* wpart, int nx, int ny, int P, int Ktot,
                              int G, int B, int F, cudaStream_t stream) {
  if (F < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const bool w = wpart != nullptr;
  const CfgPlan pl = cfg_plan(F, B, w, optin_smem());
  auto* kern = pl.scr ? (w ? cf_bwd_gen_kernel<true, true, true>
                           : cf_bwd_gen_kernel<false, true, true>)
               : w ? (pl.wsm ? cf_bwd_gen_kernel<true, false, false>
                             : cf_bwd_gen_kernel<true, true, false>)
                   : (pl.wsm ? cf_bwd_gen_kernel<false, false, false>
                             : cf_bwd_gen_kernel<false, true, false>);
  const cudaError_t err = allow_smem((const void*)kern);
  if (err != cudaSuccess) return (int)err;
  const int nv = nx * ny * G;
  auto run = [&](float* scr, int v0, int blocks) {
    kern<<<blocks, kCfNTH * pl.qg, pl.smem, stream>>>(
        h, geo, W1p, b1p, W2p, b2p, qcol, dcol, esorted, grp, g, dh, ggeo,
        wpart, nx * ny, P, Ktot, G, B, F, pl.ssm, scr, v0);
  };
  if (pl.scr)
    return (int)in_waves(
        nv, sizeof(float) * cfg_group_floats(cfg_fp(F), B, w, false), stream,
        run);
  run(nullptr, 0, (nv + pl.qg - 1) / pl.qg);
  return (int)cudaGetLastError();
}
