// SchNet continuous-filter convolution on the column layout for Hopper
// (sm_90a), f32.
//
// K9 cf_fwd_kernel<F> replaces the TPU kernel
//   schnetpack_tpu/ops/schnet_columns.py:79 _cf_fwd_kernel
//   (launcher :118 _cf_fwd_call).
// K10 cf_bwd_kernel<W, F> replaces
//   schnetpack_tpu/ops/schnet_columns.py:145 _cf_bwd_kernel (launcher :225
//   _cf_bwd_call): dh and the geometry cotangent ggeo, and in its wgrad
//   instance (W = true) also the filter-weight cotangents gW1 [B, F], gb1,
//   gW2 [F, F] and gb2 (``schnet_columns.py:191-205``).
//
// Per edge slot (source row j, destination row i, raw-phi geometry
// [phi (B), fcut, dir (3)] from colblock_geo.cu in its raw form):
//   z1  = phi W1 + b1            [F]   W1 [B, F]
//   h1  = ssp(z1)                      ssp(z) = softplus(z) - ln 2
//   pre = h1 W2 + b2             [F]   W2 [F, F]
//   out_i += h_j * pre * fcut
// and the VJP for the cotangent g of out:
//   gmsg = g_i; ghj = gmsg pre fcut (folded onto h_j); gW = gmsg h_j;
//   gfcut = sum_f gW pre; gpre = gW fcut; gh1 = gpre W2^T;
//   gz1 = gh1 sigmoid(z1); gphi = gz1 W1^T; ggeo = [gphi, gfcut, 0, 0, 0].
//
// Layout as in colblock_message.cu (slot k of column (i, j) in bucket c9,
// source row qcol of column ((i+dx) mod nx, (j+dy) mod ny), destination
// row dcol of column (i, j)).  Both kernels take F = 64 or 128 filters
// (the template argument) and B <= 32 basis functions.
//
// What bounds them on the H100: the filter MLP.  Per edge it is B*F + F*F
// FMAs forward and twice that backward (~19k and ~38k at F = 128, B = 20),
// against a few hundred bytes of loads: bound by arithmetic, which both
// run on the tensor cores in 3xTF32 (tf32_mma.cuh, rows_mma: each k-step's
// products in a fresh fragment added to an f32 sum).
//
// Both walk row ranges of a schedule (ops/colblock.py), the real slots
// sorted by a row and each column's rows cut into G ranges of about equal
// edge count: a range (col, g) owns the rows [r0, r1) of column col and
// their slots sorted[e0, e1) (``grp[col][g]`` = (r0, e0), ``grp[col][g+1]``
// = (r1, e1)).  K9 runs on the destination schedule (K1's,
// ``destination_schedule``: slots by destination row, in slot order within
// a row; ops/schnet_columns.py::FWD_RANGES ranges a column), K10 on the
// source schedule (the message backward's, ``source_schedule``: by source
// row; BWD_RANGES, WGRAD_RANGES).  Per chunk of kE = 16 slots (one m16
// tile), staged by cp.async into the other of two buffers while the chunk
// before runs (``stage``: the basis rows phi [E][B] with a column of ones
// at B, which the zero row B of the padded W1 ignores and which makes the
// wgrad product's row B the bias cotangent gb1; fcut, qcol, dcol):
//   P1  z1 = phi W1 + b1: h1 = ssp(z1) (and sigmoid(z1) for K10) in the
//       epilogue;
//   P2  pre = h1 W2 + b2;
// then K9:
//   the fold: thread f reads feature f of the chunk's source rows from L2
//       (the h table, A' x F floats, stays there; the loads are issued
//       before P1 and land under it), walks the chunk's slots in order and
//       sums h_j pre fcut for the open destination row in a register,
//       stored once when the row's run ends (rows without a slot get 0):
//       every row of [r0, r1) is written exactly once, with no [P][F]
//       sums, no zero fill and no atomics, so K9 takes any P.
//       A slot's source row is qcol in the column of its bucket
//       (``bucket_of``);
// and K10 (no bucket: a slot's source row is qcol in the range's column):
//   E1  per (slot, feature), the destination row's cotangent and the
//       source row read from L2: ghj, gpre (over pre) and gW pre, whose
//       sum over the features (warp shuffles, then the warps' partials in
//       a fixed order) is gfcut;
//   the fold of ghj onto the source rows, as K9's;
//   P3  gh1 = gpre W2^T, gz1 = gh1 sigmoid(z1) in the epilogue;
//   P4  gphi = gz1 W1^T, written at the slot's ggeo channels b < B.
// A chunk is one m16 tile and the warps split the F (P4: the padded B)
// columns.  Every real slot's ggeo is written by the range that owns its
// source row (gphi, gfcut, 0 in the dir channels); range (col, 0) writes 0
// at every channel of the padded slots of column col; so ggeo needs no
// fill.
//
// The block (measured on K10, scripts/time_cfconv_kernels.py, PERF.md):
// with 8 warps a block and the weights read through L1 from L2 the
// products were 2 n8-tiles a warp per k-step, too little work around each
// mma.sync and its splits.  So K9 and K10's plain instance run one block
// an SM of kGroups groups of kGroupWarps warps, each group a row range of
// its own with its own named barrier, sharing W2 and the padded W1 [Bp][F]
// (Bp = B+1 rounded up to 8) in shared memory (``load_weights``), read
// row-major in P1/P2 and as their transposes in P3/P4 (rows_mma's
// kWShared, kWSharedT): kNT n8-tiles a warp per k-step at F = 128, and the
// groups' phases interleave on the SM.  Shared memory holds the weights
// and each group's chunk tiles, whatever P is.
//
// K10's wgrad instance runs one group of 8 warps a block and adds per
// chunk gW2 += h1^T gpre and [gW1; gb1] += [phi | 1]^T gz1, 3xTF32
// products with both operands in shared memory (acc_tn below), whose chunk
// sums each thread adds to the elements of the block's f32 sums in shared
// memory that it alone owns; gb2 is summed per feature in registers.  At
// its end the block writes its sums to its own f64 partial, which the
// wrapper adds up: one writer per element and one order per sum, no
// atomics.

#include <cuda_runtime.h>

// KOffs, bucket_of, warp_sum; cp.async and rows_mma through it
#include "colblock_message.cuh"

namespace {

constexpr int kMaxB = 32;
constexpr float kLn2 = 0.69314718055994531f;

// Tuning constants (scripts/time_cfconv_kernels.py --set): slots a chunk
// (one m16 tile); K9's and K10's plain block, one an SM, runs kGroups
// groups of kGroupWarps warps, each group on a row range of its own,
// sharing the filter weights; its warps take kNT n8-tiles at a time in the
// F-wide products (fewer where F is narrower); K10's wgrad instance runs
// one group of kWgradWarps warps (kWgradNT)
constexpr int kE = 16;
constexpr int kGroups = 3;
constexpr int kGroupWarps = 4;
constexpr int kNT = 4;
constexpr int kWgradWarps = 8;
constexpr int kWgradNT = 2;

// an instance's groups a block, warps a group, n8-tiles a warp, threads a
// group, and the row strides of its [E][F] tiles (4 mod 32 floats) and of
// the wgrad sums (8 mod 32)
template <bool kWgrad, int F>
struct CfShape {
  static constexpr int QG = kWgrad ? 1 : kGroups;
  static constexpr int NW = kWgrad ? kWgradWarps : kGroupWarps;
  static constexpr int NT0 = kWgrad ? kWgradNT : kNT;
  static constexpr int NT = F / (8 * NW) < NT0 ? F / (8 * NW) : NT0;
  static constexpr int NTH = 32 * NW;
  static constexpr int LDF = F + 4, LDA = F + 8;
  static_assert(NT > 0 && NTH % F == 0 && NTH % kE == 0 &&
                    F % (8 * NT * NW) == 0 && F % 32 == 0,
                "the cfconv kernels' constants");
};

// the padded basis width Bp (B + 1 rounded up to 8: the ones column at B)
// and the rows MP of the gW1 product (Bp rounded up to 16)
__host__ __device__ inline int cf_bp(int B) { return (B + 1 + 7) / 8 * 8; }
__host__ __device__ inline int cf_mp(int B) {
  return (cf_bp(B) + 15) / 16 * 16;
}

// Shared memory, floats (mode 0 K9, 1 K10, 2 K10's wgrad instance): W2
// [F][F+4] and W1 [Bp][F+4], shared by the block's groups; per group two
// buffers of the staged chunk (phi [E][MP+4], fcut [E] and four int arrays
// [E]), the tiles (K9: h1 and pre; K10:
// h1 (the plain instance's ghj over it), sigmoid(z1) -> gz1 and pre ->
// gpre; wgrad: a ghj tile too) [E][F+4] and K10's gfcut partials
// [E][F/32]; wgrad also the f32 sums gW2 [F][F+8] and [gW1; gb1]
// [MP][F+8]
__host__ __device__ inline size_t group_floats(int F, int B, int mode) {
  const int tiles = mode == 0 ? 2 : mode == 1 ? 3 : 4;
  return 2 * ((size_t)kE * (cf_mp(B) + 4) + 5 * kE) +
         (size_t)tiles * kE * (F + 4) + (mode ? (size_t)kE * (F / 32) : 0);
}

__host__ __device__ inline size_t smem_floats(int F, int B, int mode) {
  return (size_t)(F + cf_bp(B)) * (F + 4) +
         (mode == 2 ? group_floats(F, B, 2) + (size_t)(F + cf_mp(B)) * (F + 8)
                    : kGroups * group_floats(F, B, mode));
}

// the named barrier of a group of n threads
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// W2 [F][F] and W1 [B][F] into shared memory at row stride F + 4, W1
// padded with zero rows to Bp, for every group of the block
template <int F>
__device__ __forceinline__ void load_weights(const float* W1,
                                             const float* W2, int B, int Bp,
                                             float* W2s, float* W1s) {
  constexpr int ld = F + 4;
  for (int t = threadIdx.x; t < F * F; t += blockDim.x)
    W2s[(t / F) * ld + t % F] = __ldg(W2 + t);
  for (int t = threadIdx.x; t < Bp * F; t += blockDim.x)
    W1s[(t / F) * ld + t % F] = t < B * F ? __ldg(W1 + t) : 0.f;
  __syncthreads();
}

// A group's staged chunks: two buffers of kE slots each (slot i of buffer
// b at b * kE + i)
struct Chunk {
  float* phi;    // [2][E][ldp] phi | 1 | 0
  float* fc;     // [2][E] fcut
  int* k;        // [2][E] the slot in its (destination) column
  int* q;        // [2][E] qcol
  int* d;        // [2][E] dcol
  int* col;      // [2][E] K9: the source column; K10: the destination one
  int ldp;
};

// the group's chunk arrays from `base`; its tiles follow them, at col +
// 2 kE
__device__ __forceinline__ Chunk carve_chunk(float* base, int B) {
  Chunk c;
  c.ldp = cf_mp(B) + 4;
  c.phi = base;
  c.fc = c.phi + 2 * kE * c.ldp;
  c.k = reinterpret_cast<int*>(c.fc + 2 * kE);
  c.q = c.k + 2 * kE;
  c.d = c.q + 2 * kE;
  c.col = c.d + 2 * kE;
  return c;
}

// Stage slot s (``ok``: a real slot of the range; else zeros) at chunk
// position tid % kE of buffer b, by cp.async: the group's NTH threads
// take NTH / kE channels of each slot, and thread tid < kE also its fcut,
// qcol and dcol; the slot's k and ``col_of(its column, k)`` are stored as
// they are.
template <int NTH, class ColOf>
__device__ __forceinline__ void stage(const Chunk& c, int b, int tid,
                                      bool ok, int s, const float* geo,
                                      const int* qcol, const int* dcol,
                                      int Ktot, int B, ColOf col_of) {
  constexpr int kSt = NTH / kE;
  const int st_e = tid % kE, st_p = tid / kE;
  const int dc = s / Ktot, k = s - dc * Ktot;
  const size_t goff = (size_t)dc * (B + 4) * Ktot + k;
  float* ph = c.phi + (b * kE + st_e) * c.ldp;
  for (int ch = st_p; ch < c.ldp; ch += kSt) {
    if (ok && ch < B) cp_async4(ph + ch, geo + goff + (size_t)ch * Ktot);
    else ph[ch] = ok && ch == B ? 1.f : 0.f;
  }
  if (st_p == 0) {
    const int i = b * kE + st_e;
    if (ok) {
      cp_async4(c.fc + i, geo + goff + (size_t)B * Ktot);
      cp_async4(c.q + i, qcol + s);
      cp_async4(c.d + i, dcol + s);
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

// P1: z1 = phi W1 + b1 over the chunk's 16 rows -> H1 = ssp(z1) and, with
// kSig, SG = sigmoid(z1), both from one exp(-|z|) by the fast intrinsics
// (K10 with the exact functions: 0.040 of the tolerance against the
// float64 twin at the bench, 0.063 fast, 13% slower)
template <int F, int NT, int NW, bool kSig>
__device__ __forceinline__ void filter_p1(const float* phi, int ldp,
                                          const float* W1s, int Bp,
                                          const float* b1, float* H1,
                                          float* SG) {
  constexpr int ld = F + 4;
  const MmaSeg seg[1] = {{phi, ldp, 0, W1s, ld, Bp}};
  rows_mma<kE / 16, 1, NT, NW, false, kWShared>(
      seg, F, [&](int, int r, int f, float v) {
        const float z = v + __ldg(b1 + f), ez = __expf(-fabsf(z));
        H1[r * ld + f] = fmaxf(z, 0.f) + __logf(1.f + ez) - kLn2;
        if constexpr (kSig) {
          const float inv = __fdividef(1.f, 1.f + ez);
          SG[r * ld + f] = z >= 0.f ? inv : ez * inv;
        }
      });
}

// P2: PR = h1 W2 + b2 over the chunk's 16 rows
template <int F, int NT, int NW>
__device__ __forceinline__ void filter_p2(const float* H1, const float* W2s,
                                          const float* b2, float* PR) {
  constexpr int ld = F + 4;
  const MmaSeg seg[1] = {{H1, ld, 0, W2s, ld, F}};
  rows_mma<kE / 16, 1, NT, NW, false, kWShared>(
      seg, F, [&](int, int r, int f, float v) {
        PR[r * ld + f] = v + __ldg(b2 + f);
      });
}

template <int F>
__global__ void __launch_bounds__(32 * kGroupWarps * kGroups, 1)
cf_fwd_kernel(const float* __restrict__ h, const float* __restrict__ geo,
              const float* __restrict__ W1, const float* __restrict__ b1,
              const float* __restrict__ W2, const float* __restrict__ b2,
              const int* __restrict__ qcol, const int* __restrict__ dcol,
              const int* __restrict__ dsorted, const int* __restrict__ grp,
              float* __restrict__ out, int nx, int ny, int P, int Ktot,
              KOffs ko, int G, int B) {
  using S = CfShape<false, F>;
  constexpr int E = kE, NTH = S::NTH, LDF = S::LDF;
  extern __shared__ __align__(16) float smem[];
  const int Bp = cf_bp(B);
  float* W2s = smem;                  // [F][LDF]
  float* W1s = W2s + F * LDF;         // [Bp][LDF]
  load_weights<F>(W1, W2, B, Bp, W2s, W1s);
  // group q takes row range vb of the grid's nx * ny * G
  const int q = threadIdx.x / NTH, tid = threadIdx.x - q * NTH;
  const int vb = blockIdx.x * S::QG + q;
  if (vb >= nx * ny * G) return;
  const int col = vb / G, grow = vb - col * G;
  const int ci = col / ny, cj = col - ci * ny;
  auto sync = [&]() { group_sync(1 + q, NTH); };
  const Chunk ch = carve_chunk(W1s + Bp * LDF + q * group_floats(F, B, 0), B);
  float* H1 = reinterpret_cast<float*>(ch.col + 2 * E);  // [E][LDF] h1
  float* PR = H1 + E * LDF;           // [E][LDF] pre

  const int* gb = grp + ((size_t)col * (G + 1) + grow) * 2;
  const int r0 = gb[0], e0 = gb[1], r1 = gb[2], e1 = gb[3];
  // a slot of column col: the source column of its bucket
  auto src_col = [&](int, int k) {
    const int c9 = bucket_of(k, ko), c3 = c9 / 3;
    int si = ci + c3 - 1, sj = cj + c9 - 3 * c3 - 1;
    si += si < 0 ? nx : (si >= nx ? -nx : 0);
    sj += sj < 0 ? ny : (sj >= ny ? -ny : 0);
    return si * ny + sj;
  };
  const int st_e = tid % E;
  auto slot_at = [&](int e) { return e < e1 ? dsorted[e] : 0; };
  stage<NTH>(ch, 0, tid, e0 + st_e < e1, slot_at(e0 + st_e), geo, qcol,
             dcol, Ktot, B, src_col);
  int sl_nxt = slot_at(e0 + E + st_e);

  // the fold (threads tid < F, feature tid): the open destination row
  // `run`, its sum, and the first row of the range not yet written
  float* o = out + (size_t)col * P * F + tid;
  int run = -1, next = r0;
  float racc = 0.f;

  for (int base = e0, it = 0; base < e1; base += E, ++it) {
    const int buf = it & 1, n = min(E, e1 - base);
    cp_async_wait<0>();
    sync();  // (A) this chunk staged; the last one's fold done with PR
    if (base + E < e1) {  // the next chunk's loads run under this one
      stage<NTH>(ch, buf ^ 1, tid, base + E + st_e < e1, sl_nxt, geo, qcol,
                 dcol, Ktot, B, src_col);
      sl_nxt = slot_at(base + 2 * E + st_e);
    }
    const int* cs = ch.col + buf * E;
    const int* qs = ch.q + buf * E;
    float hv[E];  // feature tid of the slots' source rows, from L2
    if (tid < F) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        hv[e] = e < n ? __ldg(h + ((size_t)cs[e] * P + qs[e]) * F + tid)
                      : 0.f;
    }
    filter_p1<F, S::NT, S::NW, false>(ch.phi + buf * E * ch.ldp, ch.ldp, W1s,
                                      Bp, b1, H1, nullptr);
    sync();  // (B)
    filter_p2<F, S::NT, S::NW>(H1, W2s, b2, PR);
    sync();  // (C)
    if (tid < F) {  // the fold onto the destination rows, in slot order
      const float* fc = ch.fc + buf * E;
      const int* ds = ch.d + buf * E;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e >= n) break;
        const int d = ds[e];
        if (d != run) {
          if (run >= 0) {
            o[(size_t)run * F] = racc;
            next = run + 1;
          }
          for (; next < d; ++next) o[(size_t)next * F] = 0.f;
          run = d;
          racc = 0.f;
        }
        racc += hv[e] * (PR[e * LDF + tid] * fc[e]);
      }
    }
  }
  if (tid < F) {  // close the last run; rows after it get 0
    if (run >= 0) {
      o[(size_t)run * F] = racc;
      next = run + 1;
    }
    for (; next < r1; ++next) o[(size_t)next * F] = 0.f;
  }
}

// out[m][n] += sum_e A[e][m] Bm[e][n] over a chunk's E slots, for M rows
// (M % 16 == 0) and N = F columns, A and Bm in shared memory (row
// strides lda, ldb): the wgrad instance's products.  The warps take (m16
// tile, NG n8-tiles) items in turn; per k-step of 8 slots the A fragment
// is split once for the NG tiles, the three products of each tile go
// into a fresh fragment added to the chunk's f32 sum, which the thread
// then adds to its own elements of out (row stride F + 8).
template <int F, int E, int NG, int NW>
__device__ __forceinline__ void acc_tn(const float* A, int lda, int M,
                                       const float* Bm, int ldb,
                                       float* out) {
  constexpr int ldo = F + 8;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & (NW - 1);
  const int gid = lane >> 2, tig = lane & 3;
  constexpr int ng = F / (8 * NG);
  const int items = (M / 16) * ng;
  for (int it = warp; it < items; it += NW) {
    const int m0 = (it / ng) * 16, n0 = (it % ng) * 8 * NG;
    float acc[NG][4] = {};
#pragma unroll
    for (int k = 0; k < E; k += 8) {
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
      float* o = out + (m0 + gid) * ldo + n0 + 8 * j + 2 * tig;
      o[0] += acc[j][0];
      o[1] += acc[j][1];
      o[8 * ldo] += acc[j][2];
      o[8 * ldo + 1] += acc[j][3];
    }
  }
}

template <bool kWgrad, int F>
__global__ void __launch_bounds__(32 * CfShape<kWgrad, F>::NW *
                                      CfShape<kWgrad, F>::QG, 1)
cf_bwd_kernel(const float* __restrict__ h, const float* __restrict__ geo,
              const float* __restrict__ W1, const float* __restrict__ b1,
              const float* __restrict__ W2, const float* __restrict__ b2,
              const int* __restrict__ qcol, const int* __restrict__ dcol,
              const int* __restrict__ esorted, const int* __restrict__ grp,
              const float* __restrict__ g, float* __restrict__ dh,
              float* __restrict__ ggeo, double* __restrict__ wpart,
              int ncol, int P, int Ktot, int G, int B) {
  using S = CfShape<kWgrad, F>;
  constexpr int E = kE, RT = E / 16, NW = S::NW, NTH = S::NTH;
  constexpr int LDF = S::LDF, LDA = S::LDA, kQ = F / 32;
  constexpr int kPh = NTH / F;  // row phases of the per-feature passes
  extern __shared__ __align__(16) float smem[];
  const int Bp = cf_bp(B), MP = cf_mp(B), nch = B + 4;
  float* W2s = smem;                  // [F][LDF]
  float* W1s = W2s + F * LDF;         // [Bp][LDF]
  load_weights<F>(W1, W2, B, Bp, W2s, W1s);
  // group q takes row range vb of the grid's ncol * G
  const int q = threadIdx.x / NTH, tid = threadIdx.x - q * NTH;
  const int vb = blockIdx.x * S::QG + q;
  if (vb >= ncol * G) return;
  const int col = vb / G, grow = vb - col * G;
  auto sync = [&]() { group_sync(1 + q, NTH); };

  const Chunk ch =
      carve_chunk(W1s + Bp * LDF + q * group_floats(F, B, kWgrad ? 2 : 1), B);
  float* H1 = reinterpret_cast<float*>(ch.col + 2 * E);  // [E][LDF] h1
  float* SG = H1 + E * LDF;           // sigmoid(z1) -> gz1
  float* PR = SG + E * LDF;           // pre -> gpre
  float* GH = kWgrad ? PR + E * LDF : H1;  // ghj (h1 is dead by then)
  float* s_gfc = PR + (kWgrad ? 2 : 1) * E * LDF;  // [E][kQ]
  float* GW2 = s_gfc + E * kQ;        // wgrad [F][LDA]
  float* GW1 = GW2 + F * LDA;         // [MP][LDA]

  const int* gb = grp + ((size_t)col * (G + 1) + grow) * 2;
  const int r0 = gb[0], e0 = gb[1], r1 = gb[2], e1 = gb[3];
  const size_t row0 = (size_t)col * P;  // the column's first row of h, dh
  auto dst_col = [](int dc, int) { return dc; };
  const int st_e = tid % E;
  auto slot_at = [&](int e) { return e < e1 ? esorted[e] : 0; };
  stage<NTH>(ch, 0, tid, e0 + st_e < e1, slot_at(e0 + st_e), geo, qcol,
             dcol, Ktot, B, dst_col);
  int sl_nxt = slot_at(e0 + E + st_e);

  // the padded slots of destination column col: 0 in every channel
  if (grow == 0)
    for (int k = tid; k < Ktot; k += NTH)
      if (qcol[(size_t)col * Ktot + k] < 0)
        for (int c = 0; c < nch; ++c)
          ggeo[((size_t)col * nch + c) * Ktot + k] = 0.f;
  if constexpr (kWgrad)
    for (int t = tid; t < (F + MP) * LDA; t += NTH) GW2[t] = 0.f;

  // the fold (threads tid < F, feature tid): the open source row `run`,
  // its sum, and the first row of the range not yet written
  int run = -1, next = r0;
  float racc = 0.f;
  float gb2 = 0.f;  // wgrad: feature tid % F of gpre, this thread's rows
  const int ef = tid & (F - 1), eph = tid / F;  // E1: feature, row phase

  for (int base = e0, it = 0; base < e1; base += E, ++it) {
    const int buf = it & 1, n = min(E, e1 - base);
    const float* phi = ch.phi + buf * E * ch.ldp;
    const float* fc = ch.fc + buf * E;
    const int* ks = ch.k + buf * E;
    const int* cs = ch.col + buf * E;
    const int* qs = ch.q + buf * E;
    // channel c of the chunk's slot r in geo and ggeo
    auto at = [&](int r, int c) {
      return ((size_t)cs[r] * nch + c) * Ktot + ks[r];
    };
    cp_async_wait<0>();
    sync();  // (A) this chunk staged; the last one done with every tile
    if (base + E < e1) {  // the next chunk's loads run under this one
      stage<NTH>(ch, buf ^ 1, tid, base + E + st_e < e1, sl_nxt, geo, qcol,
                 dcol, Ktot, B, dst_col);
      sl_nxt = slot_at(base + 2 * E + st_e);
    }
    filter_p1<F, S::NT, NW, true>(phi, ch.ldp, W1s, Bp, b1, H1, SG);
    sync();  // (B)
    filter_p2<F, S::NT, NW>(H1, W2s, b2, PR);
    // E1's operands, loaded before the barrier: the destination rows'
    // cotangents and the source rows
    float gm[E / kPh], hj[E / kPh];
#pragma unroll
    for (int m = 0; m < E / kPh; ++m) {
      const int e = eph + kPh * m, i = buf * E + e;
      const bool ok = e < n;
      gm[m] = ok ? __ldg(g + ((size_t)cs[e] * P + ch.d[i]) * F + ef)
                 : 0.f;
      hj[m] = ok ? __ldg(h + (row0 + qs[e]) * F + ef) : 0.f;
    }
    sync();  // (C)
    // E1: thread (ef, eph) takes feature ef of the rows eph, eph + kPh, ...
#pragma unroll
    for (int m = 0; m < E / kPh; ++m) {
      const int e = eph + kPh * m;
      float* pr = PR + e * LDF + ef;
      const float p = *pr, gw = gm[m] * hj[m], gp = gw * fc[e];
      GH[e * LDF + ef] = gm[m] * p * fc[e];
      *pr = gp;
      if constexpr (kWgrad) gb2 += gp;
      const float s = warp_sum(gw * p);
      if ((tid & 31) == 0) s_gfc[e * kQ + (ef >> 5)] = s;
    }
    sync();  // (D)
    if (tid < n) {  // gfcut and the dir channels of the chunk's slots
      float s = 0.f;
#pragma unroll
      for (int qq = 0; qq < kQ; ++qq) s += s_gfc[tid * kQ + qq];
      float* o = ggeo + at(tid, B);
      o[0] = s;
      o[Ktot] = 0.f;
      o[2 * (size_t)Ktot] = 0.f;
      o[3 * (size_t)Ktot] = 0.f;
    }
    if (tid < F) {  // the fold of ghj onto the source rows, in slot order
      float v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = GH[e * LDF + tid];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e >= n) break;
        const int qe = qs[e];
        if (qe != run) {
          if (run >= 0) {
            dh[(row0 + run) * F + tid] = racc;
            next = run + 1;
          }
          for (; next < qe; ++next) dh[(row0 + next) * F + tid] = 0.f;
          run = qe;
          racc = 0.f;
        }
        racc += v[e];
      }
    }
    {  // P3: gh1 = gpre W2^T; gz1 = gh1 sigmoid(z1) over sigmoid(z1)
      const MmaSeg seg[1] = {{PR, LDF, 0, W2s, LDF, F}};
      rows_mma<RT, 1, S::NT, NW, false, kWSharedT>(
          seg, F, [&](int, int r, int f, float v) {
            float* sg = SG + r * LDF + f;
            *sg = v * *sg;
          });
    }
    if constexpr (kWgrad)  // gW2 += h1^T gpre
      acc_tn<F, E, 4, NW>(H1, LDF, F, PR, LDF, GW2);
    sync();  // (E) gz1 complete
    {  // P4: gphi = gz1 W1^T at the slots' channels b < B
      const MmaSeg seg[1] = {{SG, LDF, 0, W1s, LDF, F}};
      rows_mma<RT, 1, 1, NW, false, kWSharedT>(
          seg, Bp, [&](int, int r, int b, float v) {
            if (b < B && r < n) ggeo[at(r, b)] = v;
          });
    }
    if constexpr (kWgrad)  // [gW1; gb1] += [phi | 1]^T gz1
      acc_tn<F, E, 4, NW>(phi, ch.ldp, MP, SG, LDF, GW1);
  }
  if (tid < F) {  // close the last run; rows after it get 0
    if (run >= 0) {
      dh[(row0 + run) * F + tid] = racc;
      next = run + 1;
    }
    for (; next < r1; ++next) dh[(row0 + next) * F + tid] = 0.f;
  }
  if constexpr (kWgrad) {  // this block's partial [gW1 | gb1 | gW2 | gb2]
    sync();  // every product is in the sums
    double* pw = wpart + ((size_t)col * G + grow) *
                             ((size_t)(B + 2) * F + F * F);
    for (int t = tid; t < (B + 1) * F; t += NTH)
      pw[t] = GW1[(t / F) * LDA + t % F];
    for (int t = tid; t < F * F; t += NTH)
      pw[(B + 1) * F + t] = GW2[(t / F) * LDA + t % F];
    H1[eph * LDF + ef] = gb2;  // kPh <= E rows, free now
    sync();
    if (tid < F) {
      float s = 0.f;
      for (int p = 0; p < kPh; ++p) s += H1[p * LDF + tid];
      pw[(B + 1) * F + F * F + tid] = s;
    }
  }
}

// opt in to `smem` bytes of dynamic shared memory
template <typename K>
int set_smem(K kernel, size_t smem) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool takes(int F, int B) { return (F == 64 || F == 128) && B <= kMaxB; }

}  // namespace

// dynamic shared memory of K9 (mode 0), K10 (mode 1) or K10's wgrad
// instance (mode 2) at F filters and B basis functions, bytes a block;
// none depends on the column capacity P
extern "C" int spk_cf_smem_bytes(int F, int B, int mode) {
  return (int)(smem_floats(F, B, mode) * sizeof(float));
}

// dsorted and grp the destination schedule of the nx * ny columns in G row
// ranges each
extern "C" int spk_cf_fwd(const float* h, const float* geo, const float* W1,
                          const float* b1, const float* W2, const float* b2,
                          const int* qcol, const int* dcol,
                          const int* dsorted, const int* grp, float* out,
                          int nx, int ny, int P, int Ktot, const int* koffs,
                          int G, int B, int F, cudaStream_t stream) {
  if (!takes(F, B)) return (int)cudaErrorInvalidValue;
  auto* kern = F == 64 ? cf_fwd_kernel<64> : cf_fwd_kernel<128>;
  const size_t smem = spk_cf_smem_bytes(F, B, 0);
  const int err = set_smem(kern, smem);
  if (err) return err;
  kern<<<(nx * ny * G + kGroups - 1) / kGroups, 32 * kGroupWarps * kGroups,
         smem, stream>>>(h, geo, W1, b1, W2, b2, qcol, dcol, dsorted, grp,
                         out, nx, ny, P, Ktot, make_koffs(koffs), G, B);
  return (int)cudaGetLastError();
}

// esorted and grp the source schedule of the nx * ny columns in G row
// ranges each; wpart [nx * ny * G][(B+2) F + F F] f64 (the wgrad
// instance) or null
extern "C" int spk_cf_bwd(const float* h, const float* geo, const float* W1,
                          const float* b1, const float* W2, const float* b2,
                          const int* qcol, const int* dcol,
                          const int* esorted, const int* grp, const float* g,
                          float* dh, float* ggeo, double* wpart, int nx,
                          int ny, int P, int Ktot, int G, int B, int F,
                          cudaStream_t stream) {
  if (!takes(F, B)) return (int)cudaErrorInvalidValue;
  const bool w = wpart != nullptr;
  auto* kern = w ? (F == 64 ? cf_bwd_kernel<true, 64>
                            : cf_bwd_kernel<true, 128>)
                 : (F == 64 ? cf_bwd_kernel<false, 64>
                            : cf_bwd_kernel<false, 128>);
  const int qg = w ? 1 : kGroups, nw = w ? kWgradWarps : kGroupWarps;
  const size_t smem = spk_cf_smem_bytes(F, B, w ? 2 : 1);
  const int err = set_smem(kern, smem);
  if (err) return err;
  const int ncol = nx * ny;
  kern<<<(ncol * G + qg - 1) / qg, 32 * nw * qg, smem, stream>>>(
      h, geo, W1, b1, W2, b2, qcol, dcol, esorted, grp, g, dh, ggeo, wpart,
      ncol, P, Ktot, G, B);
  return (int)cudaGetLastError();
}
