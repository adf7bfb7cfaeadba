// Generic row selection on the column layout for Hopper (sm_90a), f32: the
// gather of source rows, its VJP, the expand of destination rows and the
// per-destination fold; and the 27-cell layout's gather and its VJP, which
// are the gather and its VJP on that layout's stack view.
//
// K11 select_kernel<kGather> (narrow rows: select_narrow_kernel<kGather>)
//   replaces schnetpack_tpu/ops/colblock_pallas.py:121 _gather_fwd_kernel
//   (launchers :130 _gather_fwd_call and, on halo slabs, colblock_shard.py:131
//   _gather_hx_call);
// K12 row_sum_kernel (narrow rows: row_sum_narrow_kernel) replaces :148
//   _gather_bwd_kernel (launchers :163 _gather_bwd_call, folded by :92
//   _fold_partials, and colblock_shard.py:154 _gather_hx_bwd_call, folded by
//   :182 _fold_partials_hx);
// K13 select_kernel<kExpand> (narrow rows: select_narrow_kernel<kExpand>)
//   replaces :211 _expand_fwd_kernel (launcher :226 _expand_call), which is
//   also the fold's VJP;
// K14 row_sum_kernel (narrow rows: row_sum_narrow_kernel) replaces :244
//   _fold_fwd_kernel (launcher :259 _fold_call), which is also the expand's
//   VJP: K12's body on the slots sorted by destination;
// K16 select_narrow_kernel<kCellGather> (wide rows: select_kernel<
//   kCellGather>) replaces schnetpack_tpu/ops/cellblock_pallas.py:88
//   _fwd_kernel (launcher :117 cell_gather_fwd_pallas, pallas_call :128);
// K17 row_sum_narrow_kernel (wide rows: row_sum_kernel) replaces :143
//   _bwd_kernel (launcher :176 cell_gather_bwd_pallas, pallas_call :186,
//   folded by the rolls at :207-213): K12's body on the 27-cell layout's
//   slots sorted by source row.
//
// Layout as in colblock_message.cu: slot k of column (x, y) lies in bucket
// c9 (koffs[c9] <= k < koffs[c9+1]); its source is row qcol of column
// ((x + c9/3 - 1) mod nx, (y + c9%3 - 1) mod ny), its destination row dcol
// of column (x, y); -1 marks a padded slot.  A table is [A', D] with
// A' = nx * ny * P, an edge tensor [nx, ny, Ktot, D], both row-major.  The
// 27-cell layout (cellblock.cuh) is a column layout of nx * ny stacks of
// P = nz * C rows and Ktot = nz * C * K slots, its edge tensor [A', K, D]
// byte for byte [nx, ny, Ktot, D]; a slot's code qidx names its bucket and
// its source row in the source stack (``CellStack::decode``).
//
//   K11  out[x, y, k] = table[j(x, y, k)]  (0 at padded slots)
//        and on a halo'd table (colblock_message.cu's source-index modes)
//        row qcol of column (x+dx+1, (y+dy) mod ny) of [nx+2, ny] columns
//        (halo_x) or (x+dx+1, y+dy+1) of [nx+2, ny+2] (halo_xy)
//   K12  dT[j] = sum of g[x, y, k] over the slots whose source is j (a
//        row of the halo'd table in the halo modes: the slot order is the
//        wrapper's, the kernel has no mode)
//   K13  out[x, y, k] = table[i(x, y, k)]  (0 at padded slots)
//   K14  out[i] = sum of v[x, y, k] over the slots whose destination is i
//   K16  out[a, k] = table[j(a, k)]  (0 where qidx is -1)
//   K17  dT[j] = sum of g[a, k] over the slots whose source is j
//
// The TPU kernels select with one-hot matrix products in bf16 pieces; here
// rows are read by index, exact in f32.  None does arithmetic beyond the
// sums, so all are bound by device-memory bytes: the edge tensor (~0.57 GB
// at D = 576 and the bench's 246k slots) is read or written once and the
// table once.  Designs:
//
// * K11 / K13 / K16 for wide rows (D % 4 == 0, or D >= 8) run one block per
//   (destination column, tile of slots); a block decodes each slot's row
//   from its own indices once, into shared memory, and threads copy
//   16-byte lanes (float4) when D % 4 == 0 and the pointers allow it, else
//   single floats.  The bucket of a slot comes from compares against the
//   offsets (``source_column``): a loop indexing them would copy them to
//   local memory in every thread, which cost K11 a quarter of its time at
//   D = 576.
// * K11 / K13 / K16 for narrow rows (D < 8, D % 4 != 0: the positions'
//   D = 3) move ~12 bytes a slot, so their time is fixed cost: one thread
//   per slot over a grid of (slot tile, y, x), which gives each thread its
//   column (K16: its stack) without a division.  The thread loads its
//   index (coalesced), finds its source column (K11: 8 compares against
//   the offsets held in registers; K16: ``CellStack::decode`` of its code
//   and the wrap of the bucket's offset, each offset on its own, so that
//   aliased grids of one or two cells along an axis stay exact), reads its
//   D floats through the read-only path and writes them: a warp stores
//   32 D contiguous floats.  No shared memory, no barrier; at the bench's
//   300k slots 1,200 blocks of 256, about one wave at 8 blocks an SM.
// * K12, K14 and K17 are one body: a sum of each row's run of sorted slots.
//   K12 and K17 walk the slots sorted by source row (the device sorts of
//   ``ops/colblock.py::source_order`` and ``ops/cellblock_gather.py::
//   source_order``, cached on the refs and shared with the message
//   backward), K14 those sorted by destination row (``destination_order``,
//   the message forward's order, also cached).  Padded slots (last in
//   every order) are never read; a row with no slot gets 0; no shared
//   memory, no atomics, any P, and the sums are deterministic.  For wide
//   rows each thread owns one (row, lane) (a float4 lane when D % 4 == 0
//   and the pointers allow it), sums that row's run in slot order in
//   registers and writes the row once.  For narrow rows (D < 8,
//   D % 4 != 0: ~18 slots a real row at D = 3) a thread a (row,
//   coordinate) would read each index D times in a chain of one dependent
//   load pair a slot, with a third of a wave in flight; there a group of
//   kRowLanes lanes owns a row, lane l takes every kRowLanes-th slot of
//   the run from the l-th, reads its index once and then its D floats,
//   and the group adds its partials by a butterfly of shuffles in a fixed
//   order.  4 lanes by measurement (scripts/time_fold_kernels.py --set,
//   at the MD runs' shapes on the H100): 2 to 8 lanes time within 0.0005
//   ms of each other on every layout, 16 and 32 lanes up to 0.0015 ms
//   slower, and blocks of 64 to 512 threads within 0.0002.  The TPU's 9
//   per-source-column partials of K12 and K17 would write and read back 9
//   tables more.

#include <cuda_runtime.h>

#include "cellblock.cuh"

// The select kernels' launch arguments that the layout fixes, made once
// per layout by the wrapper (``colblock_select.py::SelectArgs``,
// ``cellblock_gather.py::_select_args``): the column grid, the capacity,
// the slots per column, the bucket offsets, the source-index mode (hx, hy:
// 0, 0 wrap; 1, 0 halo_x; 1, 1 halo_xy) and the 27-cell layout's stacks
// (nz, C, K; nz = 0 on the column layout).
struct SelectArgs {
  int nx, ny, P, Ktot;
  int koffs[10];
  int hx, hy;
  int nz, C, K;
};

namespace {

constexpr int kThreads = 128;
constexpr int kSelectElems = 1024;   // vector elements per wide select block
constexpr int kNarrowThreads = 256;  // slots per narrow select block
constexpr int kNarrowMax = 8;        // widths below this may take it
constexpr int kRowLanes = 4;         // lanes of a narrow row-sum group

// what a select kernel copies (its template argument kMode)
constexpr int kExpand = 0;      // K13: the slot's destination row
constexpr int kGather = 1;      // K11: its source row, in a source-index mode
constexpr int kCellGather = 2;  // K16: its source row on the 27-cell layout

struct KOffs {
  int o[10];
};

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void add(T& a, const T& b) { a += b; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
};

// Column (x + dx, y + dy) in the source-index mode (hx, hy): the wrap by
// compare, not modulo, where the axis is not halo'd.
__device__ __forceinline__ int column_at(int x, int y, int nx, int ny, int dx,
                                         int dy, int hx, int hy) {
  int xs = x + dx + hx, ys = y + dy + hy;
  if (!hx) xs += xs < 0 ? nx : (xs >= nx ? -nx : 0);
  if (!hy) ys += ys < 0 ? ny : (ys >= ny ? -ny : 0);
  return xs * (ny + 2 * hy) + ys;
}

// The source column of slot k of destination column (x, y) in the
// source-index mode (hx, hy): the bucket c9 = 3 (dx + 1) + (dy + 1) from 8
// compares against the offsets, dx from the boundaries 3 and 6; no loop,
// so the offsets stay in registers.
__device__ __forceinline__ int source_column(int x, int y, int nx, int ny,
                                             int k, const KOffs& ko, int hx,
                                             int hy) {
  const int b1 = k >= ko.o[1], b2 = k >= ko.o[2], b3 = k >= ko.o[3];
  const int b4 = k >= ko.o[4], b5 = k >= ko.o[5], b6 = k >= ko.o[6];
  const int b7 = k >= ko.o[7], b8 = k >= ko.o[8];
  const int dx = b3 + b6 - 1;
  const int dy = b1 + b2 + b4 + b5 + b7 + b8 - 2 * (dx + 1) - 1;
  return column_at(x, y, nx, ny, dx, dy, hx, hy);
}

// The table row of slot k of column (x, y), whose index r >= 0 is its row
// in the source column (kGather), its own column (kExpand) or its code
// (kCellGather: the stack's slot k, decoded by ``CellStack::decode`` into
// a bucket, whose wrap-mode column is the source stack, and a row of it).
template <int kMode>
__device__ __forceinline__ int select_row(int x, int y, int nx, int ny,
                                          int P, int k, int r,
                                          const KOffs& ko, int hx, int hy,
                                          const CellStack& cs) {
  if constexpr (kMode == kCellGather) {
    int c9, src, dst;
    cs.decode(k, r, c9, src, dst);
    return column_at(x, y, nx, ny, c9 / 3 - 1, c9 % 3 - 1, 0, 0) * P + src;
  } else if constexpr (kMode == kGather) {
    return source_column(x, y, nx, ny, k, ko, hx, hy) * P + r;
  } else {
    return (x * ny + y) * P + r;
  }
}

// K11 / K13 / K16 for wide rows: one block per (slot tile, destination
// column).  The block first decodes each of its slots' table row into
// shared memory, then copies the rows lane by lane.
template <int kMode, int V>
__global__ void __launch_bounds__(kThreads)
    select_kernel(const float* __restrict__ table,
                  const int* __restrict__ idx, float* __restrict__ out,
                  int nx, int ny, int P, int Ktot, KOffs ko, int D,
                  int slots, int hx, int hy, CellStack cs) {
  using T = typename Vec<V>::T;
  __shared__ int rows[kSelectElems];   // table row of each slot, -1: pad
  const int col = blockIdx.y;
  const int x = col / ny, y = col - (col / ny) * ny;
  const int k0 = blockIdx.x * slots;
  const int ns = min(slots, Ktot - k0);
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const int k = k0 + s;
    const int r = idx[(size_t)col * Ktot + k];
    rows[s] = r >= 0 ? select_row<kMode>(x, y, nx, ny, P, k, r, ko, hx, hy,
                                         cs)
                     : -1;
  }
  __syncthreads();
  const int nvec = D / V;
  const T* tab = reinterpret_cast<const T*>(table);
  T* o = reinterpret_cast<T*>(out) + ((size_t)col * Ktot + k0) * nvec;
  for (int t = threadIdx.x; t < ns * nvec; t += blockDim.x) {
    const int s = t / nvec, v = t - s * nvec;
    const int row = rows[s];
    o[t] = row >= 0 ? tab[(size_t)row * nvec + v] : Vec<V>::zero();
  }
}

// K11 / K13 / K16 for narrow rows: thread k of block (kt, y, x) copies
// slot kt * 256 + k of column (x, y); kD the width (0: D, read at run
// time).
template <int kMode, int kD>
__global__ void __launch_bounds__(kNarrowThreads)
    select_narrow_kernel(const float* __restrict__ table,
                         const int* __restrict__ idx, float* __restrict__ out,
                         int nx, int P, int Ktot, KOffs ko, int D, int hx,
                         int hy, CellStack cs) {
  const int k = blockIdx.x * kNarrowThreads + threadIdx.x;
  if (k >= Ktot) return;
  const int y = blockIdx.y, x = blockIdx.z, ny = gridDim.y;
  const size_t slot = ((size_t)x * ny + y) * Ktot + k;
  const int w = kD ? kD : D;
  const int r = __ldg(idx + slot);
  float* o = out + slot * w;
  if (r < 0) {
#pragma unroll
    for (int d = 0; d < (kD ? kD : kNarrowMax); ++d)
      if (kD || d < w) o[d] = 0.f;
    return;
  }
  const float* row =
      table + (size_t)select_row<kMode>(x, y, nx, ny, P, k, r, ko, hx, hy,
                                        cs) * w;
  float v[kD ? kD : kNarrowMax];
#pragma unroll
  for (int d = 0; d < (kD ? kD : kNarrowMax); ++d)
    if (kD || d < w) v[d] = __ldg(row + d);
#pragma unroll
  for (int d = 0; d < (kD ? kD : kNarrowMax); ++d)
    if (kD || d < w) o[d] = v[d];
}

// K12 / K14 / K17 for wide rows: thread (row, lane) sums its row's run of
// sorted slots, sorted[rowptr[row]] .. sorted[rowptr[row + 1] - 1], in
// that order.
template <int V>
__global__ void __launch_bounds__(kThreads)
    row_sum_kernel(const float* __restrict__ g,
                   const int* __restrict__ sorted,
                   const int* __restrict__ rowptr, float* __restrict__ out,
                   int A, int D) {
  using T = typename Vec<V>::T;
  const int nvec = D / V;
  const T* gv = reinterpret_cast<const T*>(g);
  T* o = reinterpret_cast<T*>(out);
  const size_t total = (size_t)A * nvec;
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (size_t)gridDim.x * blockDim.x) {
    const int row = (int)(t / nvec), v = (int)(t - (size_t)row * nvec);
    T s = Vec<V>::zero();
    const int end = rowptr[row + 1];
    for (int p = rowptr[row]; p < end; ++p)
      Vec<V>::add(s, gv[(size_t)sorted[p] * nvec + v]);
    o[t] = s;
  }
}

// K12 / K14 / K17 for narrow rows: the kRowLanes lanes l of a group own
// row blockIdx.x * (kThreads / kRowLanes) + threadIdx.x / kRowLanes.  Lane
// l sums the slots rowptr[row] + l, + l + kRowLanes, ... of the row's run
// in that order, from 0, each index read once and then its D floats; the
// group adds its partials by a butterfly of __shfl_xor_sync at offsets
// kRowLanes / 2, ..., 1 (every lane ends with the same sums, as a + b ==
// b + a in f32), and lane l writes the elements d = l mod kRowLanes.  A
// row past A has an empty run and writes nothing, but its lanes shuffle
// with the warp.  kD the width (0: D, read at run time).
template <int kD>
__global__ void __launch_bounds__(kThreads)
    row_sum_narrow_kernel(const float* __restrict__ g,
                          const int* __restrict__ sorted,
                          const int* __restrict__ rowptr,
                          float* __restrict__ out, int A, int D) {
  constexpr int L = kRowLanes, N = kD ? kD : kNarrowMax;
  const int row = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const int l = threadIdx.x % L, w = kD ? kD : D;
  int p = 0, end = 0;
  if (row < A) {
    p = __ldg(rowptr + row) + l;
    end = __ldg(rowptr + row + 1);
  }
  float v[N];
#pragma unroll
  for (int d = 0; d < N; ++d) v[d] = 0.f;
  for (; p < end; p += L) {
    const float* src = g + (size_t)__ldg(sorted + p) * w;
#pragma unroll
    for (int d = 0; d < N; ++d)
      if (kD || d < w) v[d] += __ldg(src + d);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int d = 0; d < N; ++d)
      v[d] += __shfl_xor_sync(0xffffffffu, v[d], off);
  }
  if (row < A) {
    float* o = out + (size_t)row * w;
#pragma unroll
    for (int d = 0; d < N; ++d)
      if ((kD || d < w) && d % L == l) o[d] = v[d];
  }
}

bool aligned(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

KOffs offsets(const int* koffs) {
  KOffs ko;
  for (int i = 0; i < 10; ++i) ko.o[i] = koffs[i];
  return ko;
}

template <int kMode>
int launch_select(const float* table, const int* idx, float* out,
                  const SelectArgs& a, int D, int hx, int hy,
                  cudaStream_t stream) {
  const int nx = a.nx, ny = a.ny, P = a.P, Ktot = a.Ktot;
  const KOffs ko = offsets(a.koffs);
  const CellStack cs{a.nz, a.C, a.K};
  if (D % 4 != 0 && D < kNarrowMax) {
    const dim3 grid((Ktot + kNarrowThreads - 1) / kNarrowThreads, ny, nx);
    if (grid.x == 0) return 0;
    if (D == 3)
      select_narrow_kernel<kMode, 3><<<grid, kNarrowThreads, 0, stream>>>(
          table, idx, out, nx, P, Ktot, ko, D, hx, hy, cs);
    else if (D == 2)
      select_narrow_kernel<kMode, 2><<<grid, kNarrowThreads, 0, stream>>>(
          table, idx, out, nx, P, Ktot, ko, D, hx, hy, cs);
    else if (D == 1)
      select_narrow_kernel<kMode, 1><<<grid, kNarrowThreads, 0, stream>>>(
          table, idx, out, nx, P, Ktot, ko, D, hx, hy, cs);
    else
      select_narrow_kernel<kMode, 0><<<grid, kNarrowThreads, 0, stream>>>(
          table, idx, out, nx, P, Ktot, ko, D, hx, hy, cs);
    return (int)cudaGetLastError();
  }
  const bool vec = D % 4 == 0 && aligned(table) && aligned(out);
  const int nvec = vec ? D / 4 : D;
  int slots = kSelectElems / nvec;
  if (slots > Ktot) slots = Ktot;
  if (slots < 1) slots = 1;
  const dim3 grid((Ktot + slots - 1) / slots, nx * ny);
  if (grid.x == 0) return 0;
  if (vec)
    select_kernel<kMode, 4><<<grid, kThreads, 0, stream>>>(
        table, idx, out, nx, ny, P, Ktot, ko, D, slots, hx, hy, cs);
  else
    select_kernel<kMode, 1><<<grid, kThreads, 0, stream>>>(
        table, idx, out, nx, ny, P, Ktot, ko, D, slots, hx, hy, cs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spk_gather_fwd(const float* table, const int* qcol, float* out,
                              const SelectArgs* args, int D,
                              cudaStream_t stream) {
  return launch_select<kGather>(table, qcol, out, *args, D, args->hx,
                                args->hy, stream);
}

extern "C" int spk_expand_fwd(const float* table, const int* dcol, float* out,
                              const SelectArgs* args, int D,
                              cudaStream_t stream) {
  return launch_select<kExpand>(table, dcol, out, *args, D, 0, 0, stream);
}

extern "C" int spk_cell_gather_fwd(const float* table, const int* qidx,
                                   float* out, const SelectArgs* args, int D,
                                   cudaStream_t stream) {
  return launch_select<kCellGather>(table, qidx, out, *args, D, 0, 0,
                                    stream);
}

extern "C" int spk_row_sums(const float* g, const int* sorted,
                            const int* rowptr, float* out, int A, int D,
                            cudaStream_t stream) {
  if (A == 0) return 0;
  if (D % 4 != 0 && D < kNarrowMax) {
    const long long blocks =
        ((long long)A * kRowLanes + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const unsigned nb = (unsigned)blocks;
    if (D == 3)
      row_sum_narrow_kernel<3><<<nb, kThreads, 0, stream>>>(
          g, sorted, rowptr, out, A, D);
    else if (D == 2)
      row_sum_narrow_kernel<2><<<nb, kThreads, 0, stream>>>(
          g, sorted, rowptr, out, A, D);
    else if (D == 1)
      row_sum_narrow_kernel<1><<<nb, kThreads, 0, stream>>>(
          g, sorted, rowptr, out, A, D);
    else
      row_sum_narrow_kernel<0><<<nb, kThreads, 0, stream>>>(
          g, sorted, rowptr, out, A, D);
    return (int)cudaGetLastError();
  }
  const bool vec = D % 4 == 0 && aligned(g) && aligned(out);
  const size_t total = (size_t)A * (vec ? D / 4 : D);
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > ((size_t)1 << 20)) blocks = (size_t)1 << 20;
  if (blocks == 0) return 0;
  if (vec)
    row_sum_kernel<4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        g, sorted, rowptr, out, A, D);
  else
    row_sum_kernel<1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        g, sorted, rowptr, out, A, D);
  return (int)cudaGetLastError();
}
