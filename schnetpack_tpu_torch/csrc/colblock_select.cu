// Generic row selection on the column layout for Hopper (sm_90a), f32: the
// gather of source rows, its VJP, the expand of destination rows and the
// per-destination fold.
//
// K11 select_kernel<true> (narrow rows: select_narrow_kernel<true>) replaces
//   schnetpack_tpu/ops/colblock_pallas.py:121 _gather_fwd_kernel (launchers
//   :130 _gather_fwd_call and, on halo slabs, colblock_shard.py:131
//   _gather_hx_call);
// K12 row_sum_kernel replaces :148 _gather_bwd_kernel (launchers :163
//   _gather_bwd_call, folded by :92 _fold_partials, and colblock_shard.py:154
//   _gather_hx_bwd_call, folded by :182 _fold_partials_hx);
// K13 select_kernel<false> (narrow rows: select_narrow_kernel<false>)
//   replaces :211 _expand_fwd_kernel (launcher :226 _expand_call), which is
//   also the fold's VJP;
// K14 row_sum_kernel replaces :244 _fold_fwd_kernel (launcher :259
//   _fold_call), which is also the expand's VJP: K12's body on the slots
//   sorted by destination.
//
// Layout as in colblock_message.cu: slot k of column (x, y) lies in bucket
// c9 (koffs[c9] <= k < koffs[c9+1]); its source is row qcol of column
// ((x + c9/3 - 1) mod nx, (y + c9%3 - 1) mod ny), its destination row dcol
// of column (x, y); -1 marks a padded slot.  A table is [A', D] with
// A' = nx * ny * P, an edge tensor [nx, ny, Ktot, D], both row-major.
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
//
// The TPU kernels select with one-hot matrix products in bf16 pieces; here
// rows are read by index, exact in f32.  None does arithmetic beyond the
// sums, so all four are bound by device-memory bytes: the edge tensor
// (~0.57 GB at D = 576 and the bench's 246k slots) is read or written once
// and the table once.  Designs:
//
// * K11 / K13 for wide rows (D % 4 == 0, or D > 8) run one block per
//   (destination column, tile of slots); a block decodes each slot's row
//   from its own indices once, into shared memory, and threads copy
//   16-byte lanes (float4) when D % 4 == 0 and the pointers allow it, else
//   single floats.  The bucket of a slot comes from compares against the
//   offsets (``source_column``): a loop indexing them would copy them to
//   local memory in every thread, which cost K11 a quarter of its time at
//   D = 576.
// * K11 / K13 for narrow rows (D < 8, D % 4 != 0: the positions' D = 3)
//   move ~12 bytes a slot, so their time is fixed cost: one thread per
//   slot over a grid of (slot tile, y, x), which gives each thread its
//   column without a division.  The thread loads its index (coalesced),
//   finds its bucket from 8 compares against the offsets held in
//   registers, reads its D floats through the read-only path and writes
//   them: a warp stores 32 D contiguous floats.  No shared memory, no
//   barrier; at the bench's 300k slots 1,200 blocks of 256, about one wave
//   at 8 blocks an SM.
// * K12 and K14 are one body: a sum of each row's run of sorted slots.
//   K12 walks the slots sorted by source row (the device argsort of
//   ``ops/colblock.py::source_order``, cached on the refs and shared with
//   the message backward), K14 those sorted by destination row
//   (``destination_order``, the message forward's order, also cached).
//   Each thread owns one (row, lane) (a float4 lane when D % 4 == 0 and
//   the pointers allow it), sums that row's run in slot order in
//   registers and writes the row once: no shared memory, no atomics, any
//   P, a row with no slot gets 0, and padded slots (last in both orders)
//   are never read.  The TPU's 9 per-source-column partials of K12 would
//   write and read back 9 tables more.

#include <cuda_runtime.h>

// K11/K13's launch arguments that the layout fixes, made once per layout
// by the wrapper (``colblock_select.py::SelectArgs``): the column grid,
// the capacity, the slots per column, the bucket offsets and the source-
// index mode (hx, hy: 0, 0 wrap; 1, 0 halo_x; 1, 1 halo_xy).
struct SelectArgs {
  int nx, ny, P, Ktot;
  int koffs[10];
  int hx, hy;
};

namespace {

constexpr int kThreads = 128;
constexpr int kSelectElems = 1024;   // vector elements per K11/K13 block
constexpr int kNarrowThreads = 256;  // slots per narrow K11/K13 block
constexpr int kNarrowMax = 8;        // widths below this may take it

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

// The source column of slot k of destination column (x, y) in the
// source-index mode (hx, hy): the bucket c9 = 3 (dx + 1) + (dy + 1) from 8
// compares against the offsets, dx from the boundaries 3 and 6; no loop,
// so the offsets stay in registers, and the wrap by compare, not modulo.
__device__ __forceinline__ int source_column(int x, int y, int nx, int ny,
                                             int k, const KOffs& ko, int hx,
                                             int hy) {
  const int b1 = k >= ko.o[1], b2 = k >= ko.o[2], b3 = k >= ko.o[3];
  const int b4 = k >= ko.o[4], b5 = k >= ko.o[5], b6 = k >= ko.o[6];
  const int b7 = k >= ko.o[7], b8 = k >= ko.o[8];
  const int dx = b3 + b6 - 1;
  const int dy = b1 + b2 + b4 + b5 + b7 + b8 - 2 * (dx + 1) - 1;
  int xs = x + dx + hx, ys = y + dy + hy;
  if (!hx) xs += xs < 0 ? nx : (xs >= nx ? -nx : 0);
  if (!hy) ys += ys < 0 ? ny : (ys >= ny ? -ny : 0);
  return xs * (ny + 2 * hy) + ys;
}

// K11 (kGather) / K13 for wide rows: one block per (slot tile, destination
// column).  The block first decodes each of its slots' table row into
// shared memory, then copies the rows lane by lane.
template <bool kGather, int V>
__global__ void __launch_bounds__(kThreads)
    select_kernel(const float* __restrict__ table,
                  const int* __restrict__ idx, float* __restrict__ out,
                  int nx, int ny, int P, int Ktot, KOffs ko, int D,
                  int slots, int hx, int hy) {
  using T = typename Vec<V>::T;
  __shared__ int rows[kSelectElems];   // table row of each slot, -1: pad
  const int col = blockIdx.y;
  const int x = col / ny, y = col - (col / ny) * ny;
  const int k0 = blockIdx.x * slots;
  const int ns = min(slots, Ktot - k0);
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const int k = k0 + s;
    const int r = idx[(size_t)col * Ktot + k];
    const int src =
        kGather && r >= 0 ? source_column(x, y, nx, ny, k, ko, hx, hy) : col;
    rows[s] = r >= 0 ? src * P + r : -1;
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

// K11 (kGather) / K13 for narrow rows: thread k of block (kt, y, x) copies
// slot kt * 256 + k of column (x, y); kD the width (0: D, read at run
// time).
template <bool kGather, int kD>
__global__ void __launch_bounds__(kNarrowThreads)
    select_narrow_kernel(const float* __restrict__ table,
                         const int* __restrict__ idx, float* __restrict__ out,
                         int nx, int P, int Ktot, KOffs ko, int D, int hx,
                         int hy) {
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
  const int src =
      kGather ? source_column(x, y, nx, ny, k, ko, hx, hy) : x * ny + y;
  const float* row = table + ((size_t)src * P + r) * w;
  float v[kD ? kD : kNarrowMax];
#pragma unroll
  for (int d = 0; d < (kD ? kD : kNarrowMax); ++d)
    if (kD || d < w) v[d] = __ldg(row + d);
#pragma unroll
  for (int d = 0; d < (kD ? kD : kNarrowMax); ++d)
    if (kD || d < w) o[d] = v[d];
}

// K12 / K14: thread (row, lane) sums its row's run of sorted slots,
// sorted[rowptr[row]] .. sorted[rowptr[row + 1] - 1], in that order.
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

bool aligned(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

KOffs offsets(const int* koffs) {
  KOffs ko;
  for (int i = 0; i < 10; ++i) ko.o[i] = koffs[i];
  return ko;
}

template <bool kGather>
int launch_select(const float* table, const int* idx, float* out,
                  const SelectArgs& a, int D, int hx, int hy,
                  cudaStream_t stream) {
  const int nx = a.nx, ny = a.ny, P = a.P, Ktot = a.Ktot;
  const KOffs ko = offsets(a.koffs);
  if (D % 4 != 0 && D < kNarrowMax) {
    const dim3 grid((Ktot + kNarrowThreads - 1) / kNarrowThreads, ny, nx);
    if (grid.x == 0) return 0;
    if (D == 3)
      select_narrow_kernel<kGather, 3><<<grid, kNarrowThreads, 0, stream>>>(
          table, idx, out, nx, P, Ktot, ko, D, hx, hy);
    else if (D == 2)
      select_narrow_kernel<kGather, 2><<<grid, kNarrowThreads, 0, stream>>>(
          table, idx, out, nx, P, Ktot, ko, D, hx, hy);
    else if (D == 1)
      select_narrow_kernel<kGather, 1><<<grid, kNarrowThreads, 0, stream>>>(
          table, idx, out, nx, P, Ktot, ko, D, hx, hy);
    else
      select_narrow_kernel<kGather, 0><<<grid, kNarrowThreads, 0, stream>>>(
          table, idx, out, nx, P, Ktot, ko, D, hx, hy);
    return (int)cudaGetLastError();
  }
  const bool vec = D % 4 == 0 && aligned(table) && aligned(out);
  const int nvec = vec ? D / 4 : D;
  int slots = kSelectElems / nvec;
  if (slots > Ktot) slots = Ktot;
  if (slots < 1) slots = 1;
  const dim3 grid((Ktot + slots - 1) / slots, nx * ny);
  if (vec)
    select_kernel<kGather, 4><<<grid, kThreads, 0, stream>>>(
        table, idx, out, nx, ny, P, Ktot, ko, D, slots, hx, hy);
  else
    select_kernel<kGather, 1><<<grid, kThreads, 0, stream>>>(
        table, idx, out, nx, ny, P, Ktot, ko, D, slots, hx, hy);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spk_gather_fwd(const float* table, const int* qcol, float* out,
                              const SelectArgs* args, int D,
                              cudaStream_t stream) {
  return launch_select<true>(table, qcol, out, *args, D, args->hx, args->hy,
                             stream);
}

extern "C" int spk_expand_fwd(const float* table, const int* dcol, float* out,
                              const SelectArgs* args, int D,
                              cudaStream_t stream) {
  return launch_select<false>(table, dcol, out, *args, D, 0, 0, stream);
}

extern "C" int spk_row_sums(const float* g, const int* sorted,
                            const int* rowptr, float* out, int A, int D,
                            cudaStream_t stream) {
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
