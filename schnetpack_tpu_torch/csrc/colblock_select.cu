// Generic row selection on the column layout for Hopper (sm_90a), f32: the
// gather of source rows, its VJP, the expand of destination rows and the
// per-destination fold.
//
// K11 select_kernel<true> (narrow rows: select_narrow_kernel<true>) replaces
//   schnetpack_tpu/ops/colblock_pallas.py:121 _gather_fwd_kernel (launchers
//   :130 _gather_fwd_call and, on halo slabs, colblock_shard.py:131
//   _gather_hx_call);
// K12 gather_bwd_kernel    replaces :148 _gather_bwd_kernel (launchers :163
//   _gather_bwd_call, folded by :92 _fold_partials, and colblock_shard.py:154
//   _gather_hx_bwd_call, folded by :182 _fold_partials_hx);
// K13 select_kernel<false> (narrow rows: select_narrow_kernel<false>)
//   replaces :211 _expand_fwd_kernel (launcher :226 _expand_call), which is
//   also the fold's VJP;
// K14 fold_kernel          replaces :244 _fold_fwd_kernel (launcher :259
//   _fold_call), which is also the expand's VJP.
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
// * K12 walks the slots sorted by source atom (the device argsort of
//   ``ops/colblock.py::source_order``, cached on the refs and shared with
//   the PaiNN message backward): each thread owns one (source row, lane),
//   sums that row's run of slots in slot order and writes the row once.
//   The TPU's 9 per-source-column partials would write and read back 9
//   tables more.
// * K14 runs one block per (destination column, tile of up to 128
//   features, tile of destination rows) with the tile's [rows, features]
//   sums in shared memory (64 KB at P = 128, opt-in above 48 KB).  The
//   rows take one tile while they fit the block's 227 KB (P <= 453 at
//   D >= 128, every layout of the bench); above that each block scans its
//   column's slots and keeps the rows of its own tile.  Each thread owns
//   one feature lane of a slot group and walks the group's slots in order;
//   for a narrow D the 128 threads split the slots into groups (slot k to
//   group k mod G), whose sums are added in group order before each output
//   row is written once.  No atomics anywhere: every result is deterministic.

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
constexpr int kFoldLanes = 128;      // features per K14 block
constexpr int kFoldSmemCap = 64 * 1024;  // K14 shared memory for narrow D
constexpr int kUnroll = 32;          // K14 slots in flight per thread

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

// K12: thread (row, lane) sums its row's run of source-sorted slots.
template <int V>
__global__ void __launch_bounds__(kThreads)
    gather_bwd_kernel(const float* __restrict__ g,
                      const int* __restrict__ esorted,
                      const int* __restrict__ rowptr, float* __restrict__ dT,
                      int A, int D) {
  using T = typename Vec<V>::T;
  const int nvec = D / V;
  const T* gv = reinterpret_cast<const T*>(g);
  T* o = reinterpret_cast<T*>(dT);
  const size_t total = (size_t)A * nvec;
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (size_t)gridDim.x * blockDim.x) {
    const int row = (int)(t / nvec), v = (int)(t - (size_t)row * nvec);
    T s = Vec<V>::zero();
    const int end = rowptr[row + 1];
    for (int p = rowptr[row]; p < end; ++p)
      Vec<V>::add(s, gv[(size_t)esorted[p] * nvec + v]);
    o[t] = s;
  }
}

// K14: one block per (feature tile, row tile, destination column); shared
// memory holds ``groups`` partial sums [rows][lanes] of the tile's rows
// r0 .. r0 + rows - 1 (rows = P: one tile).
__global__ void __launch_bounds__(kThreads)
    fold_kernel(const float* __restrict__ ev, const int* __restrict__ dcol,
                float* __restrict__ out, int P, int Ktot, int D, int lanes,
                int groups, int rows) {
  extern __shared__ float acc[];
  const int col = blockIdx.z;
  const int f0 = blockIdx.x * lanes;
  const int nl = min(lanes, D - f0);
  const int r0 = blockIdx.y * rows;
  const int nr = min(rows, P - r0);
  for (int i = threadIdx.x; i < groups * rows * lanes; i += blockDim.x)
    acc[i] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x % lanes, grp = threadIdx.x / lanes;
  if (grp < groups && lane < nl) {
    float* a = acc + (size_t)grp * rows * lanes + lane;
    const int* dc = dcol + (size_t)col * Ktot;
    const float* v = ev + (size_t)col * Ktot * D + f0 + lane;
    int k = grp;
    for (; k + (kUnroll - 1) * groups < Ktot; k += kUnroll * groups) {
      int d[kUnroll];
      float val[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        d[u] = dc[k + u * groups] - r0;
        val[u] = v[(size_t)(k + u * groups) * D];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)   // padded (-1) and other tiles' rows
        if ((unsigned)d[u] < (unsigned)nr) a[d[u] * lanes] += val[u];
    }
    for (; k < Ktot; k += groups) {
      const int dk = dc[k] - r0;
      if ((unsigned)dk < (unsigned)nr) a[dk * lanes] += v[(size_t)k * D];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * nl; i += blockDim.x) {
    const int r = i / nl, l = i - (i / nl) * nl;
    float s = 0.f;
    for (int q = 0; q < groups; ++q)
      s += acc[((size_t)q * rows + r) * lanes + l];
    out[((size_t)col * P + r0 + r) * D + f0 + l] = s;
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

extern "C" int spk_gather_bwd(const float* g, const int* esorted,
                              const int* rowptr, float* dT, int A, int D,
                              cudaStream_t stream) {
  const bool vec = D % 4 == 0 && aligned(g) && aligned(dT);
  const size_t total = (size_t)A * (vec ? D / 4 : D);
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > ((size_t)1 << 20)) blocks = (size_t)1 << 20;
  if (blocks == 0) return 0;
  if (vec)
    gather_bwd_kernel<4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        g, esorted, rowptr, dT, A, D);
  else
    gather_bwd_kernel<1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        g, esorted, rowptr, dT, A, D);
  return (int)cudaGetLastError();
}

extern "C" int spk_fold_fwd(const float* ev, const int* dcol, float* out,
                            int nx, int ny, int P, int Ktot, int D,
                            cudaStream_t stream) {
  const int lanes = D < kFoldLanes ? D : kFoldLanes;
  const size_t row_bytes = (size_t)P * lanes * sizeof(float);
  int groups = kThreads / lanes;
  while (groups > 1 && groups * row_bytes > (size_t)kFoldSmemCap) --groups;
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  // destination rows per block: all P where they fit, else as many as do
  const size_t rows_fit =
      (size_t)max_smem / ((size_t)groups * lanes * sizeof(float));
  if (rows_fit == 0) return (int)cudaErrorInvalidConfiguration;
  const int rows = (size_t)P <= rows_fit ? P : (int)rows_fit;
  if (rows == 0) return 0;
  const size_t smem = (size_t)groups * rows * lanes * sizeof(float);
  int err = (int)cudaFuncSetAttribute(
      fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid((D + lanes - 1) / lanes, (P + rows - 1) / rows, nx * ny);
  fold_kernel<<<grid, kThreads, smem, stream>>>(ev, dcol, out, P, Ktot, D,
                                                lanes, groups, rows);
  return (int)cudaGetLastError();
}
