// Row gather of the 27-cell atom layout for Hopper (sm_90a), f32, and its
// VJP.
//
// K16 cell_gather_kernel replaces schnetpack_tpu/ops/cellblock_pallas.py:88
//   _fwd_kernel (launcher :117 cell_gather_fwd_pallas, pallas_call :128);
// K17 cell_gather_bwd_kernel replaces :143 _bwd_kernel (launcher :176
//   cell_gather_bwd_pallas, pallas_call :186, folded by the rolls at
//   :207-213).
//
//   K16  out[a, k] = table[j(a, k)]  (0 where qidx is -1)
//   K17  dT[j] = sum of g[a, k] over the slots whose source is j
//
// Layout and decode in cellblock.cuh; a table is [A', D] with A' = nx*ny*
// nz*C, an edge tensor [A', K, D], both row-major.  The TPU kernels select
// with one-hot matrix products over the 27C candidates of a cell, in bf16
// pieces; here rows are read by index, exact in f32.  Neither does
// arithmetic beyond K17's sums, so both are bound by device-memory bytes:
// the edge tensor is written (K16) or read (K17) once and the table once.
// Designs:
//
// * K16 runs one block per tile of edge slots: the block decodes each
//   slot's source row once, into shared memory, and threads copy 16-byte
//   lanes (float4) when D % 4 == 0 and the pointers allow it, else single
//   floats (D = 3, the positions).
// * K17 walks the slots sorted by source row (the device argsort of
//   ops/cellblock_gather.py::source_order, cached per neighbor state and
//   shared with the message backward K19): each thread owns one (source
//   row, lane), sums that row's run of slots in slot order and writes the
//   row once.  The TPU's 9 per-source-column partials would write and read
//   back 9 tables more.  No atomics: the sums are deterministic, and each
//   (offset, cell) pair of an aliased grid is its own slot.

#include <cuda_runtime.h>

#include "cellblock.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSelectElems = 1024;   // vector elements per K16 block

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

// K16: one block per tile of ``slots`` edge slots
template <int V>
__global__ void __launch_bounds__(kThreads)
    cell_gather_kernel(const float* __restrict__ table,
                       const int* __restrict__ qidx, float* __restrict__ out,
                       int nx, int ny, int nz, int C, int K, int D,
                       long long n_slots, int slots) {
  using T = typename Vec<V>::T;
  __shared__ int rows[kSelectElems];   // source row of each slot, -1: pad
  const long long e0 = (long long)blockIdx.x * slots;
  const int ns = (int)min((long long)slots, n_slots - e0);
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const int e = (int)(e0 + s);
    const int q = qidx[e];
    rows[s] = q >= 0 ? cell_source_row(e, q, nx, ny, nz, C, K) : -1;
  }
  __syncthreads();
  const int nvec = D / V;
  const T* tab = reinterpret_cast<const T*>(table);
  T* o = reinterpret_cast<T*>(out) + e0 * nvec;
  for (int t = threadIdx.x; t < ns * nvec; t += blockDim.x) {
    const int s = t / nvec, v = t - s * nvec;
    const int row = rows[s];
    o[t] = row >= 0 ? tab[(size_t)row * nvec + v] : Vec<V>::zero();
  }
}

// K17: thread (row, lane) sums its row's run of source-sorted slots
template <int V>
__global__ void __launch_bounds__(kThreads)
    cell_gather_bwd_kernel(const float* __restrict__ g,
                           const int* __restrict__ esorted,
                           const int* __restrict__ rowptr,
                           float* __restrict__ dT, int A, int D) {
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

bool aligned(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int spk_cell_gather_fwd(const float* table, const int* qidx,
                                   float* out, int nx, int ny, int nz, int C,
                                   int K, int D, cudaStream_t stream) {
  const long long n_slots = (long long)nx * ny * nz * C * K;
  if (n_slots == 0) return 0;
  const bool vec = D % 4 == 0 && aligned(table) && aligned(out);
  const int nvec = vec ? D / 4 : D;
  int slots = kSelectElems / nvec;
  if (slots < 1) slots = 1;
  const long long blocks = (n_slots + slots - 1) / slots;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (vec)
    cell_gather_kernel<4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        table, qidx, out, nx, ny, nz, C, K, D, n_slots, slots);
  else
    cell_gather_kernel<1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        table, qidx, out, nx, ny, nz, C, K, D, n_slots, slots);
  return (int)cudaGetLastError();
}

extern "C" int spk_cell_gather_bwd(const float* g, const int* esorted,
                                   const int* rowptr, float* dT, int A, int D,
                                   cudaStream_t stream) {
  const bool vec = D % 4 == 0 && aligned(g) && aligned(dT);
  const size_t total = (size_t)A * (vec ? D / 4 : D);
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > ((size_t)1 << 20)) blocks = (size_t)1 << 20;
  if (blocks == 0) return 0;
  if (vec)
    cell_gather_bwd_kernel<4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        g, esorted, rowptr, dT, A, D);
  else
    cell_gather_bwd_kernel<1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        g, esorted, rowptr, dT, A, D);
  return (int)cudaGetLastError();
}
