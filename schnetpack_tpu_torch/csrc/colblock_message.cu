// PaiNN column-layout message kernels for Hopper (sm_90a), f32.
//
// K1 msg_fwd_kernel<false> replaces the TPU kernel
//   schnetpack_tpu/ops/colblock_pallas.py:1889 _msg_fm_fwd_fused_kernel
// K2 msg_bwd_kernel<kFused, W> replaces
//   schnetpack_tpu/ops/colblock_pallas.py:1239 _msg_fm_bwd_fused_kernel
//   (W = kWgrad: false without, true with the filter-weight cotangent).
// K6 msg_fwd_kernel<true> replaces the three geo-tensor forwards
//   colblock_pallas.py:568 _msg_fm_fwd_kernel, :599 _msg_fm_fwd_res_kernel
//   and :687 _msg_fm_fwd_res_preoh_kernel (they differ only in how the TPU
//   stages tables in VMEM and builds one-hots; all compute K1's message on
//   a precomputed geo tensor).
// K7 msg_bwd_kernel<kGeoRes, W> replaces
//   colblock_pallas.py:1570 _msg_fm_bwd_geores_kernel (wgrad off / on).
// K15 msg_bwd_kernel<kSrc, W> replaces the two row-9 kernels
//   colblock_pallas.py:834 _msg_fm_bwd_src_kernel and :945
//   _msg_fm_bwd_src_res_kernel (they differ only in how the TPU stages
//   tables in VMEM): the message VJP on a geo of B+4 channels [rbf_aug,
//   dir] that autograd differentiates (any radial basis and cutoff).  It
//   runs K7's schedule and per-edge reductions but no geometry chain:
//   each real slot's geometry cotangent ggeo = [grbf (B+1), gdir (3)] is
//   written at the slot's own [c, Ktot] position (one writer per slot;
//   the wrapper zero-fills, so padded slots stay 0).
// K20 msg_fwd_kernel<true> on edge-major geometry replaces the row-12
//   forward colblock_pallas.py:322 _msg_fwd_kernel (launchers :365 on one
//   device and colblock_shard.py:269 _msg_hx_fwd_call on halo slabs): the
//   message on xmu = [x, mu] [A'_src, 6F], rbf_aug [nx, ny, Ktot, B+1] and
//   dir [nx, ny, Ktot, 3].
// K21 msg_bwd_kernel<kSrc, W> on the same inputs replaces the row-12
//   backward colblock_pallas.py:391 _msg_bwd_kernel (launchers :478 and
//   colblock_shard.py:307 _msg_hx_bwd_call): dxmu over the whole source
//   table, grbf, gdir and (W) gFW.
//
// K6/K20 and K15/K21 are the same kernel bodies: the geometry is read
// through a GeoView (channel-major geo [nx, ny, nch, Ktot] or edge-major
// [nx, ny, Ktot, c] tensors), x and mu are rows of stride ldx (3F for the
// two tables, 6F for the halves of xmu), and the source column of bucket
// c9 = (dx+1)*3 + (dy+1) of destination column (i, j) is, in the three
// source-index modes (hx, hy):
//   wrap    (0, 0): ((i+dx) mod nx, (j+dy) mod ny) of an [nx, ny] table
//   halo_x  (1, 0): (i+dx+1, (j+dy) mod ny) of an [nx+2, ny] table
//   halo_xy (1, 1): (i+dx+1, j+dy+1) of an [nx+2, ny+2] table
// (the x- and xy-halo'd slabs of colblock_shard.py:111-128).  The backward
// needs no mode: its blocks own source columns of whichever table, whose
// slots the wrapper sorts by their row in it.
//
// kWgrad adds the filter-weight cotangent gFW = sum_e rbf_aug_e^T gW_e
// [B+1, 3F]: thread part*F+f owns column part*F+f, sums a chunk's 32
// edges in f32 registers and adds them to the block's f64 sums in shared
// memory; each block writes one f64 [B+1, 3F] partial that the wrapper
// sums (deterministic, no atomics).  gFW sums ~200k edges at the bench
// shapes, where f32 running sums would lose ~1e-5 absolute.  The
// kWgrad=false instances compile to the same code as without the switch.
//
// Layout (schnetpack_tpu_torch/ops/cellblock.py): atoms sorted into nx*ny
// xy-columns of P rows; edge slot k of column (i, j) lies in bucket c9 =
// (dx+1)*3 + (dy+1), slots [koffs[c9], koffs[c9+1]); its source is row
// qcol of column ((i+dx) mod nx, (j+dy) mod ny), its destination row dcol
// of column (i, j); qcol < 0 marks a padded slot.  K1 and K2 recompute
// the per-edge geometry (rij, d, dir, cosine cutoff, Gaussian basis) from
// the positions in f32, as the TPU kernels do; no per-edge tensor exists
// in device memory.  K6 and K7 instead read it from the packed geo tensor
// [nx, ny, nch, Ktot] that K5 (colblock_geo.cu) writes once per step,
// channels [phi*fcut (B), fcut, dir (3), d]: K6 reads the first B+4, K7
// all B+5 and takes no positions.  K7 derives the geometry chain from the
// stored channels with the same formulas as its twin
// (ops/colblock_message.py::msg_bwd_geores_plain):
//   phi    = stored * (1 / max(fcut, 1e-30))
//   dfcut  = fcut > 0 ? -0.5 (pi/rc) sin(pi d/rc) : 0   (sin from the
//            stored d: no cancellation near d -> 0 or d -> rc, unlike the
//            TPU's sqrt(1 - (2 fcut - 1)^2))
//   gd     = sum_b grbf_b 2 coeff_b (d - c_b) phi_b * fcut
//            + (sum_b grbf_b phi_b + grbf_B) * dfcut
//   grij   = (gdir - dir (gdir . dir)) / max(d, 1e-6) + gd dir
// Padded and out-of-cutoff slots have fcut = 0, so phi, dfcut and every
// filter value are exactly 0 there and grij is 0 (no NaN from d = 1).
//
// What bounds them on the H100: per edge slot the TPU kernels ran one-hot
// selection matmuls (a device of the TPU's matrix unit); here rows are
// read by index, so the work per edge is ~(B+1)*3F FMAs for the filter plus
// a few feature loads, and both kernels are bound by the latency of those
// scattered row loads and of their dependent FMA chains, not by HBM
// bandwidth (the feature tables, ~13 MB each at the 10k-atom bench, stay
// in the 50 MB L2).  K6/K7 trade the in-kernel geometry (B exp + a cos
// per edge) for B+4 or B+5 loads of the ~25 MB geo tensor: K6 stages each
// chunk's [B+4, chunk] slice in shared memory with loads that are
// coalesced along Ktot, kLd in flight per thread, once for all warps of
// the block; K7's loads follow the source-sorted edge order and are
// scattered, so the whole block issues them, a few per thread.  Each thread therefore keeps kU edges in flight
// (independent loads and filter chains) and applies their updates in edge
// order.  Every sum is deterministic and free of atomics: K1 owns its
// destination column's rows and sums them in shared memory; K2 owns its
// source column's rows of dx/dmu (thread-owned read-modify-write, one
// thread per (part, feature)) and writes its destination-side position
// cotangents to one of 9 partial arrays that the wrapper sums.  Tensor
// cores for the filter product and edge-parallel tiles are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;        // features per K1 block (one warp per output)
constexpr int kEdgesFwd = 128;   // edges per K1 chunk (one per thread)
constexpr int kEdgesBwd = 32;    // edges per K2 chunk
constexpr int kMaxThreadsBwd = 384;  // K2 runs 3F threads (F <= 128)
constexpr int kU = 4;            // edges in flight per thread (K1, K2)
constexpr int kLd = 8;           // geo loads in flight per thread (K6)
constexpr int kMaxB1 = 32;       // B+1 bound of the kWgrad chunk sums
constexpr float kPi = 3.14159265358979323846f;

// the three forms of the message backward
constexpr int kFused = 0;        // K2: geometry recomputed from R, emits dR
constexpr int kGeoRes = 1;       // K7: geometry chain from the stored geo
constexpr int kSrc = 2;          // K15: emits the geo cotangent instead

struct KOffs {
  int o[10];
};

// Per-slot geometry: channel c < B+1 of slot k of destination column col
// at rbf + col * col_r + k * slot_r + c * ch_r, direction component c at
// dir + col * col_d + k * slot_d + c * ch_d (K7's d channel is direction
// component 3 of the channel-major geo).
template <typename T>
struct GeoView {
  T* rbf;
  T* dir;
  size_t col_r, slot_r, ch_r, col_d, slot_d, ch_d;
  __device__ T* r(int col, int k, int c) const {
    return rbf + col * col_r + k * slot_r + c * ch_r;
  }
  __device__ T* d(int col, int k, int c) const {
    return dir + col * col_d + k * slot_d + c * ch_d;
  }
  __device__ T* at(int col, int k, int c, int B1) const {
    return c < B1 ? r(col, k, c) : d(col, k, c - B1);
  }
};


template <bool kGeo>
__global__ void __launch_bounds__(kThreads)
msg_fwd_kernel(const float* __restrict__ x, const float* __restrict__ mu,
               const float* __restrict__ R, GeoView<const float> gv,
               const float* __restrict__ FW,
               const float* __restrict__ coff, const float* __restrict__ cw,
               const int* __restrict__ qcol, const int* __restrict__ dcol,
               float* __restrict__ dq, float* __restrict__ dmu,
               int nx, int ny, int P, int Ktot, KOffs ko, int F, int B,
               int ldx, int hx, int hy, float rc) {
  // One block per (destination column, 32-feature tile).  Warp o of the
  // block owns output o (0: dq, 1..3: dmu component o-1) for the tile's 32
  // features, so each shared accumulator entry has exactly one writer.
  extern __shared__ float smem[];
  const int B1 = B + 1, D3 = 3 * F;
  const int col = blockIdx.x, tile = blockIdx.y;
  const int ci = col / ny, cj = col - ci * ny;
  const int tid = threadIdx.x, o = tid >> 5, fl = tid & 31;
  const int f = tile * kTile + fl;

  float* s_acc = smem;                        // [P][4][32]
  float* s_fw = s_acc + P * 128;              // [B1][3][32]
  float* s_rbf = s_fw + B1 * 96;              // [E][B1] phi*fcut, fcut
  float* s_dir = s_rbf + kEdgesFwd * B1;      // [E][3]
  int* s_src = reinterpret_cast<int*>(s_dir + kEdgesFwd * 3);  // [E]
  int* s_dst = s_src + kEdgesFwd;             // [E]

  for (int t = tid; t < P * 128; t += kThreads) s_acc[t] = 0.f;
  for (int t = tid; t < B1 * 96; t += kThreads) {
    const int b = t / 96, part = (t % 96) / 32, ff = t % 32;
    s_fw[t] = FW[b * D3 + part * F + tile * kTile + ff];
  }

  const int* qc = qcol + (size_t)col * Ktot;
  const int* dc = dcol + (size_t)col * Ktot;

  for (int c9 = 0; c9 < 9; ++c9) {
    const int dxo = c9 / 3 - 1, dyo = c9 % 3 - 1;
    const int si = hx ? ci + dxo + 1 : (ci + dxo + nx) % nx;
    const int sj = hy ? cj + dyo + 1 : (cj + dyo + ny) % ny;
    const int srow0 = (si * (ny + 2 * hy) + sj) * P;
    const int k_end = ko.o[c9 + 1];
    for (int base = ko.o[c9]; base < k_end; base += kEdgesFwd) {
      __syncthreads();  // the previous chunk's readers are done
      // phase 1: geometry of edge base+tid
      const int e = base + tid;
      int src = -1;
      if (e < k_end && qc[e] >= 0) {
        const int dv = dc[e];
        src = srow0 + qc[e];
        float* rb = s_rbf + tid * B1;
        if constexpr (kGeo) {
          // K6/K20: the [phi*fcut, fcut, dir] channels of slot e, kLd
          // loads in flight per thread
          const int nc = B1 + 3;
          for (int c0 = 0; c0 < nc; c0 += kLd) {
            float v[kLd];
#pragma unroll
            for (int u = 0; u < kLd; ++u)
              v[u] = c0 + u < nc ? *gv.at(col, e, c0 + u, B1) : 0.f;
#pragma unroll
            for (int u = 0; u < kLd; ++u) {
              const int c = c0 + u;
              if (c < B1)
                rb[c] = v[u];
              else if (c < nc)
                s_dir[tid * 3 + c - B1] = v[u];
            }
          }
        } else {
          const float* oc = coff + (size_t)col * 3 * Ktot;
          const float* Rown = R + (size_t)col * P * 3;
          const float pi_rc = kPi / rc;
          const float rx = R[src * 3 + 0] + oc[e] - Rown[dv * 3 + 0];
          const float ry = R[src * 3 + 1] + oc[Ktot + e] - Rown[dv * 3 + 1];
          const float rz =
              R[src * 3 + 2] + oc[2 * Ktot + e] - Rown[dv * 3 + 2];
          const float d = sqrtf(rx * rx + ry * ry + rz * rz);
          const float inv = 1.f / d;
          const float fcut = d < rc ? 0.5f * (cosf(d * pi_rc) + 1.f) : 0.f;
          for (int b = 0; b < B; ++b) {
            const float df = d - cw[2 * b];
            rb[b] = expf(cw[2 * b + 1] * df * df) * fcut;
          }
          rb[B] = fcut;
          s_dir[tid * 3 + 0] = rx * inv;
          s_dir[tid * 3 + 1] = ry * inv;
          s_dir[tid * 3 + 2] = rz * inv;
        }
        s_dst[tid] = dv;
      }
      s_src[tid] = src;
      __syncthreads();
      // phase 2: messages of the chunk, kU edges in flight per thread
      // (independent filter chains and loads), accumulated in edge order
      const int n = min(kEdgesFwd, k_end - base);
      for (int t0 = 0; t0 < n; t0 += kU) {
        int sr[kU];
        float w0[kU], w1[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          sr[u] = t0 + u < n ? s_src[t0 + u] : -1;
          w0[u] = w1[u] = 0.f;
        }
        const int fo = o == 0 ? 0 : 32;  // filter part: q, or R and mu
        for (int b = 0; b < B1; ++b) {
          const float fa = s_fw[b * 96 + fo + fl];
          const float fb = s_fw[b * 96 + 64 + fl];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const float r = s_rbf[(t0 + u) * B1 + b];
            w0[u] = fmaf(r, fa, w0[u]);
            w1[u] = fmaf(r, fb, w1[u]);
          }
        }
        float val[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const size_t row = (size_t)max(sr[u], 0) * ldx;
          if (o == 0)
            val[u] = x[row + f] * w0[u];
          else
            val[u] = x[row + F + f] * w0[u] * s_dir[(t0 + u) * 3 + o - 1] +
                     x[row + 2 * F + f] * w1[u] * mu[row + (o - 1) * F + f];
        }
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (sr[u] >= 0) s_acc[(s_dst[t0 + u] * 4 + o) * 32 + fl] += val[u];
      }
    }
  }
  __syncthreads();
  const size_t row0 = (size_t)col * P;
  for (int r = 0; r < P; ++r) {
    const float v = s_acc[(r * 4 + o) * 32 + fl];
    if (o == 0)
      dq[(row0 + r) * F + f] = v;
    else
      dmu[(row0 + r) * D3 + (o - 1) * F + f] = v;
  }
}

template <int kMode, bool kWgrad>
__global__ void __launch_bounds__(kMaxThreadsBwd)
msg_bwd_kernel(const float* __restrict__ x, const float* __restrict__ mu,
               const float* __restrict__ R, GeoView<const float> gv,
               const float* __restrict__ FW,
               const float* __restrict__ coff, const float* __restrict__ cw,
               const int* __restrict__ qcol, const int* __restrict__ dcol,
               const int* __restrict__ esorted, const int* __restrict__ grp,
               const float* __restrict__ g_dq, const float* __restrict__ g_dmu,
               float* __restrict__ dx, float* __restrict__ dmu_out,
               float* __restrict__ gRo, float* __restrict__ gRd,
               GeoView<float> gg, double* __restrict__ gFWp,
               int nx, int ny, int P, int Ktot, KOffs ko, int G, int F,
               int B, int ldx, float rc) {
  // Source-centric.  ``esorted`` lists every real edge slot (dest column
  // * Ktot + slot) sorted by source atom, i.e. by (source column, source
  // row) of the source table (K21: the halo'd one in the halo modes).  Block (col, g) owns the source rows [r0, r1) of column col and
  // their edges [e0, e1) (``grp[col][g]`` = (r0, e0), ``grp[col][g+1]``
  // = (r1, e1), ranges of about equal edge count).  It is the only writer
  // of those rows of dx, dmu and gRo, and writes its destination-side
  // position cotangents to its own partial gRd[g][c9][dest column] (summed
  // by the wrapper).  The block has 3F threads; thread tid = part*F + f
  // owns feature f of part q / R / mu (part 2 also the three dmu
  // components of f) and keeps the current source row's sums in registers
  // while the run of that row's edges lasts, then stores them once.  The
  // per-edge reductions over all 3F features (filter cotangent, dir
  // cotangent) go through shared memory, 32 edges at a time.  K15 stops
  // after those reductions and stores them per slot (ggeo); kWgrad adds
  // the block's gFW partial gFWp[col * G + g].
  constexpr bool kGeo = kMode != kFused;
  extern __shared__ float smem[];
  constexpr int E = kEdgesBwd;
  const int B1 = B + 1, D3 = 3 * F, LD = D3 + 1;  // LD: bank-conflict pad
  const int NW = F / 32;                           // warps per part
  const int col = blockIdx.x, g = blockIdx.y;
  const int ci = col / ny, cj = col - ci * ny;
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31;
  const int part = tid / F, f = tid - part * F;
  const int* gb = grp + ((size_t)col * (G + 1) + g) * 2;
  const int r0 = gb[0], e0 = gb[1], r1 = gb[2], e1 = gb[3];

  double* s_gfw = reinterpret_cast<double*>(smem);  // [B1][D3] (kWgrad)
  float* s_fw = smem + (kWgrad ? 2 * B1 * D3 : 0);  // [B1][LD]
  float* s_gw = s_fw + B1 * LD;        // [E][LD] filter cotangent per edge
  float* s_rbf = s_gw + E * LD;        // [E][B1]
  float* s_grbf = s_rbf + E * B1;      // [E][B1]
  float* s_rij = s_grbf + E * B1;      // [E][3] rij (K2) or dir (K7, K15)
  float* s_d = s_rij + E * 3;          // [E]
  float* s_gdir = s_d + E;             // [E][NW][3] per-warp partials
  float* s_grij = s_gdir + E * NW * 3; // [E][3]
  // position cotangents [3][P] own, [9][3][P] destination side (not K15)
  const int nR = kMode == kSrc ? 0 : 30 * P;
  float* s_gRo = s_grij + E * 3;       // [3][P]
  float* s_gRd = s_gRo + 3 * P;        // [9][3][P]
  int* s_src = reinterpret_cast<int*>(s_gRo + nR);  // [E] (-1 pad)
  int* s_dst = s_src + E;              // [E] global destination row
  int* s_c9 = s_dst + E;               // [E]
  int* s_dcol = s_c9 + E;              // [9] destination column of c9
  int* s_slot = s_dcol + 9;            // [E] edge slot (K7's, K15's geo)

  const size_t own0 = (size_t)col * P;
  for (int r = r0; r < r1; ++r) {      // rows without edges stay zero
    dx[(own0 + r) * ldx + tid] = 0.f;
    if (part == 2) {
      dmu_out[(own0 + r) * ldx + f] = 0.f;
      dmu_out[(own0 + r) * ldx + F + f] = 0.f;
      dmu_out[(own0 + r) * ldx + 2 * F + f] = 0.f;
    }
  }
  for (int t = tid; t < B1 * D3; t += nth)
    s_fw[(t / D3) * LD + t % D3] = FW[t];
  for (int t = tid; t < nR; t += nth) s_gRo[t] = 0.f;  // gRo and gRd
  if (tid < 9)
    s_dcol[tid] = ((ci - (tid / 3 - 1) + nx) % nx) * ny +
                  (cj - (tid % 3 - 1) + ny) % ny;

  int run = -1;                        // source row of the open run
  float a_dx = 0.f, a_m0 = 0.f, a_m1 = 0.f, a_m2 = 0.f;
  float a_fw[kWgrad ? kMaxB1 : 1];     // gFW column tid, this chunk
  if constexpr (kWgrad) {
#pragma unroll
    for (int b = 0; b < kMaxB1; ++b) a_fw[b] = 0.f;
    for (int b = 0; b < B1; ++b) s_gfw[(size_t)b * D3 + tid] = 0.0;
  }
  const float pi_rc = kPi / rc;
  for (int base = e0; base < e1; base += E) {
    __syncthreads();  // previous chunk finished (and the set-up above)
    // phase 1: decode + geometry, one edge per thread of warp 0
    if (tid < E) {
      const int e = base + tid;
      int qv = -1;
      if (e < e1) {
        const int slot = esorted[e];
        const int dcolumn = slot / Ktot, k = slot - dcolumn * Ktot;
        int c9 = 0;
        while (k >= ko.o[c9 + 1]) ++c9;
        qv = qcol[slot];
        const int dv = dcol[slot];
        const size_t di = (size_t)dcolumn * P + dv;
        if constexpr (kGeo) {
          s_slot[tid] = slot;          // channels loaded below, block-wide
        } else {
          float* rb = s_rbf + tid * B1;
          const float* oc = coff + (size_t)dcolumn * 3 * Ktot + k;
          const float rx = R[(own0 + qv) * 3 + 0] + oc[0] - R[di * 3 + 0];
          const float ry = R[(own0 + qv) * 3 + 1] + oc[Ktot] - R[di * 3 + 1];
          const float rz =
              R[(own0 + qv) * 3 + 2] + oc[2 * Ktot] - R[di * 3 + 2];
          const float d = sqrtf(rx * rx + ry * ry + rz * rz);
          const float fcut = d < rc ? 0.5f * (cosf(d * pi_rc) + 1.f) : 0.f;
          for (int b = 0; b < B; ++b) {
            const float df = d - cw[2 * b];
            rb[b] = expf(cw[2 * b + 1] * df * df) * fcut;
          }
          rb[B] = fcut;
          s_rij[tid * 3 + 0] = rx;
          s_rij[tid * 3 + 1] = ry;
          s_rij[tid * 3 + 2] = rz;
          s_d[tid] = d;
        }
        s_dst[tid] = (int)di;
        s_c9[tid] = c9;
      }
      s_src[tid] = qv;
    }
    __syncthreads();
    const int n = min(E, e1 - base);
    if constexpr (kGeo) {
      // K7: the chunk's stored [phi*fcut, fcut, dir, d] channels (K15:
      // [rbf_aug, dir]), loaded by the whole block (a few independent
      // loads per thread instead of B+5 dependent ones on warp 0)
      const int nc = kMode == kSrc ? B1 + 3 : B1 + 4;
      for (int idx = tid; idx < E * nc; idx += nth) {
        const int t = idx % E, c = idx / E;
        if (s_src[t] < 0) continue;
        const int slot = s_slot[t];
        const float v = *gv.at(slot / Ktot, slot % Ktot, c, B1);
        if (c < B1)
          s_rbf[t * B1 + c] = v;
        else if (c < B1 + 3)
          s_rij[t * 3 + c - B1] = v;
        else
          s_d[t] = v;
      }
      __syncthreads();
    }
    // phase 2: message backward, kU edges in flight per thread: all
    // loads and products first, then the run sums in edge order
    for (int t0 = 0; t0 < n; t0 += kU) {
      int sv[kU];
      size_t so[kU], sd[kU];
      float w[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const bool ok = t0 + u < n;
        sv[u] = ok ? s_src[t0 + u] : -1;
        so[u] = (own0 + max(sv[u], 0)) * ldx;
        sd[u] = ok ? s_dst[t0 + u] : 0;
        w[u] = 0.f;
      }
      for (int b = 0; b < B1; ++b) {
        const float fw = s_fw[b * LD + tid];
#pragma unroll
        for (int u = 0; u < kU; ++u)
          w[u] = fmaf(s_rbf[min(t0 + u, E - 1) * B1 + b], fw, w[u]);
      }
      float gx[kU], gwv[kU], gm0[kU], gm1[kU], gm2[kU], xw[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float xv = x[so[u] + tid];
        xw[u] = xv * w[u];                 // dmuR (part 1), dmumu (part 2)
        if (part == 0) {
          const float gq = g_dq[sd[u] * F + f];
          gm0[u] = gm1[u] = gm2[u] = 0.f;
          gx[u] = gq * w[u];
          gwv[u] = gq * xv;
        } else {
          const float* gm = g_dmu + sd[u] * D3;
          gm0[u] = gm[f];
          gm1[u] = gm[F + f];
          gm2[u] = gm[2 * F + f];
          float gpart;
          if (part == 1) {
            const float* r = s_rij + min(t0 + u, E - 1) * 3;
            gpart = gm0[u] * r[0] + gm1[u] * r[1] + gm2[u] * r[2];
            if constexpr (!kGeo)
              gpart /= s_d[min(t0 + u, E - 1)];  // sum_c g_c dir_c
          } else {
            const float* ms = mu + so[u];
            gpart = gm0[u] * ms[f] + gm1[u] * ms[F + f] + gm2[u] * ms[2 * F + f];
          }
          gx[u] = gpart * w[u];
          gwv[u] = gpart * xv;
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (sv[u] < 0) continue;
        if (sv[u] != run) {            // the run of row `run` ended
          if (run >= 0) {
            const size_t ro = (own0 + run) * ldx;
            dx[ro + tid] = a_dx;
            if (part == 2) {
              dmu_out[ro + f] = a_m0;
              dmu_out[ro + F + f] = a_m1;
              dmu_out[ro + 2 * F + f] = a_m2;
            }
          }
          run = sv[u];
          a_dx = a_m0 = a_m1 = a_m2 = 0.f;
        }
        a_dx += gx[u];
        a_m0 = fmaf(gm0[u], xw[u], a_m0);
        a_m1 = fmaf(gm1[u], xw[u], a_m1);
        a_m2 = fmaf(gm2[u], xw[u], a_m2);
        if constexpr (kWgrad) {        // gFW[:, tid] += rbf_aug_e gW_e[tid]
          const float* rb = s_rbf + (t0 + u) * B1;
#pragma unroll
          for (int b = 0; b < kMaxB1; ++b)
            if (b < B1) a_fw[b] = fmaf(rb[b], gwv[u], a_fw[b]);
        }
        s_gw[(t0 + u) * LD + tid] = gwv[u];
      }
      if (part == 1) {  // dir cotangent: sum_f g_c * dmuR over the part
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          float p0 = gm0[u] * xw[u], p1 = gm1[u] * xw[u], p2 = gm2[u] * xw[u];
          for (int sh = 16; sh > 0; sh >>= 1) {
            p0 += __shfl_xor_sync(0xffffffffu, p0, sh);
            p1 += __shfl_xor_sync(0xffffffffu, p1, sh);
            p2 += __shfl_xor_sync(0xffffffffu, p2, sh);
          }
          if (lane == 0 && sv[u] >= 0) {
            float* gd = s_gdir + ((t0 + u) * NW + (f >> 5)) * 3;
            gd[0] = p0;
            gd[1] = p1;
            gd[2] = p2;
          }
        }
      }
    }
    if constexpr (kWgrad) {  // the chunk's f32 sums into the block's f64
#pragma unroll
      for (int b = 0; b < kMaxB1; ++b)
        if (b < B1) {
          s_gfw[(size_t)b * D3 + tid] += (double)a_fw[b];
          a_fw[b] = 0.f;
        }
    }
    __syncthreads();
    // phase 3: basis cotangent grbf[t][b] = sum_f gw[t][f] * FW[b][f]
    for (int idx = tid; idx < n * B1; idx += nth) {
      const int t = idx / B1, b = idx - t * B1;
      float acc = 0.f;
      if (s_src[t] >= 0) {
        const float* gw = s_gw + t * LD;
        const float* fw = s_fw + b * LD;
        for (int k = 0; k < D3; ++k) acc = fmaf(gw[k], fw[k], acc);
      }
      s_grbf[idx] = acc;
    }
    __syncthreads();
    if constexpr (kMode == kSrc) {
      // K15: each slot's geometry cotangent [grbf (B+1), gdir (3)] at its
      // own [dest column, c, k] position; no geometry chain, no dR
      const int nc = B1 + 3;
      for (int idx = tid; idx < n * nc; idx += nth) {
        const int t = idx % n, c = idx / n;
        if (s_src[t] < 0) continue;
        float v = 0.f;
        if (c < B1)
          v = s_grbf[t * B1 + c];
        else
          for (int w = 0; w < NW; ++w) v += s_gdir[(t * NW + w) * 3 + c - B1];
        const int slot = s_slot[t];
        *gg.at(slot / Ktot, slot % Ktot, c, B1) = v;
      }
      continue;  // the next chunk starts with a barrier
    }
    // phase 4: geometry chain -> grij, one edge per thread of warp 0
    if (tid < n) {
      const int t = tid;
      float gr0 = 0.f, gr1 = 0.f, gr2 = 0.f;
      if (s_src[t] >= 0) {
        float gd0 = 0.f, gd1 = 0.f, gd2 = 0.f;
        for (int w = 0; w < NW; ++w) {
          gd0 += s_gdir[(t * NW + w) * 3 + 0];
          gd1 += s_gdir[(t * NW + w) * 3 + 1];
          gd2 += s_gdir[(t * NW + w) * 3 + 2];
        }
        const float d = s_d[t];
        const float* gb2 = s_grbf + t * B1;
        if constexpr (kGeo) {
          // K7: the chain from the stored channels (formulas in the
          // header note)
          const float* rb = s_rbf + t * B1;
          const float ux = s_rij[t * 3 + 0], uy = s_rij[t * 3 + 1],
                      uz = s_rij[t * 3 + 2];
          const float fcut = rb[B];
          const float dfcut =
              fcut > 0.f ? -0.5f * pi_rc * sinf(d * pi_rc) : 0.f;
          const float inv_fc = 1.f / fmaxf(fcut, 1e-30f);
          float sd = 0.f, sp = 0.f;
          for (int b = 0; b < B; ++b) {
            const float df = d - cw[2 * b], coeff = cw[2 * b + 1];
            const float phi = rb[b] * inv_fc;
            sd = fmaf(gb2[b], 2.f * coeff * df * phi, sd);
            sp = fmaf(gb2[b], phi, sp);
          }
          const float gd = sd * fcut + (sp + gb2[B]) * dfcut;
          const float sdot = gd0 * ux + gd1 * uy + gd2 * uz;
          const float inv = 1.f / fmaxf(d, 1e-6f);
          gr0 = (gd0 - ux * sdot) * inv + gd * ux;
          gr1 = (gd1 - uy * sdot) * inv + gd * uy;
          gr2 = (gd2 - uz * sdot) * inv + gd * uz;
        } else {
          const float inv = 1.f / d;
          const float rx = s_rij[t * 3 + 0], ry = s_rij[t * 3 + 1],
                      rz = s_rij[t * 3 + 2];
          const bool in = d < rc;
          const float fcut = in ? 0.5f * (cosf(d * pi_rc) + 1.f) : 0.f;
          const float dfcut = in ? -0.5f * pi_rc * sinf(d * pi_rc) : 0.f;
          float sd = 0.f, sp = 0.f;
          for (int b = 0; b < B; ++b) {
            const float df = d - cw[2 * b], coeff = cw[2 * b + 1];
            const float phi = expf(coeff * df * df);
            sd = fmaf(gb2[b], 2.f * coeff * df * phi, sd);
            sp = fmaf(gb2[b], phi, sp);
          }
          const float gd = sd * fcut + (sp + gb2[B]) * dfcut;
          const float gdr = gd0 * rx + gd1 * ry + gd2 * rz;
          const float inv3 = inv * inv * inv;
          gr0 = gd0 * inv - rx * (gdr * inv3) + gd * rx * inv;
          gr1 = gd1 * inv - ry * (gdr * inv3) + gd * ry * inv;
          gr2 = gd2 * inv - rz * (gdr * inv3) + gd * rz * inv;
        }
      }
      s_grij[t * 3 + 0] = gr0;
      s_grij[t * 3 + 1] = gr1;
      s_grij[t * 3 + 2] = gr2;
    }
    __syncthreads();
    // phase 5: position cotangents, one serial writer per component
    if (tid < 3) {
      for (int t = 0; t < n; ++t)
        if (s_src[t] >= 0) s_gRo[tid * P + s_src[t]] += s_grij[t * 3 + tid];
    } else if (tid >= 32 && tid < 35) {
      const int c = tid - 32;
      for (int t = 0; t < n; ++t)
        if (s_src[t] >= 0) {
          const int c9 = s_c9[t];
          s_gRd[(c9 * 3 + c) * P + s_dst[t] - s_dcol[c9] * P] -=
              s_grij[t * 3 + c];
        }
    }
  }
  if (run >= 0) {                      // close the last run
    const size_t ro = (own0 + run) * ldx;
    dx[ro + tid] = a_dx;
    if (part == 2) {
      dmu_out[ro + f] = a_m0;
      dmu_out[ro + F + f] = a_m1;
      dmu_out[ro + 2 * F + f] = a_m2;
    }
  }
  if constexpr (kWgrad) {              // this block's gFW partial
    double* out = gFWp + ((size_t)col * G + g) * B1 * D3 + tid;
    for (int b = 0; b < B1; ++b)
      out[(size_t)b * D3] = s_gfw[(size_t)b * D3 + tid];
  }
  if constexpr (kMode == kSrc) return;
  __syncthreads();
  for (int t = tid; t < 3 * (r1 - r0); t += nth) {
    const int c = t / (r1 - r0), r = r0 + t % (r1 - r0);
    gRo[(own0 * 3) + c * P + r] = s_gRo[c * P + r];
  }
  for (int t = tid; t < 27 * P; t += nth) {
    const int c9 = t / (3 * P);
    gRd[(((size_t)g * 9 + c9) * nx * ny + s_dcol[c9]) * 3 * P + t % (3 * P)] =
        s_gRd[t];
  }
}

KOffs make_koffs(const int* koffs) {
  KOffs ko;
  for (int i = 0; i < 10; ++i) ko.o[i] = koffs[i];
  return ko;
}

// the channel-major view of a packed geo [nx, ny, nch, Ktot]
template <typename T>
GeoView<T> packed_view(T* geo, int Ktot, int B1, int nch) {
  const size_t col = (size_t)nch * Ktot;
  return {geo, geo == nullptr ? nullptr : geo + (size_t)B1 * Ktot,
          col, 1, (size_t)Ktot, col, 1, (size_t)Ktot};
}

// the edge-major view of rbf_aug [nx, ny, Ktot, B+1] and dir [.., 3]
template <typename T>
GeoView<T> edge_view(T* rbf, T* dir, int Ktot, int B1) {
  return {rbf, dir, (size_t)Ktot * B1, (size_t)B1, 1,
          (size_t)Ktot * 3, 3, 1};
}

template <bool kGeo>
int launch_fwd(const float* x, const float* mu, const float* R,
               GeoView<const float> gv, const float* FW, const float* coff,
               const float* cw, const int* qcol, const int* dcol, float* dq,
               float* dmu, int nx, int ny, int P, int Ktot, const int* koffs,
               int F, int B, int ldx, int hx, int hy, float rc,
               cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)P * 128 + (B + 1) * 96 + kEdgesFwd * (B + 1) +
                       kEdgesFwd * 3) +
      sizeof(int) * 2 * kEdgesFwd;
  cudaError_t err = cudaFuncSetAttribute(
      msg_fwd_kernel<kGeo>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nx * ny, F / kTile);
  msg_fwd_kernel<kGeo><<<grid, kThreads, smem, stream>>>(
      x, mu, R, gv, FW, coff, cw, qcol, dcol, dq, dmu, nx, ny, P, Ktot,
      make_koffs(koffs), F, B, ldx, hx, hy, rc);
  return (int)cudaGetLastError();
}

// n_src: the source columns (one block row each)
template <int kMode, bool kWgrad>
int launch_bwd(const float* x, const float* mu, const float* R,
               GeoView<const float> gv, const float* FW, const float* coff,
               const float* cw, const int* qcol, const int* dcol,
               const int* esorted, const int* grp, const float* g_dq,
               const float* g_dmu, float* dx, float* dmu_out, float* gRo,
               float* gRd, GeoView<float> gg, double* gFWp, int nx, int ny,
               int P, int Ktot, const int* koffs, int G, int F, int B,
               int ldx, int n_src, float rc, cudaStream_t stream) {
  const int E = kEdgesBwd, B1 = B + 1, LD = 3 * F + 1;
  const size_t nR = kMode == kSrc ? 0 : 30 * (size_t)P;
  const size_t smem =
      sizeof(double) * (kWgrad ? (size_t)B1 * 3 * F : 0) +
      sizeof(float) * ((size_t)B1 * LD + (size_t)E * LD + 2 * E * B1 +
                       E * 3 + E + E * (F / 32) * 3 + E * 3 + nR) +
      sizeof(int) * (4 * E + 9);
  cudaError_t err = cudaFuncSetAttribute(
      msg_bwd_kernel<kMode, kWgrad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  msg_bwd_kernel<kMode, kWgrad><<<dim3(n_src, G), 3 * F, smem, stream>>>(
      x, mu, R, gv, FW, coff, cw, qcol, dcol, esorted, grp, g_dq, g_dmu, dx,
      dmu_out, gRo, gRd, gg, gFWp, nx, ny, P, Ktot, make_koffs(koffs), G, F,
      B, ldx, rc);
  return (int)cudaGetLastError();
}

// the kWgrad instance when a gFW partial buffer is given, else the plain one
template <int kMode>
int launch_bwd_any(const float* x, const float* mu, const float* R,
                   GeoView<const float> gv, const float* FW,
                   const float* coff, const float* cw, const int* qcol,
                   const int* dcol, const int* esorted, const int* grp,
                   const float* g_dq, const float* g_dmu, float* dx,
                   float* dmu_out, float* gRo, float* gRd, GeoView<float> gg,
                   double* gFWp, int nx, int ny, int P, int Ktot,
                   const int* koffs, int G, int F, int B, int ldx, int n_src,
                   float rc, cudaStream_t stream) {
  if (gFWp != nullptr && B + 1 > kMaxB1) return (int)cudaErrorInvalidValue;
  auto* fn = gFWp != nullptr ? launch_bwd<kMode, true>
                             : launch_bwd<kMode, false>;
  return fn(x, mu, R, gv, FW, coff, cw, qcol, dcol, esorted, grp, g_dq,
            g_dmu, dx, dmu_out, gRo, gRd, gg, gFWp, nx, ny, P, Ktot, koffs,
            G, F, B, ldx, n_src, rc, stream);
}

}  // namespace

extern "C" int spk_msg_fwd(const float* x, const float* mu, const float* R,
                           const float* FW, const float* coff, const float* cw,
                           const int* qcol, const int* dcol, float* dq,
                           float* dmu, int nx, int ny, int P, int Ktot,
                           const int* koffs, int F, int B, float rc,
                           cudaStream_t stream) {
  return launch_fwd<false>(x, mu, R, GeoView<const float>{}, FW, coff, cw,
                           qcol, dcol, dq, dmu, nx, ny, P, Ktot, koffs, F, B,
                           3 * F, 0, 0, rc, stream);
}

extern "C" int spk_msg_fwd_geo(const float* x, const float* mu,
                               const float* geo, const float* FW,
                               const int* qcol, const int* dcol, float* dq,
                               float* dmu, int nx, int ny, int P, int Ktot,
                               const int* koffs, int F, int B, int nch,
                               cudaStream_t stream) {
  return launch_fwd<true>(x, mu, nullptr, packed_view(geo, Ktot, B + 1, nch),
                          FW, nullptr, nullptr, qcol, dcol, dq, dmu, nx, ny,
                          P, Ktot, koffs, F, B, 3 * F, 0, 0, 0.f, stream);
}

extern "C" int spk_msg_fwd_edge(const float* xmu, const float* rbf,
                                const float* dir, const float* FW,
                                const int* qcol, const int* dcol, float* dq,
                                float* dmu, int nx, int ny, int P, int Ktot,
                                const int* koffs, int F, int B, int hx,
                                int hy, cudaStream_t stream) {
  return launch_fwd<true>(xmu, xmu + 3 * F, nullptr,
                          edge_view(rbf, dir, Ktot, B + 1), FW, nullptr,
                          nullptr, qcol, dcol, dq, dmu, nx, ny, P, Ktot,
                          koffs, F, B, 6 * F, hx, hy, 0.f, stream);
}

extern "C" int spk_msg_bwd(const float* x, const float* mu, const float* R,
                           const float* FW, const float* coff, const float* cw,
                           const int* qcol, const int* dcol,
                           const int* esorted, const int* grp,
                           const float* g_dq, const float* g_dmu, float* dx,
                           float* dmu_out, float* gRo, float* gRd,
                           double* gFWp, int nx, int ny, int P, int Ktot,
                           const int* koffs, int G, int F, int B, float rc,
                           cudaStream_t stream) {
  return launch_bwd_any<kFused>(x, mu, R, GeoView<const float>{}, FW, coff,
                                cw, qcol, dcol, esorted, grp, g_dq, g_dmu, dx,
                                dmu_out, gRo, gRd, GeoView<float>{}, gFWp, nx,
                                ny, P, Ktot, koffs, G, F, B, 3 * F, nx * ny,
                                rc, stream);
}

extern "C" int spk_msg_bwd_geores(const float* x, const float* mu,
                                  const float* geo, const float* FW,
                                  const float* cw, const int* qcol,
                                  const int* dcol, const int* esorted,
                                  const int* grp, const float* g_dq,
                                  const float* g_dmu, float* dx,
                                  float* dmu_out, float* gRo, float* gRd,
                                  double* gFWp, int nx, int ny, int P,
                                  int Ktot, const int* koffs, int G, int F,
                                  int B, int nch, float rc,
                                  cudaStream_t stream) {
  return launch_bwd_any<kGeoRes>(
      x, mu, nullptr, packed_view(geo, Ktot, B + 1, nch), FW, nullptr, cw,
      qcol, dcol, esorted, grp, g_dq, g_dmu, dx, dmu_out, gRo, gRd,
      GeoView<float>{}, gFWp, nx, ny, P, Ktot, koffs, G, F, B, 3 * F,
      nx * ny, rc, stream);
}

extern "C" int spk_msg_bwd_src(const float* x, const float* mu,
                               const float* geo, const float* FW,
                               const int* qcol, const int* dcol,
                               const int* esorted, const int* grp,
                               const float* g_dq, const float* g_dmu,
                               float* dx, float* dmu_out, float* ggeo,
                               double* gFWp, int nx, int ny, int P, int Ktot,
                               const int* koffs, int G, int F, int B, int nch,
                               cudaStream_t stream) {
  return launch_bwd_any<kSrc>(
      x, mu, nullptr, packed_view(geo, Ktot, B + 1, nch), FW, nullptr,
      nullptr, qcol, dcol, esorted, grp, g_dq, g_dmu, dx, dmu_out, nullptr,
      nullptr, packed_view(ggeo, Ktot, B + 1, nch), gFWp, nx, ny, P, Ktot,
      koffs, G, F, B, 3 * F, nx * ny, 0.f, stream);
}

// n_src source columns: nx*ny (wrap), (nx+2)*ny (halo_x) or
// (nx+2)*(ny+2) (halo_xy); dxmu [n_src * P, 6F]
extern "C" int spk_msg_bwd_edge(const float* xmu, const float* rbf,
                                const float* dir, const float* FW,
                                const int* qcol, const int* dcol,
                                const int* esorted, const int* grp,
                                const float* g_dq, const float* g_dmu,
                                float* dxmu, float* grbf, float* gdir,
                                double* gFWp, int nx, int ny, int P,
                                int Ktot, const int* koffs, int G, int F,
                                int B, int n_src, cudaStream_t stream) {
  return launch_bwd_any<kSrc>(
      xmu, xmu + 3 * F, nullptr, edge_view(rbf, dir, Ktot, B + 1), FW,
      nullptr, nullptr, qcol, dcol, esorted, grp, g_dq, g_dmu, dxmu,
      dxmu + 3 * F, nullptr, nullptr, edge_view(grbf, gdir, Ktot, B + 1),
      gFWp, nx, ny, P, Ktot, koffs, G, F, B, 6 * F, n_src, 0.f, stream);
}
