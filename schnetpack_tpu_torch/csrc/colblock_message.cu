// PaiNN column-layout message forward for Hopper (sm_90a), f32.
//
// K1 msg_fwd_kernel<kPosIn, ., kP> replaces the TPU kernel
//   schnetpack_tpu/ops/colblock_pallas.py:1889 _msg_fm_fwd_fused_kernel.
// K6 msg_fwd_kernel<kGeoIn, ., kP> replaces the three geo-tensor forwards
//   colblock_pallas.py:568 _msg_fm_fwd_kernel, :599 _msg_fm_fwd_res_kernel
//   and :687 _msg_fm_fwd_res_preoh_kernel (they differ only in how the TPU
//   stages tables in VMEM and builds one-hots; all compute K1's message on
//   a precomputed geo tensor).
// K1 and K6 have an instance for each feature precision kP of the JAX
//   package's PIECES (bf16_mma.cuh, ops/precision.py): 3 f32; 2 x and mu
//   rounded to two bf16 terms as they are loaded and each edge's message
//   rounded so before its row sum; 1 x and mu read as bf16 and each edge's
//   message rounded to bf16 before its f32 row sum.  The filter and the
//   geometry stay f32 in all three (the filter's bf16 products are the
//   backward's, colblock_message_bwd.cu).
// K20 msg_fwd_kernel<kGeoIn, ., 3> on edge-major geometry replaces the row-12
//   forward colblock_pallas.py:322 _msg_fwd_kernel (launchers :365 on one
//   device and colblock_shard.py:269 _msg_hx_fwd_call on halo slabs): the
//   message on xmu = [x, mu] [A'_src, 6F], rbf_aug [nx, ny, Ktot, B+1] and
//   dir [nx, ny, Ktot, 3].
// K18 msg_fwd_kernel<kCellIn, ., 3> is K20 in the cell index mode: it replaces
//   the 27-cell forward schnetpack_tpu/ops/painn_fused.py:116 _fwd_kernel
//   (launcher :149 _fused_fwd_call), on the stack view of cellblock.cuh.
// The backward body (K2, K7, K15, K21, K19) is colblock_message_bwd.cu.
//
// Layout (schnetpack_tpu_torch/ops/cellblock.py): atoms sorted into nx*ny
// xy-columns of P rows; edge slot k of column (i, j) lies in bucket c9 =
// (dx+1)*3 + (dy+1), slots [koffs[c9], koffs[c9+1]); its source is row
// qcol of the source column, its destination row dcol of column (i, j);
// qcol < 0 marks a padded slot.  The source column of bucket c9 is, in the
// three source-index modes (hx, hy):
//   wrap    (0, 0): ((i+dx) mod nx, (j+dy) mod ny) of an [nx, ny] table
//   halo_x  (1, 0): (i+dx+1, (j+dy) mod ny) of an [nx+2, ny] table
//   halo_xy (1, 1): (i+dx+1, j+dy+1) of an [nx+2, ny+2] table
// (the x- and xy-halo'd slabs of colblock_shard.py:111-128).  In the cell
// index mode (K18) the columns are the 27-cell layout's stacks, the source
// column the wrap mode's, and the staged int of a slot is its code qidx, from
// which CellStack::decode forms the bucket, the source row in the source
// stack and the destination row (in place of bucket_of and dcol).  K1
// recomputes the per-edge geometry (rij, d, dir, cosine cutoff, Gaussian
// basis) from the positions in f32, as the TPU kernel does; K6 reads the
// first B+4 channels [phi*fcut (B), fcut, dir (3)] of the packed geo [nx,
// ny, nch, Ktot] that K5 (colblock_geo.cu) writes, K20 and K18 the
// edge-major tensors.  They read them through a GeoView.
//
// What bounds it on the H100: per real slot the filter (B+1) x 3F FMAs
// and the source row's x and mu (3F floats each, 3 KB a slot, ~0.6 GB
// through L2 a call at the bench's 197,568 slots); the tables stay in the
// 50 MB L2.  The work is ~0.05 ms of FP32 at the data sheet's peak and the
// row traffic ~0.1 ms at L2 rates.
//
// The design: a destination-centric schedule (ops/colblock.py::
// destination_schedule, made once per layout) lists every real slot by
// (destination column, destination row) and cuts each column's rows into G
// ranges of about equal edge count.  One block per (column, range), one
// thread per feature f of all three parts: thread f keeps its filter
// weights FW_aug[:, f], [:, F+f], [:, 2F+f] in registers (Filter<kRegB4>,
// B+1 <= 24; Filter<0> reads them through L1 for a wider basis), so no
// filter product is repeated and a slot's basis row is 6 float4 broadcasts
// from shared memory for 63 FMAs.  Chunks of F slots: the next chunk's
// indices (and K1's periodic offsets, K6/K20's channels) are copied with
// cp.async into the other half of a double buffer while this chunk runs;
// each thread then takes one slot of the chunk, finds its bucket from
// compares, forms its geometry once (K1: the positions of the block's own
// and 9 source columns sit in shared memory) and keeps it only if it adds
// something: a slot with fcut = 0 (K1: d >= rc; K6/K20: a basis row of
// zeros) contributes exactly 0 for finite inputs, so the block's ballot
// compacts the chunk to the slots that do.  The message loop walks them in
// order, kUF slots' row loads in flight a thread, and sums the open
// destination row's dq and 3 dmu components in registers; each row is
// stored once when its run ends, and rows without a slot are written as
// zeros.  No atomics: every output row has one writer, every sum one order.

#include "colblock_message.cuh"

// the feature precision of this object's instances (see its entry points)
#ifndef SPK_PIECES
#define SPK_PIECES 3
#endif
#if SPK_PIECES == 1
#define SPK_ENTRY(name) name##_bf16
#elif SPK_PIECES == 2
#define SPK_ENTRY(name) name##_mixed
#else
#define SPK_ENTRY(name) name
#endif

namespace {

constexpr int kUF = 4;  // slots in flight per thread in the message loop

// what the forward reads per slot: positions and offsets (K1), a geometry
// view (K6, K20), or a geometry view in the cell index mode (K18)
constexpr int kPosIn = 0, kGeoIn = 1, kCellIn = 2;

template <int kIn, int kB4, int kP>
__global__ void __maxnreg__(kMaxRegs)
    msg_fwd_kernel(const FeatT<kP>* __restrict__ x,
                   const FeatT<kP>* __restrict__ mu,
                   const float* __restrict__ R, GeoView<const float> gv,
                   const float* __restrict__ FW,
                   const float* __restrict__ coff,
                   const float* __restrict__ cw,
                   const int* __restrict__ qcol, const int* __restrict__ dcol,
                   const int* __restrict__ dsorted,
                   const int* __restrict__ grp, float* __restrict__ dq,
                   float* __restrict__ dmu, int nx, int ny, int P, int Ktot,
                   KOffs ko, int G, int B, int ldx, int hx, int hy,
                   float rc, CellStack cs) {
  // Block (col, g) owns the destination rows [r0, r1) of column col and
  // their slots dsorted[e0, e1) (grp[col][g] = (r0, e0), grp[col][g+1] =
  // (r1, e1)).  blockDim = F threads = E slots a chunk.
  constexpr bool kGeo = kIn != kPosIn, kCell = kIn == kCellIn;
  extern __shared__ float4 smem4[];
  const int E = blockDim.x, F = E, D3 = 3 * F, B1 = B + 1;
  const int n4 = (B1 + 3) >> 2, nst = kGeo ? B1 + 3 : 3;
  const int col = blockIdx.x, g = blockIdx.y;
  const int ci = col / ny, cj = col - ci * ny;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* gb = grp + ((size_t)col * (G + 1) + g) * 2;
  const int r0 = gb[0], e0 = gb[1], r1 = gb[2], e1 = gb[3];

  float4* s_rbf = smem4;                                    // [E][n4]
  float* s_dir = reinterpret_cast<float*>(s_rbf + E * n4);  // [E][3]
  float* st_g = s_dir + 3 * E;           // [2][nst][E] staged channels
  float* s_R = st_g + 2 * nst * E;       // [10][P][3] (K1)
  int* s_src = reinterpret_cast<int*>(s_R + (kGeo ? 0 : 30 * P));  // [E]
  int* s_dst = s_src + E;                // [E] destination row
  int* st_q = s_dst + E;                 // [2][E] staged qcol (qidx)
  int* st_d = st_q + 2 * E;              // [2][E] staged dcol (not kCell)
  int* s_cnt = st_d + 2 * E;             // [E / 32] kept slots per warp

  Filter<kB4> fw;
  fw.load(FW, D3, B1, F, tid);
  if constexpr (!kGeo) {
    // K1: positions of the own column (index 0) and of the source column
    // of each bucket (1 + c9), read once per block
    for (int t = tid; t < 30 * P; t += E) {
      const int c = t / (3 * P), rem = t - c * 3 * P;
      int scol = col;
      if (c > 0) {
        const int c9 = c - 1;
        scol = ((ci + c9 / 3 - 1 + nx) % nx) * ny + (cj + c9 % 3 - 1 + ny) % ny;
      }
      s_R[t] = R[(size_t)scol * 3 * P + rem];
    }
  }

  // copy chunk [base, base + E)'s indices and channels (or offsets) into
  // half buf of the staging buffer; slot: this thread's slot of the chunk
  auto stage = [&](int buf, int base, int slot) {
    if (base + tid < e1) {
      cp_async4(st_q + buf * E + tid, qcol + slot);
      if constexpr (!kCell) cp_async4(st_d + buf * E + tid, dcol + slot);
      const int k = slot - col * Ktot;
      float* sg = st_g + buf * nst * E + tid;
      if constexpr (kGeo) {
        for (int c = 0; c < nst; ++c) cp_async4(sg + c * E, gv.at(col, k, c, B1));
      } else {
        const float* oc = coff + (size_t)col * 3 * Ktot + k;
        cp_async4(sg, oc);
        cp_async4(sg + E, oc + Ktot);
        cp_async4(sg + 2 * E, oc + 2 * Ktot);
      }
    }
    cp_async_commit();
  };
  auto slot_at = [&](int e) { return e < e1 ? dsorted[e] : 0; };

  const size_t row0 = (size_t)col * P;
  auto put = [&](int r, float vq, float v0, float v1, float v2) {
    const size_t rr = row0 + r;
    dq[rr * F + tid] = vq;
    float* o = dmu + rr * D3 + tid;
    o[0] = v0;
    o[F] = v1;
    o[2 * F] = v2;
  };

  int run = -1, next = r0;  // open destination row; first row not written
  float aq = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
  int sl_cur = slot_at(e0 + tid);
  stage(0, e0, sl_cur);
  int sl_nxt = slot_at(e0 + E + tid);
  int it = 0;
  for (int base = e0; base < e1; base += E, ++it) {
    const int buf = it & 1;
    int sl_nn = 0;
    if (base + E < e1) {
      stage(buf ^ 1, base + E, sl_nxt);
      sl_nn = slot_at(base + 2 * E + tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk staged (the first time also s_R)
    // phase A: slot base+tid's source row and geometry; keep it if it
    // adds something
    const int n = min(E, e1 - base);
    const float* sg = st_g + buf * nst * E + tid;
    bool live = false;
    int src = 0, dv = 0;
    float d = 1.f, rx = 0.f, ry = 0.f, rz = 0.f;
    if (tid < n) {
      const int qv = st_q[buf * E + tid];
      int c9, srow = qv;
      if constexpr (kCell) {
        cs.decode(sl_cur - col * Ktot, qv, c9, srow, dv);
      } else {
        dv = st_d[buf * E + tid];
        c9 = bucket_of(sl_cur - col * Ktot, ko);
      }
      const int c3 = c9 / 3;
      int si = ci + c3 - 1 + hx, sj = cj + c9 - 3 * c3 - 1 + hy;
      if (!hx) si += si < 0 ? nx : (si >= nx ? -nx : 0);
      if (!hy) sj += sj < 0 ? ny : (sj >= ny ? -ny : 0);
      src = (si * (ny + 2 * hy) + sj) * P + srow;
      if constexpr (kGeo) {
        for (int c = 0; c < B1; ++c) live |= sg[c * E] != 0.f;
      } else {
        const float* rs = s_R + ((1 + c9) * P + qv) * 3;
        const float* rd = s_R + dv * 3;
        rx = rs[0] + sg[0] - rd[0];
        ry = rs[1] + sg[E] - rd[1];
        rz = rs[2] + sg[2 * E] - rd[2];
        d = sqrtf(rx * rx + ry * ry + rz * rz);
        live = d < rc;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_cnt[warp] = __popc(bal);
    __syncthreads();
    int pos = __popc(bal & ((1u << lane) - 1u)), nl = 0;
    for (int w = 0; w < (E >> 5); ++w) {
      const int c = s_cnt[w];
      pos += w < warp ? c : 0;
      nl += c;
    }
    if (live) {  // the kept slots in chunk order
      s_src[pos] = src;
      s_dst[pos] = dv;
      float* rb = reinterpret_cast<float*>(s_rbf + pos * n4);
      float* dr = s_dir + pos * 3;
      if constexpr (kGeo) {
        for (int c = 0; c < B1; ++c) rb[c] = sg[c * E];
        for (int c = 0; c < 3; ++c) dr[c] = sg[(B1 + c) * E];
      } else {
        const float fcut = 0.5f * (cos_cut(d, rc) + 1.f);
        for (int b = 0; b < B; ++b) {
          const float df = d - __ldg(cw + 2 * b);
          rb[b] = expf(__ldg(cw + 2 * b + 1) * df * df) * fcut;
        }
        rb[B] = fcut;
        const float inv = 1.f / d;
        dr[0] = rx * inv;
        dr[1] = ry * inv;
        dr[2] = rz * inv;
      }
      for (int c = B1; c < 4 * n4; ++c) rb[c] = 0.f;
    }
    __syncthreads();
    // phase B: the kept slots in order, kUF row loads in flight; the open
    // destination row's sums stay in registers
    for (int t0 = 0; t0 < nl; t0 += kUF) {
      float xq[kUF], xr[kUF], xm[kUF], m0[kUF], m1[kUF], m2[kUF];
#pragma unroll
      for (int u = 0; u < kUF; ++u) {
        const size_t row = (size_t)s_src[min(t0 + u, nl - 1)] * ldx + tid;
        xq[u] = feat<kP>(x + row);
        xr[u] = feat<kP>(x + row + F);
        xm[u] = feat<kP>(x + row + 2 * F);
        m0[u] = feat<kP>(mu + row);
        m1[u] = feat<kP>(mu + row + F);
        m2[u] = feat<kP>(mu + row + 2 * F);
      }
      float wq[kUF], wr[kUF], wm[kUF];
      int rows[kUF];
#pragma unroll
      for (int u = 0; u < kUF; ++u) rows[u] = min(t0 + u, nl - 1);
      fw.apply_n(s_rbf, rows, n4, wq, wr, wm);
#pragma unroll
      for (int u = 0; u < kUF; ++u) {
        const int t = t0 + u;
        if (t >= nl) break;
        const int dt = s_dst[t];
        if (dt != run) {  // the run of row `run` ended
          if (run >= 0) {
            put(run, aq, a0, a1, a2);
            next = run + 1;
          }
          for (; next < dt; ++next) put(next, 0.f, 0.f, 0.f, 0.f);
          run = dt;
          aq = a0 = a1 = a2 = 0.f;
        }
        const float* dr = s_dir + t * 3;
        const float xrw = xr[u] * wr[u], xmw = xm[u] * wm[u];
        if constexpr (kP == 3) {
          aq = fmaf(xq[u], wq[u], aq);
          a0 = fmaf(xmw, m0[u], fmaf(xrw, dr[0], a0));
          a1 = fmaf(xmw, m1[u], fmaf(xrw, dr[1], a1));
          a2 = fmaf(xmw, m2[u], fmaf(xrw, dr[2], a2));
        } else {  // the edge's message rounded to kP terms, then summed
          aq += pieces<kP>(xq[u] * wq[u]);
          a0 += pieces<kP>(fmaf(xmw, m0[u], xrw * dr[0]));
          a1 += pieces<kP>(fmaf(xmw, m1[u], xrw * dr[1]));
          a2 += pieces<kP>(fmaf(xmw, m2[u], xrw * dr[2]));
        }
      }
    }
    sl_cur = sl_nxt;
    sl_nxt = sl_nn;
  }
  if (run >= 0) {
    put(run, aq, a0, a1, a2);
    next = run + 1;
  }
  for (; next < r1; ++next) put(next, 0.f, 0.f, 0.f, 0.f);
}

template <bool kGeo>
size_t fwd_smem(int F, int B, int P) {
  const int n4 = (B + 4) / 4, nst = kGeo ? B + 4 : 3;
  return 16 * (size_t)F * n4 +
         sizeof(float) * ((size_t)3 * F + 2 * nst * F + (kGeo ? 0 : 30 * P)) +
         sizeof(int) * ((size_t)6 * F + kMaxThreads / 32);
}

template <int kIn, int kB4, int kP>
int launch_fwd(const FeatT<kP>* x, const FeatT<kP>* mu, const float* R,
               GeoView<const float> gv, const float* FW, const float* coff,
               const float* cw, const int* qcol, const int* dcol,
               const int* dsorted, const int* grp, float* dq, float* dmu,
               int nx, int ny, int P, int Ktot, const int* koffs, int G,
               int F, int B, int ldx, int hx, int hy, float rc, CellStack cs,
               cudaStream_t stream) {
  if (F % 32 != 0 || F > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem<kIn != kPosIn>(F, B, P);
  cudaError_t err = cudaFuncSetAttribute(
      msg_fwd_kernel<kIn, kB4, kP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  msg_fwd_kernel<kIn, kB4, kP><<<dim3(nx * ny, G), F, smem, stream>>>(
      x, mu, R, gv, FW, coff, cw, qcol, dcol, dsorted, grp, dq, dmu, nx, ny,
      P, Ktot, make_koffs(koffs), G, B, ldx, hx, hy, rc, cs);
  return (int)cudaGetLastError();
}

// the register instance where FW_aug's rows fit it, else the L1 one
template <int kIn, int kP = 3>
int launch_fwd_any(const FeatT<kP>* x, const FeatT<kP>* mu, const float* R,
                   GeoView<const float> gv, const float* FW,
                   const float* coff, const float* cw, const int* qcol,
                   const int* dcol, const int* dsorted, const int* grp,
                   float* dq, float* dmu, int nx, int ny, int P, int Ktot,
                   const int* koffs, int G, int F, int B, int ldx, int hx,
                   int hy, float rc, CellStack cs, cudaStream_t stream) {
  auto* fn = B + 1 <= 4 * kRegB4 ? launch_fwd<kIn, kRegB4, kP>
                                 : launch_fwd<kIn, 0, kP>;
  return fn(x, mu, R, gv, FW, coff, cw, qcol, dcol, dsorted, grp, dq, dmu,
            nx, ny, P, Ktot, koffs, G, F, B, ldx, hx, hy, rc, cs, stream);
}

template <int kIn, int kB4, int kP>
int fwd_blocks(int F, int B, int P) {
  const size_t smem = fwd_smem<kIn != kPosIn>(F, B, P);
  cudaError_t err = cudaFuncSetAttribute(
      msg_fwd_kernel<kIn, kB4, kP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, msg_fwd_kernel<kIn, kB4, kP>, F, smem);
  return err != cudaSuccess ? -(int)err : n;
}

template <int kIn, int kP = 3>
int fwd_blocks_any(int F, int B, int P) {
  return B + 1 <= 4 * kRegB4 ? fwd_blocks<kIn, kRegB4, kP>(F, B, P)
                             : fwd_blocks<kIn, 0, kP>(F, B, P);
}

}  // namespace

// The entry points of this object's instances: SPK_PIECES 3 (this file)
// holds every form in f32; colblock_message_{mixed,bf16}.cu include it with
// SPK_PIECES 2 and 1 and hold K1 and K6 only, under the names with _mixed
// and _bf16 appended (three objects that nvcc builds in parallel).  x and
// mu are bf16 in the bf16 object, else f32.
extern "C" int SPK_ENTRY(spk_msg_fwd)(
    const void* x, const void* mu, const float* R, const float* FW,
    const float* coff, const float* cw, const int* qcol, const int* dcol,
    const int* dsorted, const int* grp, float* dq, float* dmu, int nx, int ny,
    int P, int Ktot, const int* koffs, int G, int F, int B, float rc,
    cudaStream_t stream) {
  using T = FeatT<SPK_PIECES>;
  return launch_fwd_any<kPosIn, SPK_PIECES>(
      static_cast<const T*>(x), static_cast<const T*>(mu), R,
      GeoView<const float>{}, FW, coff, cw, qcol, dcol, dsorted, grp, dq, dmu,
      nx, ny, P, Ktot, koffs, G, F, B, 3 * F, 0, 0, rc, CellStack{}, stream);
}

extern "C" int SPK_ENTRY(spk_msg_fwd_geo)(
    const void* x, const void* mu, const float* geo, const float* FW,
    const int* qcol, const int* dcol, const int* dsorted, const int* grp,
    float* dq, float* dmu, int nx, int ny, int P, int Ktot, const int* koffs,
    int G, int F, int B, int nch, cudaStream_t stream) {
  using T = FeatT<SPK_PIECES>;
  return launch_fwd_any<kGeoIn, SPK_PIECES>(
      static_cast<const T*>(x), static_cast<const T*>(mu), nullptr,
      packed_view(geo, Ktot, B + 1, nch), FW, nullptr, nullptr, qcol, dcol,
      dsorted, grp, dq, dmu, nx, ny, P, Ktot, koffs, G, F, B, 3 * F, 0, 0,
      0.f, CellStack{}, stream);
}

// blocks of this object's forward instance for (mode, F, B, P) resident
// on one SM (mode: 0 K1, 1 K6/K20, 2 K18; the mixed and bf16 objects hold
// K1 and K6 only; negative: a CUDA error)
extern "C" int SPK_ENTRY(spk_msg_fwd_blocks)(int mode, int F, int B, int P) {
  if (mode == kPosIn) return fwd_blocks_any<kPosIn, SPK_PIECES>(F, B, P);
  if (mode == kGeoIn) return fwd_blocks_any<kGeoIn, SPK_PIECES>(F, B, P);
#if SPK_PIECES == 3
  return fwd_blocks_any<kCellIn>(F, B, P);
#else
  return -(int)cudaErrorInvalidValue;
#endif
}

#if SPK_PIECES == 3
extern "C" int spk_msg_fwd_edge(const float* xmu, const float* rbf,
                                const float* dir, const float* FW,
                                const int* qcol, const int* dcol,
                                const int* dsorted, const int* grp, float* dq,
                                float* dmu, int nx, int ny, int P, int Ktot,
                                const int* koffs, int G, int F, int B, int hx,
                                int hy, cudaStream_t stream) {
  return launch_fwd_any<kGeoIn>(xmu, xmu + 3 * F, nullptr,
                                edge_view(rbf, dir, Ktot, B + 1), FW, nullptr,
                                nullptr, qcol, dcol, dsorted, grp, dq, dmu,
                                nx, ny, P, Ktot, koffs, G, F, B, 6 * F, hx,
                                hy, 0.f, CellStack{}, stream);
}

// K18: the 27-cell layout's xmu [A', 6F], rbf [A', K, B+1], dir [A', K, 3]
// and qidx [A', K] as nx*ny stacks of nz*C rows; dq, dmu [A', .]
extern "C" int spk_cell_msg_fwd(const float* xmu, const float* rbf,
                                const float* dir, const float* FW,
                                const int* qidx, const int* dsorted,
                                const int* grp, float* dq, float* dmu,
                                int nx, int ny, int nz, int C, int K, int G,
                                int F, int B, cudaStream_t stream) {
  static const int no_koffs[10] = {};
  const int P = nz * C, Ktot = P * K;
  return launch_fwd_any<kCellIn>(xmu, xmu + 3 * F, nullptr,
                                 edge_view(rbf, dir, Ktot, B + 1), FW,
                                 nullptr, nullptr, qidx, nullptr, dsorted,
                                 grp, dq, dmu, nx, ny, P, Ktot, no_koffs, G,
                                 F, B, 6 * F, 0, 0, 0.f, CellStack{nz, C, K},
                                 stream);
}
#endif
