// General instances of the PaiNN column message kernels for Hopper
// (sm_90a): every feature width F >= 1 and basis size B >= 1.
//
// The tuned bodies (colblock_message.cu, colblock_message_bwd.cu) take one
// thread a feature with F % 32 == 0 and F <= 256, and their wgrad instances
// keep the f64 gFW partial [B+1][3F] in shared memory (B+1 <= 32).  These
// instances take every other shape, with the same forms, source-index
// modes and feature precisions, and replace the same TPU kernels:
// K1 msg_fwd_gen_kernel<kPosIn, kP>: colblock_pallas.py:1889
//   _msg_fm_fwd_fused_kernel;
// K6/K20 msg_fwd_gen_kernel<kGeoIn, kP>: colblock_pallas.py:568, :599,
//   :687 (packed geo) and :322 _msg_fwd_kernel (edge-major, row 12);
// K18 msg_fwd_gen_kernel<kCellIn, 3>: schnetpack_tpu/ops/painn_fused.py:116
//   _fwd_kernel;
// K2 msg_bwd_gen_kernel<kFused, W, kP>: colblock_pallas.py:1239
//   _msg_fm_bwd_fused_kernel;
// K7 msg_bwd_gen_kernel<kGeoRes, W, kP>: colblock_pallas.py:1570
//   _msg_fm_bwd_geores_kernel;
// K15/K21 msg_bwd_gen_kernel<kSrc, W, 3>: colblock_pallas.py:834
//   _msg_fm_bwd_src_kernel, :945 _msg_fm_bwd_src_res_kernel, :391
//   _msg_bwd_kernel and schnetpack_tpu/ops/colblock_shard.py:307
//   _msg_hx_bwd_call;
// K19 msg_bwd_gen_kernel<kCell, W, 3>: painn_fused.py:185 _bwd_kernel.
// The layout, the schedules, the formulas of the geometry chain and the
// rounding points of the reduced instances are those of the tuned bodies
// (see their headers).
//
// Both cut the features into Z = ceil(F / 256) tiles of NT threads (NT =
// F / Z rounded up to the warp); block (col, g, z) walks the slots of row
// range g of column col, as the tuned block does, for the features z NT +
// tid < F of its tile.  No atomics: every output element has one writer
// and every sum one order, so a run repeats bit for bit.
//
// The forward: per chunk of E slots (E from the shared memory that fits,
// at most 32) the block stages the slots' indices, geometry and basis rows
// [E][B+1] (where not even one slot's basis row fits shared memory, B+1
// above ~58,000, the rows of chunks of fewer slots go to the block's
// slice of a scratch in global memory, gen_launch.cuh::in_waves), then
// each thread walks the chunk in order for its feature (the
// lanes past F load feature F - 1 and store nothing): the filter (B+1
// FMAs a part, FW_aug through L1), the run sums of the open output row in
// registers, each row stored once when its run ends and rows without a
// slot written as zeros.  What bounds it: the (B+1) x 3F filter FMAs a
// slot at the FP32 rate, with the basis row re-read per feature.
//
// The backward runs the tuned msg_bwd_kernel's body (colblock_message_
// bwd.cu's design; one copy for both kernels, colblock_message_bwd_body.
// cuh) at any width: its chunks of 16 slots staged by cp.async under the
// chunk before, P1-P5 as there.  What bounds it: per live slot the filter and
// the basis cotangent grbf = gW FW^T, (B+1) x 3F FMAs each, and the
// destination row's cotangents (4F floats through L2); with gFW another
// (B+1) x 3F.  The design:
//   * the tile's features are zero-padded to NT: the wrapper pads FW_aug
//     to [B+1][Z][3][NT] once per parameter version (ops/colblock_message.
//     py::gen_padded_fw), and the lanes past F load zeros and store
//     nothing, so their filter cotangents gW are exact zeros in every
//     product;
//   * P3 (grbf, [16, 3NT] x [3NT, B+1]) and the wgrad instances' gFW
//     ([B+1, 16] x [16, 3NT], any B: every m16 tile of B+1) run on the
//     tensor cores, mma.sync in 3xTF32 (f32-accurate; bf16 at one piece);
//     the tile's FW_aug rows lie in shared memory or are read through L1,
//     whichever fits more blocks an SM (gb_plan); the warps split P3's
//     k-steps of 3NT, each into its own slice of grbf, added in P4, or,
//     where grbf has at least as many n8-tiles as the block has warps
//     (B+1 > 8 NW - 8), its n-tiles, into one slice (bwd_slices);
//   * the arrays that grow with B (the basis rows, grbf's slices, the
//     staged channels; bwd_basis_floats) lie in shared memory where a block
//     fits (B+1 up to ~700 at NT = 256, ~870 at NT = 32), else (kScr) in
//     the block's slice of a scratch in global memory (gen_launch.cuh::
//     in_waves), staged by loads and stores: every F >= 1 and B >= 1 runs;
//   * gFW's chunk sums are added to the block's f64 partial in shared
//     memory where it fits (else to the block's own slice in global
//     memory), each element by one thread, written out once;
//   * P2 keeps the thread's filter weights in registers where B+1 <= 24
//     (kB4, the tuned body's register instance; at F = 30 0.318 ms against
//     0.445 reading them for every slot) and loads the cotangent rows of 4
//     slots together; P4 chains 4 slots a warp; P5 adds the position
//     cotangents of equal rows in parallel, the lowest lane of each group
//     of equal rows in slot order;
//   * with Z > 1 each tile writes its own partial of the position
//     cotangents gRo, gRd (K2, K7; the geometry chain is linear in grbf
//     and gdir) and of ggeo (K15, K21, K19), summed by the wrapper.
// At F <= 32 a block is one warp, and 12 blocks (168 registers) share an
// SM.  Measured on the H100 (PERF.md): at F = 30 it runs as the tuned body
// does at F = 32 (0.318 against 0.317 ms on the bench box), bound by each
// warp's chain of dependent instructions through a chunk (P2 46%, P3 and
// P4 21% each); 128 or 96 registers for 16 or 19 blocks an SM ran slower
// (0.354, 0.396 ms).

#include "colblock_message.cuh"
#include "colblock_message_bwd_body.cuh"
#include "gen_launch.cuh"

// the feature precision of this object's backward instances: SPK_PIECES 3
// (this file) holds the forward and the f32 backward of every form;
// colblock_message_gen_{mixed,bf16}.cu include it with SPK_PIECES 2 and 1
// and hold K2's and K7's backward under spk_msg_bwd_gen_mixed and _bf16
// (three objects that nvcc builds in parallel)
#ifndef SPK_PIECES
#define SPK_PIECES 3
#endif
#if SPK_PIECES == 1
#define SPK_GEN_ENTRY(name) name##_bf16
#elif SPK_PIECES == 2
#define SPK_GEN_ENTRY(name) name##_mixed
#else
#define SPK_GEN_ENTRY(name) name
#endif

namespace {

constexpr int kGenTile = 256;  // features a block, at most
constexpr int kGenFwdE = 32;   // slots a forward chunk, at most
constexpr int kPosIn = 0, kGeoIn = 1, kCellIn = 2;

// the feature tiles of width F: Z tiles of NT threads
__host__ __device__ inline int gen_tiles(int F) {
  return (F + kGenTile - 1) / kGenTile;
}
__host__ __device__ inline int gen_threads(int F) {
  const int Z = gen_tiles(F), w = (F + Z - 1) / Z;
  return (w + 31) / 32 * 32;
}

// shared memory of a forward chunk of E slots, bytes: the basis rows
// [E][B+1] (not where they lie in global scratch, rbf_smem false), the
// directions, distances and three int arrays
inline size_t gen_fwd_smem(int E, int B, bool rbf_smem = true) {
  return sizeof(float) * (size_t)E * ((rbf_smem ? B + 1 : 0) + 4) +
         sizeof(int) * 3 * E;
}

// the basis rows of a forward chunk in global scratch, at most (bytes)
constexpr size_t kGenFwdScrBytes = (size_t)1 << 20;

// the largest chunk (at most emax slots) whose shared memory fits the
// device's opt-in limit; 0 when not even one slot does
template <typename Fn>
int gen_chunk(int emax, Fn smem) {
  const int optin = optin_smem();
  int E = emax;
  while (E > 0 && smem(E) > (size_t)optin) --E;
  return E;
}

#if SPK_PIECES == 3
template <int kIn, int kP>
__global__ void __launch_bounds__(kGenTile)
    msg_fwd_gen_kernel(const FeatT<kP>* __restrict__ x,
                       const FeatT<kP>* __restrict__ mu,
                       const float* __restrict__ R, GeoView<const float> gv,
                       const float* __restrict__ FW,
                       const float* __restrict__ coff,
                       const float* __restrict__ cw,
                       const int* __restrict__ qcol,
                       const int* __restrict__ dcol,
                       const int* __restrict__ dsorted,
                       const int* __restrict__ grp, float* __restrict__ dq,
                       float* __restrict__ dmu, int nx, int ny, int P,
                       int Ktot, KOffs ko, int G, int F, int B, int E,
                       int ldx, int hx, int hy, float rc, CellStack cs,
                       float* __restrict__ scr, int c0) {
  constexpr bool kGeo = kIn != kPosIn, kCellMode = kIn == kCellIn;
  extern __shared__ __align__(16) float gen_smem[];
  const int NT = blockDim.x, B1 = B + 1, D3 = 3 * F;
  const int col = c0 + blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int f = blockIdx.z * NT + tid;
  const bool fok = f < F;
  const int fl = fok ? f : F - 1;
  const int ci = col / ny, cj = col - ci * ny;
  const int* gb = grp + ((size_t)col * (G + 1) + g) * 2;
  const int r0 = gb[0], e0 = gb[1], r1 = gb[2], e1 = gb[3];

  float* s_dir = gen_smem;                   // [E][3]
  float* s_d = s_dir + 3 * E;                // [E] distance (K1)
  int* s_src = reinterpret_cast<int*>(s_d + E);  // [E] source row or -1
  int* s_dst = s_src + E;                    // [E] destination row
  int* s_k = s_dst + E;                      // [E] slot in the column
  // [E][B1] basis rows: in shared memory, or in the block's slice of scr
  float* s_rbf =
      scr ? scr + (((size_t)blockIdx.x * gridDim.y + g) * gridDim.z +
                   blockIdx.z) * E * B1
          : reinterpret_cast<float*>(s_k + E);

  const size_t row0 = (size_t)col * P;
  auto put = [&](int r, float vq, float v0, float v1, float v2) {
    if (!fok) return;
    const size_t rr = row0 + r;
    dq[rr * F + f] = vq;
    float* o = dmu + rr * D3 + f;
    o[0] = v0;
    o[F] = v1;
    o[2 * F] = v2;
  };

  int run = -1, next = r0;  // open destination row; first row not written
  float aq = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int base = e0; base < e1; base += E) {
    const int n = min(E, e1 - base);
    __syncthreads();  // the last chunk's readers are done
    if (tid < n) {  // slot base + tid: its rows, direction and liveness
      const int slot = dsorted[base + tid], k = slot - col * Ktot;
      const int qv = qcol[slot];
      int c9, srow = qv, dv;
      if constexpr (kCellMode) {
        cs.decode(k, qv, c9, srow, dv);
      } else {
        dv = dcol[slot];
        c9 = bucket_of(k, ko);
      }
      const int c3 = c9 / 3;
      int si = ci + c3 - 1 + hx, sj = cj + c9 - 3 * c3 - 1 + hy;
      if (!hx) si += si < 0 ? nx : (si >= nx ? -nx : 0);
      if (!hy) sj += sj < 0 ? ny : (sj >= ny ? -ny : 0);
      const int src = (si * (ny + 2 * hy) + sj) * P + srow;
      bool live = false;
      float* dr = s_dir + 3 * tid;
      if constexpr (kGeo) {
        for (int c = 0; c < B1; ++c) live |= *gv.at(col, k, c, B1) != 0.f;
        for (int c = 0; c < 3; ++c) dr[c] = *gv.at(col, k, B1 + c, B1);
      } else {
        const float* rs = R + (size_t)src * 3;
        const float* rd = R + (row0 + dv) * 3;
        const float* oc = coff + (size_t)col * 3 * Ktot + k;
        const float rx = rs[0] + oc[0] - rd[0];
        const float ry = rs[1] + oc[Ktot] - rd[1];
        const float rz = rs[2] + oc[2 * Ktot] - rd[2];
        const float d = sqrtf(rx * rx + ry * ry + rz * rz);
        live = d < rc;
        const float inv = 1.f / d;
        dr[0] = rx * inv;
        dr[1] = ry * inv;
        dr[2] = rz * inv;
        s_d[tid] = d;
      }
      s_src[tid] = live ? src : -1;
      s_dst[tid] = dv;
      s_k[tid] = k;
    }
    __syncthreads();
    for (int i = tid; i < n * B1; i += NT) {  // the chunk's basis rows
      const int t = i / B1, b = i - t * B1;
      float v = 0.f;
      if (s_src[t] >= 0) {
        if constexpr (kGeo) {
          v = *gv.at(col, s_k[t], b, B1);
        } else {
          const float d = s_d[t], fcut = 0.5f * (cos_cut(d, rc) + 1.f);
          if (b < B) {
            const float df = d - __ldg(cw + 2 * b);
            v = expf(__ldg(cw + 2 * b + 1) * df * df) * fcut;
          } else {
            v = fcut;
          }
        }
      }
      s_rbf[i] = v;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {  // feature f of the chunk's slots
      const int sv = s_src[t];
      if (sv < 0) continue;  // fcut = 0 adds exactly 0
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
      const float* rb = s_rbf + (size_t)t * B1;
      const float* fw = FW + fl;
      float wq = 0.f, wr = 0.f, wm = 0.f;
      for (int b = 0; b < B1; ++b) {
        const float r = rb[b];
        const float* p = fw + (size_t)b * D3;
        wq = fmaf(r, __ldg(p), wq);
        wr = fmaf(r, __ldg(p + F), wr);
        wm = fmaf(r, __ldg(p + 2 * F), wm);
      }
      const size_t row = (size_t)sv * ldx + fl;
      const float xq = feat<kP>(x + row), xr = feat<kP>(x + row + F);
      const float xm = feat<kP>(x + row + 2 * F);
      const float m0 = feat<kP>(mu + row), m1 = feat<kP>(mu + row + F);
      const float m2 = feat<kP>(mu + row + 2 * F);
      const float* dr = s_dir + 3 * t;
      const float xrw = xr * wr, xmw = xm * wm;
      if constexpr (kP == 3) {
        aq = fmaf(xq, wq, aq);
        a0 = fmaf(xmw, m0, fmaf(xrw, dr[0], a0));
        a1 = fmaf(xmw, m1, fmaf(xrw, dr[1], a1));
        a2 = fmaf(xmw, m2, fmaf(xrw, dr[2], a2));
      } else {  // the edge's message rounded to kP terms, then summed
        aq += pieces<kP>(xq * wq);
        a0 += pieces<kP>(fmaf(xmw, m0, xrw * dr[0]));
        a1 += pieces<kP>(fmaf(xmw, m1, xrw * dr[1]));
        a2 += pieces<kP>(fmaf(xmw, m2, xrw * dr[2]));
      }
    }
  }
  if (run >= 0) {
    put(run, aq, a0, a1, a2);
    next = run + 1;
  }
  for (; next < r1; ++next) put(next, 0.f, 0.f, 0.f, 0.f);
}
#endif  // SPK_PIECES == 3

// ------------------------------------------- the general message backward
// Shared memory of a backward block of NT threads (a feature tile): the
// f64 gFW partial [B1][3NT] (gsm, the wgrad instance), the tile's padded
// FW_aug rows [B1][3NT+4] (fwsm), the filter cotangents [E][3NT+4], the
// chunk's geometry, dir cotangents and grij, the int arrays, and (not
// scr) bwd_basis_floats
template <int kMode>
size_t gb_smem(int NT, int B, bool fwsm, bool gsm, bool scr) {
  const int B1 = B + 1, K3 = 3 * NT, NW = NT / 32, E = kBwdE;
  const size_t fl = (size_t)((fwsm ? B1 : 0) + E) * (K3 + 4) + 4 * E +
                    (size_t)E * NW * 3 + 3 * E +
                    (scr ? 0 : bwd_basis_floats<kMode>(NT, B));
  return (gsm ? sizeof(double) * B1 * K3 : 0) + sizeof(float) * fl +
         sizeof(int) * (11 * (size_t)E + 9);
}

// The general message backward: msg_bwd_body (colblock_message_bwd_body.
// cuh) for feature tile z of NT threads on FWp, FW_aug padded to
// [B1][Z][3][NT] (ops/colblock_message.py::gen_padded_fw, zero past F);
// gFW's f64 partial in shared memory (gsm) or the block's slice of gFWp;
// with kScr the arrays that grow with B in block (x, g, z)'s slice of scr.
// Block (x, g, z) takes column col0 + x of the n_src (col0: the wave's
// first).
template <int kMode, bool kWgrad, int kB4, int kP, bool kScr>
__global__ void __maxnreg__(kMaxRegs)
    msg_bwd_gen_kernel(const FeatT<kP>* __restrict__ x,
                       const FeatT<kP>* __restrict__ mu,
                       const float* __restrict__ R, GeoView<const float> gv,
                       const float* __restrict__ FWp,
                       const float* __restrict__ coff,
                       const float* __restrict__ cw,
                       const int* __restrict__ qcol,
                       const int* __restrict__ dcol,
                       const int* __restrict__ esorted,
                       const int* __restrict__ grp,
                       const FeatT<kP>* __restrict__ g_dq,
                       const FeatT<kP>* __restrict__ g_dmu,
                       float* __restrict__ dx, float* __restrict__ dmu_out,
                       float* __restrict__ gRo, float* __restrict__ gRd,
                       GeoView<float> gg, size_t gg_zr, size_t gg_zd,
                       double* __restrict__ gFWp, int nx, int ny, int P,
                       int Ktot, KOffs ko, int G, int F, int B, int ldx,
                       float rc, int fwsm, int gsm, CellStack cs, float* scr,
                       int n_src, int col0) {
  msg_bwd_body<kMode, kWgrad, kB4, kP, true, kScr>(
      x, mu, R, gv, FWp, coff, cw, qcol, dcol, esorted, grp, g_dq, g_dmu, dx,
      dmu_out, gRo, gRd, gg, gg_zr, gg_zd, gFWp, nx, ny, P, Ktot, ko, G, F,
      B, ldx, rc, fwsm, gsm, cs, scr, n_src, col0);
}

#if SPK_PIECES == 3
template <int kIn, int kP>
int launch_fwd_gen(const void* x, const void* mu, const float* R,
                   GeoView<const float> gv, const float* FW,
                   const float* coff, const float* cw, const int* qcol,
                   const int* dcol, const int* dsorted, const int* grp,
                   float* dq, float* dmu, int n_cols, int nx, int ny, int P,
                   int Ktot, const int* koffs, int G, int F, int B, int ldx,
                   int hx, int hy, float rc, CellStack cs,
                   cudaStream_t stream) {
  if (F < 1 || B < 1) return (int)cudaErrorInvalidValue;
  int E = gen_chunk(kGenFwdE, [&](int e) { return gen_fwd_smem(e, B); });
  const bool scr = E == 0;  // not one slot's basis row fits: global scratch
  if (scr)
    E = (int)std::max<size_t>(
        1, std::min<size_t>(kGenFwdE,
                            kGenFwdScrBytes / (sizeof(float) * (B + 1))));
  const size_t smem = gen_fwd_smem(E, B, !scr);
  const cudaError_t err =
      allow_smem((const void*)msg_fwd_gen_kernel<kIn, kP>);
  if (err != cudaSuccess) return (int)err;
  using T = FeatT<kP>;
  const int Z = gen_tiles(F);
  auto run = [&](float* s, int c0, int cols) {
    msg_fwd_gen_kernel<kIn, kP>
        <<<dim3(cols, G, Z), gen_threads(F), smem, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(mu), R, gv, FW,
            coff, cw, qcol, dcol, dsorted, grp, dq, dmu, nx, ny, P, Ktot,
            make_koffs(koffs), G, F, B, E, ldx, hx, hy, rc, cs, s, c0);
  };
  if (scr)  // waves of columns, each block's rows in its slice of scratch
    return (int)in_waves(n_cols, sizeof(float) * G * Z * E * (B + 1),
                         stream, run);
  run(nullptr, 0, n_cols);
  return (int)cudaGetLastError();
}

#endif  // SPK_PIECES == 3

// where a backward block keeps FW_aug's rows (fwsm) and gFW's partial
// (gsm), its shared memory and its resident blocks an SM (fwsm -1:
// nothing fits)
struct GbPlan {
  int fwsm, gsm;
  size_t smem;
  int blocks;
};

// The placement that fits the most blocks on an SM (shared memory first
// where equal), worked out once per (device, F, B) and instance: the
// occupancy queries cost host time
template <int kMode, bool kWgrad, int kB4, int kP, bool kScr>
GbPlan gb_plan(int F, int B) {
  static int key[16][3];
  static GbPlan val[16];
  static int n_keys = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < n_keys; ++i)
    if (key[i][0] == dev && key[i][1] == F && key[i][2] == B) return val[i];
  const void* kern =
      (const void*)msg_bwd_gen_kernel<kMode, kWgrad, kB4, kP, kScr>;
  const int NT = gen_threads(F), optin = optin_smem();
  GbPlan best{-1, 0, 0, 0};
  if (allow_smem(kern) == cudaSuccess) {
    for (int gsm = kWgrad ? 1 : 0; gsm >= 0; --gsm) {
      for (int fwsm = 1; fwsm >= 0; --fwsm) {
        const size_t smem = gb_smem<kMode>(NT, B, fwsm, gsm, kScr);
        int blocks = 0;
        if (smem > (size_t)optin ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, kern, NT, smem) != cudaSuccess)
          continue;
        if (blocks > best.blocks) best = {fwsm, gsm, smem, blocks};
      }
    }
  }
  if (n_keys < 16) {
    key[n_keys][0] = dev;
    key[n_keys][1] = F;
    key[n_keys][2] = B;
    val[n_keys++] = best;
  }
  return best;
}

template <int kMode, bool kWgrad, int kB4, int kP, bool kScr>
int launch_bwd_gen(const void* x, const void* mu, const float* R,
                   GeoView<const float> gv, const float* FWp,
                   const float* coff, const float* cw, const int* qcol,
                   const int* dcol, const int* esorted, const int* grp,
                   const void* g_dq, const void* g_dmu, float* dx,
                   float* dmu_out, float* gRo, float* gRd, GeoView<float> gg,
                   size_t gg_zr, size_t gg_zd, double* gFWp, int n_src,
                   int nx, int ny, int P, int Ktot, const int* koffs, int G,
                   int F, int B, int ldx, float rc, CellStack cs,
                   cudaStream_t stream) {
  if (F < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const GbPlan pl = gb_plan<kMode, kWgrad, kB4, kP, kScr>(F, B);
  if (pl.fwsm < 0) return (int)cudaErrorInvalidValue;
  using T = FeatT<kP>;
  const int Z = gen_tiles(F), NT = gen_threads(F);
  auto run = [&](float* scr, int col0, int cols) {
    msg_bwd_gen_kernel<kMode, kWgrad, kB4, kP, kScr>
        <<<dim3(cols, G, Z), NT, pl.smem, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(mu), R, gv, FWp,
            coff, cw, qcol, dcol, esorted, grp, static_cast<const T*>(g_dq),
            static_cast<const T*>(g_dmu), dx, dmu_out, gRo, gRd, gg, gg_zr,
            gg_zd, gFWp, nx, ny, P, Ktot, make_koffs(koffs), G, F, B, ldx,
            rc, pl.fwsm, pl.gsm, cs, scr, n_src, col0);
  };
  if constexpr (kScr)  // waves of columns, each column's G Z blocks a slice
    return (int)in_waves(
        n_src, sizeof(float) * G * Z * bwd_basis_floats<kMode>(NT, B), stream,
        run);
  run(nullptr, 0, n_src);
  return (int)cudaGetLastError();
}

// The instance that takes (F, B): kB4 where FW_aug's rows fit its
// registers (B+1 <= 24); else the one that reads them for every slot, with
// its arrays in shared memory where a block fits, else in global scratch
enum GbPick { kPickReg, kPickSmem, kPickScr };

template <int kMode, bool kWgrad, int kP>
GbPick gb_pick(int F, int B) {
  if (B + 1 <= 4 * kRegB4) return kPickReg;
  return gb_plan<kMode, kWgrad, 0, kP, false>(F, B).fwsm >= 0 ? kPickSmem
                                                               : kPickScr;
}

// the geometry views of a launch: none (K1, K2), the packed geo [nx, ny,
// nch, Ktot] (edge 0) or the edge-major rbf [.., Ktot, B+1], dir [.., 3]
template <typename T>
GeoView<T> gen_view(T* rbf, T* dir, int edge, int Ktot, int B, int nch) {
  if (rbf == nullptr) return GeoView<T>{};
  return edge ? edge_view(rbf, dir, Ktot, B + 1)
              : packed_view(rbf, Ktot, B + 1, nch);
}

// the wgrad instance or the plain one, each as gb_pick picks it
template <int kMode, int kP>
int bwd_gen_w(bool wgrad, const void* x, const void* mu, const float* R,
              GeoView<const float> gv, const float* FWp, const float* coff,
              const float* cw, const int* qcol, const int* dcol,
              const int* esorted, const int* grp, const void* g_dq,
              const void* g_dmu, float* dx, float* dmu_out, float* gRo,
              float* gRd, GeoView<float> gg, size_t gg_zr, size_t gg_zd,
              double* gFWp, int n_src, int nx, int ny, int P, int Ktot,
              const int* koffs, int G, int F, int B, int ldx, float rc,
              CellStack cs, cudaStream_t stream) {
  const GbPick pk = wgrad ? gb_pick<kMode, true, kP>(F, B)
                          : gb_pick<kMode, false, kP>(F, B);
  auto* fn = launch_bwd_gen<kMode, false, 0, kP, true>;
  if (wgrad)
    fn = pk == kPickReg    ? launch_bwd_gen<kMode, true, kRegB4, kP, false>
         : pk == kPickSmem ? launch_bwd_gen<kMode, true, 0, kP, false>
                           : launch_bwd_gen<kMode, true, 0, kP, true>;
  else if (pk != kPickScr)
    fn = pk == kPickReg ? launch_bwd_gen<kMode, false, kRegB4, kP, false>
                        : launch_bwd_gen<kMode, false, 0, kP, false>;
  return fn(x, mu, R, gv, FWp, coff, cw, qcol, dcol, esorted, grp, g_dq,
            g_dmu, dx, dmu_out, gRo, gRd, gg, gg_zr, gg_zd, gFWp, n_src, nx,
            ny, P, Ktot, koffs, G, F, B, ldx, rc, cs, stream);
}

#if SPK_PIECES == 3
template <int kMode, bool kWgrad>
GbPlan bwd_gen_plan(int F, int B) {
  switch (gb_pick<kMode, kWgrad, 3>(F, B)) {
    case kPickReg: return gb_plan<kMode, kWgrad, kRegB4, 3, false>(F, B);
    case kPickSmem: return gb_plan<kMode, kWgrad, 0, 3, false>(F, B);
    default: return gb_plan<kMode, kWgrad, 0, 3, true>(F, B);
  }
}

template <int kMode>
int bwd_gen_blocks(bool wgrad, int F, int B) {
  const GbPlan pl = wgrad ? bwd_gen_plan<kMode, true>(F, B)
                          : bwd_gen_plan<kMode, false>(F, B);
  return pl.fwsm < 0 ? -(int)cudaErrorInvalidValue : pl.blocks;
}
#endif

}  // namespace

#if SPK_PIECES == 3
// The general forward: in_mode 0 K1 (positions R, offsets coff, basis cw),
// 1 K6/K20 (rbf: the packed geo with edge 0, else the edge-major rbf and
// dir), 2 K18 (edge-major, the cell index mode of nz cells of C rows and K
// slots); pieces 3, 2 or 1 (K1 and K6; x and mu bf16 at 1).  ldx: the row
// stride of x and mu (3F, or 6F for the [x, mu] tables of K18/K20).
extern "C" int spk_msg_fwd_gen(int in_mode, int pieces, const void* x,
                               const void* mu, const float* R,
                               const float* rbf, const float* dir, int edge,
                               int nch, const float* FW, const float* coff,
                               const float* cw, const int* qcol,
                               const int* dcol, const int* dsorted,
                               const int* grp, float* dq, float* dmu, int nx,
                               int ny, int P, int Ktot, const int* koffs,
                               int G, int F, int B, int ldx, int hx, int hy,
                               float rc, int nz, int C, int K,
                               cudaStream_t stream) {
  const GeoView<const float> gv = gen_view(rbf, dir, edge, Ktot, B, nch);
  const CellStack cs{nz, C, K};
  const int nc = nx * ny;
#define SPK_FWD_GEN(IN, PC)                                                  \
  launch_fwd_gen<IN, PC>(x, mu, R, gv, FW, coff, cw, qcol, dcol, dsorted,  \
                         grp, dq, dmu, nc, nx, ny, P, Ktot, koffs, G, F, B, \
                         ldx, hx, hy, rc, cs, stream)
  if (in_mode == kPosIn) {
    if (pieces == 1) return SPK_FWD_GEN(kPosIn, 1);
    if (pieces == 2) return SPK_FWD_GEN(kPosIn, 2);
    return SPK_FWD_GEN(kPosIn, 3);
  }
  if (in_mode == kGeoIn) {
    if (pieces == 1) return SPK_FWD_GEN(kGeoIn, 1);
    if (pieces == 2) return SPK_FWD_GEN(kGeoIn, 2);
    return SPK_FWD_GEN(kGeoIn, 3);
  }
  return SPK_FWD_GEN(kCellIn, 3);
#undef SPK_FWD_GEN
}

#endif  // SPK_PIECES == 3

// The general backward: mode 0 K2, 1 K7 (the packed geo of B+5 channels),
// 2 K15/K21 (packed with edge 0, else edge-major; ggeo in grbf (and gdir)
// at a stride of gz_r (gz_d) floats a feature tile), 3 K19; this object's
// precision (``pieces`` must name it; the mixed and bf16 objects take K2
// and K7 only).  FWp: FW_aug padded to [B+1][Z][3][NT]
// (gen_padded_fw); gRo [Z][n_src][3][P] and gRd [Z][G][9][nx*ny][3][P]
// (K2, K7); gFWp [n_src * G][B+1][Z 3NT] f64 (each block fills its tile's
// columns), or null without wgrad.
extern "C" int SPK_GEN_ENTRY(spk_msg_bwd_gen)(
    int mode, int pieces, const void* x, const void* mu, const float* R,
    const float* rbf, const float* dir, int edge, int nch, const float* FWp,
    const float* coff, const float* cw, const int* qcol, const int* dcol,
    const int* esorted, const int* grp, const void* g_dq, const void* g_dmu,
    float* dx, float* dmu_out, float* gRo, float* gRd, float* grbf,
    float* gdir, long long gz_r, long long gz_d, double* gFWp, int n_src,
    int nx, int ny, int P, int Ktot, const int* koffs, int G, int F, int B,
    int ldx, float rc, int nz, int C, int K, cudaStream_t stream) {
  const GeoView<const float> gv = gen_view(rbf, dir, edge, Ktot, B, nch);
  const GeoView<float> gg = gen_view(grbf, gdir, edge, Ktot, B, nch);
  const CellStack cs{nz, C, K};
  const bool w = gFWp != nullptr;
#define SPK_BWD_GEN(MODE, PC)                                                \
  bwd_gen_w<MODE, PC>(w, x, mu, R, gv, FWp, coff, cw, qcol, dcol, esorted,  \
                      grp, g_dq, g_dmu, dx, dmu_out, gRo, gRd, gg,          \
                      (size_t)gz_r, (size_t)gz_d, gFWp, n_src, nx, ny, P,   \
                      Ktot, koffs, G, F, B, ldx, rc, cs, stream)
  if (pieces != SPK_PIECES) return (int)cudaErrorInvalidValue;
  if (mode == kFused) return SPK_BWD_GEN(kFused, SPK_PIECES);
  if (mode == kGeoRes) return SPK_BWD_GEN(kGeoRes, SPK_PIECES);
#if SPK_PIECES == 3
  if (mode == kSrc) return SPK_BWD_GEN(kSrc, 3);
  if (mode == kCell) return SPK_BWD_GEN(kCell, 3);
#endif
  return (int)cudaErrorInvalidValue;
#undef SPK_BWD_GEN
}

#if SPK_PIECES == 3
// blocks of a general instance resident on one SM (bwd 0: the forward of
// in_mode, 1: the f32 backward of mode, wgrad) at width F and basis B
extern "C" int spk_msg_gen_blocks(int bwd, int mode, int wgrad, int F,
                                  int B) {
  if (bwd) {
    if (mode == kFused) return bwd_gen_blocks<kFused>(wgrad, F, B);
    if (mode == kGeoRes) return bwd_gen_blocks<kGeoRes>(wgrad, F, B);
    if (mode == kSrc) return bwd_gen_blocks<kSrc>(wgrad, F, B);
    return bwd_gen_blocks<kCell>(wgrad, F, B);
  }
  const int E =
      gen_chunk(kGenFwdE, [&](int e) { return gen_fwd_smem(e, B); });
  const size_t smem = gen_fwd_smem(E, B);
  const void* k = mode == kPosIn ? (const void*)msg_fwd_gen_kernel<kPosIn, 3>
                                 : (const void*)msg_fwd_gen_kernel<kGeoIn, 3>;
  cudaError_t err = allow_smem(k);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k,
                                                        gen_threads(F), smem);
  return err != cudaSuccess ? -(int)err : n;
}
#endif  // SPK_PIECES == 3
