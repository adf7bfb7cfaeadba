// PaiNN column-layout message backward for Hopper (sm_90a), f32.
//
// K2 msg_bwd_kernel<kFused, W, ., kP> replaces the TPU kernel
//   schnetpack_tpu/ops/colblock_pallas.py:1239 _msg_fm_bwd_fused_kernel
//   (W = kWgrad: false without, true with the filter-weight cotangent).
// K7 msg_bwd_kernel<kGeoRes, W, ., kP> replaces
//   colblock_pallas.py:1570 _msg_fm_bwd_geores_kernel (wgrad off / on).
// K2 and K7 have an instance for each feature precision kP of the JAX
//   package's PIECES (bf16_mma.cuh, ops/precision.py): 3 f32; 2 the
//   destination cotangents and the source row's x and mu rounded to two
//   bf16 terms as they are loaded, and each edge's source cotangents
//   (dx's and dmu's terms) rounded so before their row sums; 1 those read
//   as bf16 and rounded to bf16, and P3's grbf and gFW as one bf16
//   tensor-core product with f32 sums (mma.sync m16n8k16, its operands
//   gW, FW_aug and rbf_aug rounded to bf16) in place of 3xTF32.  The
//   filter itself (P2), the geometry, its chain and the position
//   cotangents stay f32 in all three.
// K15 msg_bwd_kernel<kSrc, W, ., 3> replaces the two row-9 kernels
//   colblock_pallas.py:834 _msg_fm_bwd_src_kernel and :945
//   _msg_fm_bwd_src_res_kernel (they differ only in how the TPU stages
//   tables in VMEM): the message VJP on a geo of B+4 channels [rbf_aug,
//   dir] that autograd differentiates (any radial basis and cutoff).  It
//   runs K7's schedule and per-edge reductions but no geometry chain:
//   each real slot's geometry cotangent ggeo = [grbf (B+1), gdir (3)] is
//   written at the slot's own position (one writer per slot; the wrapper
//   zero-fills, so padded slots stay 0).
// K21 msg_bwd_kernel<kSrc, W, ., 3> on edge-major geometry replaces the row-12
//   backward colblock_pallas.py:391 _msg_bwd_kernel (launchers :478 and
//   colblock_shard.py:307 _msg_hx_bwd_call): dxmu over the whole source
//   table, grbf, gdir and (W) gFW.
// K19 msg_bwd_kernel<kCell, W, ., 3> is K21 in the cell index mode: it replaces
//   the 27-cell backward schnetpack_tpu/ops/painn_fused.py:185 _bwd_kernel
//   (launcher :283 _fused_bwd), on the stack view of cellblock.cuh: the
//   staged int of a slot is its code qidx, from which CellStack::decode forms
//   the slot's source row in the block's stack and its destination row (in
//   place of qcol and dcol).
// The forward body (K1, K6, K20, K18) and the layout are described in
// colblock_message.cu.
//
// The backward needs no source-index mode: its blocks own source columns of
// whichever table, whose slots the wrapper sorts by their row in it
// (``esorted``, ops/colblock.py::source_order; the stacks' rows for K19,
// ops/cellblock_gather.py::stack_source_schedule); block (col, g) owns the
// source rows [r0, r1) of column col and their slots esorted[e0, e1)
// (``grp[col][g]`` = (r0, e0), ``grp[col][g+1]`` = (r1, e1), ranges of
// about equal edge count).  It is the only writer of those rows of dx, dmu
// and gRo, and writes its destination-side position cotangents to its own
// partial gRd[g][c9][dest column] (summed by the wrapper).  K7 derives the
// geometry chain from the stored channels [phi*fcut (B), fcut, dir (3), d]
// with the same formulas as its twin (ops/colblock_message.py::
// msg_bwd_geores_plain), K2 from the positions:
//   phi    = K2: exp(coeff (d - c)^2); K7: stored * (1 / max(fcut, 1e-30))
//   dfcut  = fcut > 0 (K2: d < rc) ? -0.5 (pi/rc) sin(pi d/rc) : 0
//   gd     = sum_b grbf_b 2 coeff_b (d - c_b) phi_b * fcut
//            + (sum_b grbf_b phi_b + grbf_B) * dfcut
//   grij   = (gdir - dir (gdir . dir)) / max(d, 1e-6) + gd dir
// A slot out of the cutoff (K2: d >= rc; K7: a basis row of zeros) adds
// exactly 0 to dx, dmu, dR and gFW for finite inputs, so K2 and K7 skip
// it; K15/K21/K19 return ggeo for every real slot and skip none.
//
// What bounds it on the H100: per real slot the filter (B+1) x 3F FMAs
// twice (the recomputed filter and the basis cotangent grbf = gW FW^T) and
// the destination row's cotangents (4F floats, 2 KB a slot through L2);
// the wgrad instances add gFW = sum_e rbf_aug_e^T gW_e, another (B+1) x 3F
// FMAs.  At the bench that is ~0.1 ms of FP32 at the data sheet's peak.
//
// The design: one thread per feature f of all three parts; the block walks
// its slots in chunks of kBwdE = 16 (one m16 tile of the tensor-core
// products) and keeps FW_aug's rows in shared memory unless reading them
// through L1 fits more blocks on an SM (bwd_shape): the kernel is bound by
// latency, and three blocks of 128 threads an SM run it faster than two.
// Per chunk:
//   P1  the whole block stages the next chunk's indices and channels (or
//       offsets) with cp.async while this one runs, and forms this chunk's
//       geometry, the E slots over all threads (the bucket from compares);
//   P2  thread f loads its 3 x (B+1) filter weights into registers
//       (Filter<kRegB4>), and for kUB = 2 slots at a time loads their
//       cotangent rows together, forms their filters, sums dx and dmu of
//       the open source row in registers (stored once when the row's run
//       ends), writes the slots' filter cotangents gW [E][3F] to shared
//       memory and reduces their dir cotangents over the warp with
//       interleaved shuffles;
//   P3  grbf = gW FW^T ([16, 3F] x [3F, B+1]) and, in the wgrad instances,
//       the chunk's gFW = rbf_aug^T gW ([B+1, 16] x [16, 3F]) run on the
//       tensor cores as mma.sync m16n8k8 in 3xTF32 (f32-accurate: big and
//       small TF32 parts, three products), grbf split over the warps along
//       3F and summed in a fixed order, gFW's chunk sums added to the
//       block's f64 partial in shared memory (one writer per element);
//   P4  the geometry chain (or K15/K21/K19's ggeo store): a warp takes 4
//       slots, the lanes over the basis functions, their shuffle sums
//       interleaved, then lane j finishes slot j;
//   P5  the position cotangents of the chunk (done at the next chunk's P1),
//       summed straight into the block's own slices of gRo and of the
//       partial gRd: one warp for the own side, one for the destination
//       side; the lanes that hold equal rows find each other
//       (__match_any_sync) and the lowest adds the group's values in slot
//       order: one writer per element and one order per sum.
// No atomics anywhere: every result is deterministic from run to run.
// The body is colblock_message_bwd_body.cuh's, which the general instances
// (colblock_message_gen.cu) share.

#include "colblock_message.cuh"
#include "colblock_message_bwd_body.cuh"

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

// The tuned instances: msg_bwd_body (colblock_message_bwd_body.cuh) with
// one thread a feature of F = blockDim.x, FW_aug [B1][3F] and gFW's f64
// partial in shared memory
template <int kMode, bool kWgrad, int kB4, int kP>
__global__ void __maxnreg__(kMaxRegs)
    msg_bwd_kernel(const FeatT<kP>* __restrict__ x,
                   const FeatT<kP>* __restrict__ mu,
                   const float* __restrict__ R, GeoView<const float> gv,
                   const float* __restrict__ FW,
                   const float* __restrict__ coff,
                   const float* __restrict__ cw,
                   const int* __restrict__ qcol, const int* __restrict__ dcol,
                   const int* __restrict__ esorted,
                   const int* __restrict__ grp,
                   const FeatT<kP>* __restrict__ g_dq,
                   const FeatT<kP>* __restrict__ g_dmu, float* __restrict__ dx,
                   float* __restrict__ dmu_out, float* __restrict__ gRo,
                   float* __restrict__ gRd, GeoView<float> gg,
                   double* __restrict__ gFWp, int nx, int ny, int P, int Ktot,
                   KOffs ko, int G, int B, int ldx, float rc, int fwsm,
                   CellStack cs) {
  msg_bwd_body<kMode, kWgrad, kB4, kP, false, false>(
      x, mu, R, gv, FW, coff, cw, qcol, dcol, esorted, grp, g_dq, g_dmu, dx,
      dmu_out, gRo, gRd, gg, 0, 0, gFWp, nx, ny, P, Ktot, ko, G, blockDim.x,
      B, ldx, rc, fwsm, 1, cs, nullptr, gridDim.x, 0);
}

template <int kMode, bool kWgrad>
size_t bwd_smem(int F, int B, bool fwsm) {
  const int B1 = B + 1, D3 = 3 * F, n4 = (B1 + 3) / 4, NW = F / 32;
  const int NP = 8 * ((4 * n4 + 7) / 8), E = kBwdE;
  const size_t fl = (size_t)((fwsm ? B1 : 0) + E) * (D3 + 4) +
                    (size_t)NW * E * NP + 4 * E + (size_t)E * NW * 3 + 3 * E +
                    2 * (size_t)bwd_staged<kMode>(B1) * E;
  return (kWgrad ? sizeof(double) * B1 * D3 : 0) + 16 * (size_t)E * n4 +
         sizeof(float) * fl + sizeof(int) * (11 * (size_t)E + 9);
}

struct BwdShape {
  int fwsm;      // FW_aug's rows in shared memory (-1: nothing fits)
  size_t smem;   // bytes of shared memory a block
};

// Where FW_aug's rows go for (F, B): in shared memory unless reading them
// through L1 fits more resident blocks on an SM; worked out once per shape
// and instance on each device (the occupancy queries cost host time)
template <int kMode, bool kWgrad, int kB4, int kP>
BwdShape bwd_shape(int F, int B) {
  static int key[8][3];
  static BwdShape val[8];
  static int n_keys = 0;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < n_keys; ++i)
    if (key[i][0] == dev && key[i][1] == F && key[i][2] == B) return val[i];
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  BwdShape best{-1, 0};
  int best_blocks = 0;
  for (int fwsm = 1; fwsm >= 0; --fwsm) {
    const size_t smem = bwd_smem<kMode, kWgrad>(F, B, fwsm);
    if (smem > (size_t)optin) continue;
    int blocks = 0;
    if (cudaFuncSetAttribute(msg_bwd_kernel<kMode, kWgrad, kB4, kP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, msg_bwd_kernel<kMode, kWgrad, kB4, kP>, F, smem) !=
            cudaSuccess)
      continue;
    if (blocks > best_blocks) {
      best = {fwsm, smem};
      best_blocks = blocks;
    }
  }
  if (n_keys < 8) {
    key[n_keys][0] = dev;
    key[n_keys][1] = F;
    key[n_keys][2] = B;
    val[n_keys++] = best;
  }
  return best;
}

template <int kMode, bool kWgrad, int kB4, int kP>
int launch_bwd(const FeatT<kP>* x, const FeatT<kP>* mu, const float* R,
               GeoView<const float> gv, const float* FW, const float* coff,
               const float* cw, const int* qcol, const int* dcol,
               const int* esorted, const int* grp, const FeatT<kP>* g_dq,
               const FeatT<kP>* g_dmu, float* dx, float* dmu_out, float* gRo,
               float* gRd, GeoView<float> gg, double* gFWp, int nx, int ny,
               int P, int Ktot, const int* koffs, int G, int F, int B,
               int ldx, int n_src, float rc, CellStack cs,
               cudaStream_t stream) {
  if (F % 32 != 0 || F > kMaxThreads) return (int)cudaErrorInvalidValue;
  const BwdShape sh = bwd_shape<kMode, kWgrad, kB4, kP>(F, B);
  if (sh.fwsm < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      msg_bwd_kernel<kMode, kWgrad, kB4, kP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return (int)err;
  msg_bwd_kernel<kMode, kWgrad, kB4, kP>
      <<<dim3(n_src, G), F, sh.smem, stream>>>(
      x, mu, R, gv, FW, coff, cw, qcol, dcol, esorted, grp, g_dq, g_dmu, dx,
      dmu_out, gRo, gRd, gg, gFWp, nx, ny, P, Ktot, make_koffs(koffs), G, B,
      ldx, rc, sh.fwsm, cs);
  return (int)cudaGetLastError();
}

// the kWgrad instance when a gFW partial buffer is given, else the plain
// one; the register instance where FW_aug's rows fit it, else the L1 one
template <int kMode, int kP = 3>
int launch_bwd_any(const FeatT<kP>* x, const FeatT<kP>* mu, const float* R,
                   GeoView<const float> gv, const float* FW,
                   const float* coff, const float* cw, const int* qcol,
                   const int* dcol, const int* esorted, const int* grp,
                   const FeatT<kP>* g_dq, const FeatT<kP>* g_dmu, float* dx,
                   float* dmu_out, float* gRo, float* gRd, GeoView<float> gg,
                   double* gFWp, int nx, int ny, int P, int Ktot,
                   const int* koffs, int G, int F, int B, int ldx, int n_src,
                   float rc, CellStack cs, cudaStream_t stream) {
  const bool reg = B + 1 <= 4 * kRegB4;
  auto* fn = gFWp != nullptr
                 ? (reg ? launch_bwd<kMode, true, kRegB4, kP>
                        : launch_bwd<kMode, true, 0, kP>)
                 : (reg ? launch_bwd<kMode, false, kRegB4, kP>
                        : launch_bwd<kMode, false, 0, kP>);
  return fn(x, mu, R, gv, FW, coff, cw, qcol, dcol, esorted, grp, g_dq,
            g_dmu, dx, dmu_out, gRo, gRd, gg, gFWp, nx, ny, P, Ktot, koffs,
            G, F, B, ldx, n_src, rc, cs, stream);
}

template <int kMode, bool kWgrad, int kB4, int kP>
int bwd_blocks(int F, int B) {
  const BwdShape sh = bwd_shape<kMode, kWgrad, kB4, kP>(F, B);
  if (sh.fwsm < 0) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      msg_bwd_kernel<kMode, kWgrad, kB4, kP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, msg_bwd_kernel<kMode, kWgrad, kB4, kP>, F, sh.smem);
  return err != cudaSuccess ? -(int)err : n;
}

template <int kMode, int kP = 3>
int bwd_blocks_any(int wgrad, int F, int B) {
  const bool reg = B + 1 <= 4 * kRegB4;
  if (wgrad)
    return reg ? bwd_blocks<kMode, true, kRegB4, kP>(F, B)
               : bwd_blocks<kMode, true, 0, kP>(F, B);
  return reg ? bwd_blocks<kMode, false, kRegB4, kP>(F, B)
             : bwd_blocks<kMode, false, 0, kP>(F, B);
}

}  // namespace

// The entry points of this object's instances: SPK_PIECES 3 (this file)
// holds every form in f32; colblock_message_bwd_{mixed,bf16}.cu include it
// with SPK_PIECES 2 and 1 and hold K2 and K7 only, under the names with
// _mixed and _bf16 appended (three objects that nvcc builds in parallel).
// x, mu and the cotangents are bf16 in the bf16 object, else f32.
extern "C" int SPK_ENTRY(spk_msg_bwd)(
    const void* x, const void* mu, const float* R, const float* FW,
    const float* coff, const float* cw, const int* qcol, const int* dcol,
    const int* esorted, const int* grp, const void* g_dq, const void* g_dmu,
    float* dx, float* dmu_out, float* gRo, float* gRd, double* gFWp, int nx,
    int ny, int P, int Ktot, const int* koffs, int G, int F, int B, float rc,
    cudaStream_t stream) {
  using T = FeatT<SPK_PIECES>;
  return launch_bwd_any<kFused, SPK_PIECES>(
      static_cast<const T*>(x), static_cast<const T*>(mu), R,
      GeoView<const float>{}, FW, coff, cw, qcol, dcol, esorted, grp,
      static_cast<const T*>(g_dq), static_cast<const T*>(g_dmu), dx, dmu_out,
      gRo, gRd, GeoView<float>{}, gFWp, nx, ny, P, Ktot, koffs, G, F, B,
      3 * F, nx * ny, rc, CellStack{}, stream);
}

extern "C" int SPK_ENTRY(spk_msg_bwd_geores)(
    const void* x, const void* mu, const float* geo, const float* FW,
    const float* cw, const int* qcol, const int* dcol, const int* esorted,
    const int* grp, const void* g_dq, const void* g_dmu, float* dx,
    float* dmu_out, float* gRo, float* gRd, double* gFWp, int nx, int ny,
    int P, int Ktot, const int* koffs, int G, int F, int B, int nch, float rc,
    cudaStream_t stream) {
  using T = FeatT<SPK_PIECES>;
  return launch_bwd_any<kGeoRes, SPK_PIECES>(
      static_cast<const T*>(x), static_cast<const T*>(mu), nullptr,
      packed_view(geo, Ktot, B + 1, nch), FW, nullptr, cw, qcol, dcol,
      esorted, grp, static_cast<const T*>(g_dq), static_cast<const T*>(g_dmu),
      dx, dmu_out, gRo, gRd, GeoView<float>{}, gFWp, nx, ny, P, Ktot, koffs,
      G, F, B, 3 * F, nx * ny, rc, CellStack{}, stream);
}

// blocks of this object's backward instance for (mode, wgrad, F, B)
// resident on one SM (negative: a CUDA error, or it fits no block's shared
// memory; the mixed and bf16 objects hold K2 and K7 only)
extern "C" int SPK_ENTRY(spk_msg_bwd_blocks)(int mode, int wgrad, int F,
                                             int B) {
  if (mode == kFused) return bwd_blocks_any<kFused, SPK_PIECES>(wgrad, F, B);
  if (mode == kGeoRes)
    return bwd_blocks_any<kGeoRes, SPK_PIECES>(wgrad, F, B);
#if SPK_PIECES == 3
  if (mode == kSrc) return bwd_blocks_any<kSrc>(wgrad, F, B);
  return bwd_blocks_any<kCell>(wgrad, F, B);
#else
  return -(int)cudaErrorInvalidValue;
#endif
}

#if SPK_PIECES == 3
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
      koffs, G, F, B, 3 * F, nx * ny, 0.f, CellStack{}, stream);
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
      gFWp, nx, ny, P, Ktot, koffs, G, F, B, 6 * F, n_src, 0.f, CellStack{},
      stream);
}

// K19: the 27-cell layout as nx*ny stacks of nz*C rows (K18's view);
// dxmu [A', 6F], grbf and gdir at every real slot (the caller zero-fills)
extern "C" int spk_cell_msg_bwd(const float* xmu, const float* rbf,
                                const float* dir, const float* FW,
                                const int* qidx, const int* esorted,
                                const int* grp, const float* g_dq,
                                const float* g_dmu, float* dxmu, float* grbf,
                                float* gdir, double* gFWp, int nx, int ny,
                                int nz, int C, int K, int G, int F, int B,
                                cudaStream_t stream) {
  static const int no_koffs[10] = {};
  const int P = nz * C, Ktot = P * K;
  return launch_bwd_any<kCell>(
      xmu, xmu + 3 * F, nullptr, edge_view(rbf, dir, Ktot, B + 1), FW,
      nullptr, nullptr, qidx, nullptr, esorted, grp, g_dq, g_dmu, dxmu,
      dxmu + 3 * F, nullptr, nullptr, edge_view(grbf, gdir, Ktot, B + 1),
      gFWp, nx, ny, P, Ktot, no_koffs, G, F, B, 6 * F, nx * ny, 0.f,
      CellStack{nz, C, K}, stream);
}
#endif
