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
// K2 msg_bwd_gen_kernel<kFused, W, kP>: colblock_pallas.py:1239;
// K7 msg_bwd_gen_kernel<kGeoRes, W, kP>: colblock_pallas.py:1570;
// K15/K21 msg_bwd_gen_kernel<kSrc, W, 3>: colblock_pallas.py:834, :945
//   and :391 _msg_bwd_kernel;
// K19 msg_bwd_gen_kernel<kCell, W, 3>: painn_fused.py:185 _bwd_kernel.
// The layout, the schedules, the formulas of the geometry chain and the
// rounding points of the reduced instances are those of the tuned bodies
// (see their headers); the arithmetic is plain f32 FMAs (f64 for gFW).
//
// The design: the features are cut into Z = ceil(F / 256) tiles of NT
// threads (NT = F / Z rounded up to the warp); block (col, g, z) walks the
// slots of row range g of column col, as the tuned block does, for the
// features z NT + tid < F of its tile (the lanes past F load feature F - 1
// and store nothing).  Per chunk of E slots (E from the shared memory that
// fits, at most 32 forward and 16 backward) the block stages the slots'
// indices, geometry and basis rows [E][B+1] in shared memory, then each
// thread walks the chunk in order for its feature: the filter (B+1 FMAs a
// part), the run sums of the open output row in registers, each row
// stored once when its run ends and rows without a slot written as zeros.
// The backward's sums over the features of a slot (grbf = gW FW^T, the
// direction cotangent) go through shared memory [E][3][NT] and are summed
// per slot in feature order in f64 (as the geometry chain's sums over the
// basis; f32 chains this long missed the float64 twin's position
// cotangent by more than 1e-5 at F = 50 on the H100); those over the tiles are the wrapper's: each
// z writes its own partial of the position cotangents gRo, gRd (K2, K7;
// the geometry chain is linear in grbf and gdir) and of ggeo (K15, K21,
// K19) where Z > 1.  The wgrad instances add each chunk's gFW sums into
// the block's own f64 partial [B+1][3F] in global memory, each element by
// the one thread of its feature: any B.  No atomics: every output element
// has one writer and every sum one order.
//
// What bounds them on the H100: as the tuned bodies, the (B+1) x 3F
// filter FMAs per slot (twice backward, three times with gFW) at the FP32
// rate; these instances also re-read each slot's basis row per feature
// from shared memory and the filter weights from L1, and recompute the
// geometry in every feature tile.

#include "colblock_message.cuh"

namespace {

constexpr int kGenTile = 256;  // features a block, at most
constexpr int kGenFwdE = 32;   // slots a forward chunk, at most
constexpr int kGenBwdE = 16;   // slots a backward chunk, at most
constexpr int kPosIn = 0, kGeoIn = 1, kCellIn = 2;

// the feature tiles of width F: Z tiles of NT threads
__host__ __device__ inline int gen_tiles(int F) {
  return (F + kGenTile - 1) / kGenTile;
}
__host__ __device__ inline int gen_threads(int F) {
  const int Z = gen_tiles(F), w = (F + Z - 1) / Z;
  return (w + 31) / 32 * 32;
}

// shared memory of a chunk of E slots, bytes
inline size_t gen_fwd_smem(int E, int B) {
  return sizeof(float) * (size_t)E * (B + 1 + 4) + sizeof(int) * 3 * E;
}
inline size_t gen_bwd_smem(int E, int NT, int B) {
  return sizeof(float) * (size_t)E * (2 * (B + 1) + 6 * NT + 10) +
         sizeof(int) * 4 * E;
}

// the largest chunk (at most emax slots) whose shared memory fits the
// device's opt-in limit; 0 when not even one slot does
template <typename Fn>
int gen_chunk(int emax, Fn smem) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int E = emax;
  while (E > 0 && smem(E) > (size_t)optin) --E;
  return E;
}

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
                       int ldx, int hx, int hy, float rc, CellStack cs) {
  constexpr bool kGeo = kIn != kPosIn, kCellMode = kIn == kCellIn;
  extern __shared__ __align__(16) float gen_smem[];
  const int NT = blockDim.x, B1 = B + 1, D3 = 3 * F;
  const int col = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int f = blockIdx.z * NT + tid;
  const bool fok = f < F;
  const int fl = fok ? f : F - 1;
  const int ci = col / ny, cj = col - ci * ny;
  const int* gb = grp + ((size_t)col * (G + 1) + g) * 2;
  const int r0 = gb[0], e0 = gb[1], r1 = gb[2], e1 = gb[3];

  float* s_rbf = gen_smem;                   // [E][B1] basis rows
  float* s_dir = s_rbf + (size_t)E * B1;     // [E][3]
  float* s_d = s_dir + 3 * E;                // [E] distance (K1)
  int* s_src = reinterpret_cast<int*>(s_d + E);  // [E] source row or -1
  int* s_dst = s_src + E;                    // [E] destination row
  int* s_k = s_dst + E;                      // [E] slot in the column

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

// a product operand as the instance rounds it: bf16 at one piece (the
// tuned bf16 instance's mma.sync operands), else as it is
template <int kP>
__device__ __forceinline__ float op(float v) {
  if constexpr (kP == 1) return bf16r(v);
  return v;
}

template <int kMode, bool kWgrad, int kP>
__global__ void __launch_bounds__(kGenTile)
    msg_bwd_gen_kernel(const FeatT<kP>* __restrict__ x,
                       const FeatT<kP>* __restrict__ mu,
                       const float* __restrict__ R, GeoView<const float> gv,
                       const float* __restrict__ FW,
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
                       int Ktot, KOffs ko, int G, int F, int B, int E,
                       int ldx, float rc, CellStack cs) {
  constexpr bool kChain = kMode == kFused || kMode == kGeoRes;
  extern __shared__ __align__(16) float gen_smem[];
  const int NT = blockDim.x, B1 = B + 1, D3 = 3 * F;
  const int col = blockIdx.x, g = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, f0 = z * NT, f = f0 + tid;
  const int nt = min(NT, F - f0);  // the tile's features
  const bool fok = f < F;
  const int fl = fok ? f : F - 1;
  const int* gb = grp + ((size_t)col * (G + 1) + g) * 2;
  const int r0 = gb[0], e0 = gb[1], r1 = gb[2], e1 = gb[3];

  float* s_rbf = gen_smem;                    // [E][B1] basis rows
  float* s_grbf = s_rbf + (size_t)E * B1;     // [E][B1] their cotangents
  float* s_gw = s_grbf + (size_t)E * B1;      // [E][3][NT] filter cotangent
  float* s_gp = s_gw + (size_t)E * 3 * NT;    // [E][3][NT] dir cotangent
  float* s_dir = s_gp + (size_t)E * 3 * NT;   // [E][3]
  float* s_gdir = s_dir + 3 * E;              // [E][3]
  float* s_grij = s_gdir + 3 * E;             // [E][3]
  float* s_d = s_grij + 3 * E;                // [E]
  int* s_src = reinterpret_cast<int*>(s_d + E);  // [E] own row or -1
  int* s_dst = s_src + E;                     // [E] global destination row
  int* s_c9 = s_dst + E;                      // [E]
  int* s_slot = s_c9 + E;                     // [E]

  const size_t own0 = (size_t)col * P;
  const int ncol = nx * ny;
  // this tile's slices of the position cotangents (gRo [Z][cols][3][P],
  // gRd [Z][G][9][nx*ny][3][P]), zeroed here: one writer per element
  float* o_gRo = gRo + ((size_t)z * gridDim.x + col) * 3 * P;
  float* o_gRd = gRd + ((size_t)z * G + g) * 9 * ncol * 3 * P;
  if constexpr (kChain) {
    const int ci = col / ny, cj = col - ci * ny;
    for (int t = tid; t < 3 * (r1 - r0); t += NT)
      o_gRo[t / (r1 - r0) * P + r0 + t % (r1 - r0)] = 0.f;
    for (int t = tid; t < 27 * P; t += NT) {
      const int c9 = t / (3 * P);
      const int dcl = ((ci - (c9 / 3 - 1) + nx) % nx) * ny +
                      (cj - (c9 % 3 - 1) + ny) % ny;
      o_gRd[((size_t)c9 * ncol + dcl) * 3 * P + t % (3 * P)] = 0.f;
    }
  }
  // this block's gFW partial [B1][3F]; thread f owns its three columns
  double* pw = kWgrad ? gFWp + ((size_t)col * G + g) * B1 * D3 : nullptr;
  if (kWgrad && fok)
    for (int b = 0; b < B1; ++b)
      for (int p = 0; p < 3; ++p) pw[(size_t)b * D3 + p * F + f] = 0.0;
  float* gg_r = gg.rbf == nullptr ? nullptr : gg.rbf + z * gg_zr;
  float* gg_d = gg.dir == nullptr ? nullptr : gg.dir + z * gg_zd;
  const GeoView<float> gz{gg_r,     gg_d,     gg.col_r, gg.slot_r,
                          gg.ch_r,  gg.col_d, gg.slot_d, gg.ch_d};

  auto put = [&](int r, float vq, float vr, float vm, float v0, float v1,
                 float v2) {
    if (!fok) return;
    const size_t ro = (own0 + r) * ldx + f;
    dx[ro] = vq;
    dx[ro + F] = vr;
    dx[ro + 2 * F] = vm;
    dmu_out[ro] = v0;
    dmu_out[ro + F] = v1;
    dmu_out[ro + 2 * F] = v2;
  };

  int run = -1, next = r0;  // open source row; first row not yet written
  float ax = 0.f, ar = 0.f, am = 0.f, b0 = 0.f, b1 = 0.f, b2 = 0.f;
  float xq = 0.f, xr = 0.f, xm = 0.f, mu0 = 0.f, mu1 = 0.f, mu2 = 0.f;
  const float pi_rc = kPi / rc;
  for (int base = e0; base < e1; base += E) {
    const int n = min(E, e1 - base);
    __syncthreads();  // the last chunk's readers are done
    // P1: slot base + tid's rows, geometry and liveness
    if (tid < n) {
      const int slot = esorted[base + tid];
      const int dcolumn = slot / Ktot, k = slot - dcolumn * Ktot;
      int qv, dv, c9;
      if constexpr (kMode == kCell) {
        cs.decode(k, qcol[slot], c9, qv, dv);
      } else {
        qv = qcol[slot];
        dv = dcol[slot];
        c9 = bucket_of(k, ko);
      }
      bool live = true;
      float d = 1.f, ux = 0.f, uy = 0.f, uz = 0.f;
      if constexpr (kMode == kFused) {
        const float* rs = R + (own0 + qv) * 3;
        const float* rd = R + ((size_t)dcolumn * P + dv) * 3;
        const float* oc = coff + (size_t)dcolumn * 3 * Ktot + k;
        const float rx = rs[0] + oc[0] - rd[0];
        const float ry = rs[1] + oc[Ktot] - rd[1];
        const float rz = rs[2] + oc[2 * Ktot] - rd[2];
        d = sqrtf(rx * rx + ry * ry + rz * rz);
        live = d < rc;
        const float inv = 1.f / d;
        ux = rx * inv;
        uy = ry * inv;
        uz = rz * inv;
      } else {
        if constexpr (kMode == kGeoRes) {
          live = false;
          for (int c = 0; c < B1; ++c)
            live |= *gv.at(dcolumn, k, c, B1) != 0.f;
          d = *gv.at(dcolumn, k, B1 + 3, B1);
        }
        ux = *gv.at(dcolumn, k, B1, B1);
        uy = *gv.at(dcolumn, k, B1 + 1, B1);
        uz = *gv.at(dcolumn, k, B1 + 2, B1);
      }
      s_src[tid] = live ? qv : -1;
      s_dst[tid] = dcolumn * P + dv;
      s_c9[tid] = c9;
      s_slot[tid] = slot;
      s_d[tid] = d;
      s_dir[3 * tid] = ux;
      s_dir[3 * tid + 1] = uy;
      s_dir[3 * tid + 2] = uz;
    }
    __syncthreads();
    for (int i = tid; i < n * B1; i += NT) {  // the chunk's basis rows
      const int t = i / B1, b = i - t * B1;
      float v = 0.f;
      if (s_src[t] >= 0) {
        if constexpr (kMode == kFused) {
          const float d = s_d[t], fcut = 0.5f * (cos_cut(d, rc) + 1.f);
          if (b < B) {
            const float df = d - __ldg(cw + 2 * b);
            v = expf(__ldg(cw + 2 * b + 1) * df * df) * fcut;
          } else {
            v = fcut;
          }
        } else {
          const int slot = s_slot[t], dcl = slot / Ktot;
          v = *gv.at(dcl, slot - dcl * Ktot, b, B1);
        }
      }
      s_rbf[i] = v;
    }
    __syncthreads();
    // P2: feature f of the chunk's slots in order: the run sums of the open
    // source row, the slot's filter cotangent and dir-cotangent terms
    for (int t = 0; t < n; ++t) {
      float* gw = s_gw + (size_t)t * 3 * NT + tid;
      float* gp = s_gp + (size_t)t * 3 * NT + tid;
      const int sv = s_src[t];
      if (sv < 0) {  // a slot out of the cutoff adds exactly 0
        gw[0] = gw[NT] = gw[2 * NT] = 0.f;
        gp[0] = gp[NT] = gp[2 * NT] = 0.f;
        continue;
      }
      const size_t dr = (size_t)s_dst[t];
      const float gq = feat_cg<kP>(g_dq + dr * F + fl);
      const FeatT<kP>* gm = g_dmu + dr * D3 + fl;
      const float g0 = feat_cg<kP>(gm), g1 = feat_cg<kP>(gm + F);
      const float g2 = feat_cg<kP>(gm + 2 * F);
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
      if (sv != run) {  // the run of row `run` ended
        if (run >= 0) {
          put(run, ax, ar, am, b0, b1, b2);
          next = run + 1;
        }
        for (; next < sv; ++next) put(next, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f);
        run = sv;
        ax = ar = am = b0 = b1 = b2 = 0.f;
        const size_t so = (own0 + sv) * ldx + fl;
        xq = feat_cg<kP>(x + so);
        xr = feat_cg<kP>(x + so + F);
        xm = feat_cg<kP>(x + so + 2 * F);
        mu0 = feat_cg<kP>(mu + so);
        mu1 = feat_cg<kP>(mu + so + F);
        mu2 = feat_cg<kP>(mu + so + 2 * F);
      }
      const float* dd = s_dir + 3 * t;
      const float gp1 = g0 * dd[0] + g1 * dd[1] + g2 * dd[2];
      const float gp2 = g0 * mu0 + g1 * mu1 + g2 * mu2;
      const float xmw = xm * wm, xrw = xr * wr;
      if constexpr (kP == 3) {
        ax = fmaf(gq, wq, ax);
        ar = fmaf(gp1, wr, ar);
        am = fmaf(gp2, wm, am);
        b0 = fmaf(g0, xmw, b0);
        b1 = fmaf(g1, xmw, b1);
        b2 = fmaf(g2, xmw, b2);
      } else {  // the edge's source cotangents rounded, then summed
        ax += pieces<kP>(gq * wq);
        ar += pieces<kP>(gp1 * wr);
        am += pieces<kP>(gp2 * wm);
        b0 += pieces<kP>(g0 * xmw);
        b1 += pieces<kP>(g1 * xmw);
        b2 += pieces<kP>(g2 * xmw);
      }
      const float on = fok ? 1.f : 0.f;  // lanes past F add nothing
      gw[0] = on * (gq * xq);
      gw[NT] = on * (gp1 * xr);
      gw[2 * NT] = on * (gp2 * xm);
      gp[0] = on * (g0 * xrw);
      gp[NT] = on * (g1 * xrw);
      gp[2 * NT] = on * (g2 * xrw);
    }
    __syncthreads();
    // P3: per slot grbf = gW FW^T and the dir cotangent, summed over the
    // tile's features in order; the wgrad instances' gFW += rbf^T gW
    for (int i = tid; i < n * B1; i += NT) {
      const int t = i / B1, b = i - t * B1;
      double acc = 0.0;
      if (s_src[t] >= 0) {
        const float* fw = FW + (size_t)b * D3 + f0;
        for (int p = 0; p < 3; ++p) {
          const float* a = s_gw + ((size_t)t * 3 + p) * NT;
          for (int j = 0; j < nt; ++j)
            acc = fma((double)op<kP>(a[j]),
                      (double)op<kP>(__ldg(fw + p * F + j)), acc);
        }
      }
      s_grbf[i] = (float)acc;
    }
    for (int i = tid; i < n * 3; i += NT) {
      const float* a = s_gp + (size_t)i * NT;
      double acc = 0.0;
      for (int j = 0; j < nt; ++j) acc += a[j];
      s_gdir[i] = (float)acc;
    }
    if (kWgrad && fok) {
      for (int b = 0; b < B1; ++b) {
        for (int p = 0; p < 3; ++p) {
          float acc = 0.f;
          for (int t = 0; t < n; ++t)
            acc = fmaf(op<kP>(s_rbf[(size_t)t * B1 + b]),
                       op<kP>(s_gw[((size_t)t * 3 + p) * NT + tid]), acc);
          pw[(size_t)b * D3 + p * F + f] += (double)acc;
        }
      }
    }
    __syncthreads();
    if constexpr (kChain) {
      // P4: slot tid's geometry chain (the tuned bodies' formulas)
      if (tid < n && s_src[tid] >= 0) {
        const int t = tid;
        const float* rbt = s_rbf + (size_t)t * B1;
        const float* gbt = s_grbf + (size_t)t * B1;
        const float dt = s_d[t], fct = rbt[B];
        const float inv_fc = 1.f / fmaxf(fct, 1e-30f);
        double sd = 0.0, sp = 0.0;
        for (int b = 0; b < B; ++b) {
          const float df = dt - __ldg(cw + 2 * b);
          const float coeff = __ldg(cw + 2 * b + 1);
          const float phi =
              kMode == kFused ? expf(coeff * df * df) : rbt[b] * inv_fc;
          sd = fma((double)gbt[b], (double)(2.f * coeff * df * phi), sd);
          sp = fma((double)gbt[b], (double)phi, sp);
        }
        const bool in = kMode == kFused ? dt < rc : fct > 0.f;
        const float dfcut = in ? -0.5f * pi_rc * sin_cut(dt, rc) : 0.f;
        const float gdd = (float)(sd * fct + (sp + gbt[B]) * dfcut);
        const float* u3 = s_dir + 3 * t;
        const float* gd = s_gdir + 3 * t;
        const float sdot = gd[0] * u3[0] + gd[1] * u3[1] + gd[2] * u3[2];
        const float inv = 1.f / fmaxf(dt, 1e-6f);
        float* gr = s_grij + 3 * t;
        for (int c = 0; c < 3; ++c)
          gr[c] = (gd[c] - u3[c] * sdot) * inv + gdd * u3[c];
      }
      __syncthreads();
      // P5: the position cotangents, one thread in slot order
      if (tid == 0) {
        for (int t = 0; t < n; ++t) {
          const int sv = s_src[t];
          if (sv < 0) continue;
          const float* gr = s_grij + 3 * t;
          const int dcl = s_dst[t] / P, dv = s_dst[t] - dcl * P;
          float* o = o_gRd + ((size_t)s_c9[t] * ncol + dcl) * 3 * P + dv;
          for (int c = 0; c < 3; ++c) {
            o_gRo[c * P + sv] += gr[c];
            o[c * P] -= gr[c];
          }
        }
      }
    } else {
      // P4: every real slot's geometry cotangent [grbf, gdir] (this tile's
      // partial where Z > 1)
      for (int i = tid; i < n * (B1 + 3); i += NT) {
        const int t = i / (B1 + 3), c = i - t * (B1 + 3);
        const int slot = s_slot[t], dcl = slot / Ktot, k = slot - dcl * Ktot;
        *gz.at(dcl, k, c, B1) =
            c < B1 ? s_grbf[(size_t)t * B1 + c] : s_gdir[3 * t + c - B1];
      }
    }
  }
  if (run >= 0) {  // close the last run
    put(run, ax, ar, am, b0, b1, b2);
    next = run + 1;
  }
  for (; next < r1; ++next) put(next, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f);
}

template <int kIn, int kP>
int launch_fwd_gen(const void* x, const void* mu, const float* R,
                   GeoView<const float> gv, const float* FW,
                   const float* coff, const float* cw, const int* qcol,
                   const int* dcol, const int* dsorted, const int* grp,
                   float* dq, float* dmu, int n_cols, int nx, int ny, int P,
                   int Ktot, const int* koffs, int G, int F, int B, int ldx,
                   int hx, int hy, float rc, CellStack cs,
                   cudaStream_t stream) {
  const int E = gen_chunk(kGenFwdE, [&](int e) { return gen_fwd_smem(e, B); });
  if (E == 0 || F < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = gen_fwd_smem(E, B);
  cudaError_t err = cudaFuncSetAttribute(
      msg_fwd_gen_kernel<kIn, kP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  using T = FeatT<kP>;
  msg_fwd_gen_kernel<kIn, kP>
      <<<dim3(n_cols, G, gen_tiles(F)), gen_threads(F), smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(mu), R, gv, FW,
          coff, cw, qcol, dcol, dsorted, grp, dq, dmu, nx, ny, P, Ktot,
          make_koffs(koffs), G, F, B, E, ldx, hx, hy, rc, cs);
  return (int)cudaGetLastError();
}

template <int kMode, bool kWgrad, int kP>
int launch_bwd_gen(const void* x, const void* mu, const float* R,
                   GeoView<const float> gv, const float* FW,
                   const float* coff, const float* cw, const int* qcol,
                   const int* dcol, const int* esorted, const int* grp,
                   const void* g_dq, const void* g_dmu, float* dx,
                   float* dmu_out, float* gRo, float* gRd, GeoView<float> gg,
                   size_t gg_zr, size_t gg_zd, double* gFWp, int n_src,
                   int nx, int ny, int P, int Ktot, const int* koffs, int G,
                   int F, int B, int ldx, float rc, CellStack cs,
                   cudaStream_t stream) {
  const int NT = gen_threads(F);
  const int E =
      gen_chunk(kGenBwdE, [&](int e) { return gen_bwd_smem(e, NT, B); });
  if (E == 0 || F < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = gen_bwd_smem(E, NT, B);
  cudaError_t err = cudaFuncSetAttribute(
      msg_bwd_gen_kernel<kMode, kWgrad, kP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  using T = FeatT<kP>;
  msg_bwd_gen_kernel<kMode, kWgrad, kP>
      <<<dim3(n_src, G, gen_tiles(F)), NT, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(mu), R, gv, FW,
          coff, cw, qcol, dcol, esorted, grp, static_cast<const T*>(g_dq),
          static_cast<const T*>(g_dmu), dx, dmu_out, gRo, gRd, gg, gg_zr,
          gg_zd, gFWp, nx, ny, P, Ktot, make_koffs(koffs), G, F, B, E, ldx,
          rc, cs);
  return (int)cudaGetLastError();
}

// the geometry views of a launch: none (K1, K2), the packed geo [nx, ny,
// nch, Ktot] (edge 0) or the edge-major rbf [.., Ktot, B+1], dir [.., 3]
template <typename T>
GeoView<T> gen_view(T* rbf, T* dir, int edge, int Ktot, int B, int nch) {
  if (rbf == nullptr) return GeoView<T>{};
  return edge ? edge_view(rbf, dir, Ktot, B + 1)
              : packed_view(rbf, Ktot, B + 1, nch);
}

template <int kMode, int kP>
int bwd_gen_w(bool wgrad, const void* x, const void* mu, const float* R,
              GeoView<const float> gv, const float* FW, const float* coff,
              const float* cw, const int* qcol, const int* dcol,
              const int* esorted, const int* grp, const void* g_dq,
              const void* g_dmu, float* dx, float* dmu_out, float* gRo,
              float* gRd, GeoView<float> gg, size_t gg_zr, size_t gg_zd,
              double* gFWp, int n_src, int nx, int ny, int P, int Ktot,
              const int* koffs, int G, int F, int B, int ldx, float rc,
              CellStack cs, cudaStream_t stream) {
  auto* fn = wgrad ? launch_bwd_gen<kMode, true, kP>
                   : launch_bwd_gen<kMode, false, kP>;
  return fn(x, mu, R, gv, FW, coff, cw, qcol, dcol, esorted, grp, g_dq,
            g_dmu, dx, dmu_out, gRo, gRd, gg, gg_zr, gg_zd, gFWp, n_src, nx,
            ny, P, Ktot, koffs, G, F, B, ldx, rc, cs, stream);
}

}  // namespace

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

// The general backward: mode 0 K2, 1 K7 (the packed geo of B+5 channels),
// 2 K15/K21 (packed with edge 0, else edge-major; ggeo in grbf (and gdir)
// at a stride of gz_r (gz_d) floats a feature tile), 3 K19; pieces as the
// forward's (K2 and K7).  gRo [Z][n_src][3][P] and gRd [Z][G][9][nx*ny][3]
// [P] (K2, K7); gFWp [n_src * G][B+1][3F] f64, or null without wgrad.
extern "C" int spk_msg_bwd_gen(
    int mode, int pieces, const void* x, const void* mu, const float* R,
    const float* rbf, const float* dir, int edge, int nch, const float* FW,
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
  bwd_gen_w<MODE, PC>(w, x, mu, R, gv, FW, coff, cw, qcol, dcol, esorted,   \
                      grp, g_dq, g_dmu, dx, dmu_out, gRo, gRd, gg,          \
                      (size_t)gz_r, (size_t)gz_d, gFWp, n_src, nx, ny, P,   \
                      Ktot, koffs, G, F, B, ldx, rc, cs, stream)
  if (mode == kFused) {
    if (pieces == 1) return SPK_BWD_GEN(kFused, 1);
    if (pieces == 2) return SPK_BWD_GEN(kFused, 2);
    return SPK_BWD_GEN(kFused, 3);
  }
  if (mode == kGeoRes) {
    if (pieces == 1) return SPK_BWD_GEN(kGeoRes, 1);
    if (pieces == 2) return SPK_BWD_GEN(kGeoRes, 2);
    return SPK_BWD_GEN(kGeoRes, 3);
  }
  if (mode == kSrc) return SPK_BWD_GEN(kSrc, 3);
  return SPK_BWD_GEN(kCell, 3);
#undef SPK_BWD_GEN
}

// blocks of a general instance resident on one SM (bwd 0: the forward of
// in_mode, 1: the backward of mode, wgrad) at width F and basis B
extern "C" int spk_msg_gen_blocks(int bwd, int mode, int wgrad, int F,
                                  int B) {
  const int NT = gen_threads(F);
  int n = 0;
  cudaError_t err;
  if (!bwd) {
    const int E =
        gen_chunk(kGenFwdE, [&](int e) { return gen_fwd_smem(e, B); });
    const size_t smem = gen_fwd_smem(E, B);
    auto* k = mode == kPosIn ? msg_fwd_gen_kernel<kPosIn, 3>
                             : msg_fwd_gen_kernel<kGeoIn, 3>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, NT, smem);
  } else {
    const int E =
        gen_chunk(kGenBwdE, [&](int e) { return gen_bwd_smem(e, NT, B); });
    const size_t smem = gen_bwd_smem(E, NT, B);
    auto* k = wgrad ? msg_bwd_gen_kernel<kFused, true, 3>
                    : msg_bwd_gen_kernel<kFused, false, 3>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, NT, smem);
  }
  return err != cudaSuccess ? -(int)err : n;
}
