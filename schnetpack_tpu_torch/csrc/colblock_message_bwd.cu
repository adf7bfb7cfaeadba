// PaiNN column-layout message backward for Hopper (sm_90a), f32.
//
// K2 msg_bwd_kernel<kFused, W, .> replaces the TPU kernel
//   schnetpack_tpu/ops/colblock_pallas.py:1239 _msg_fm_bwd_fused_kernel
//   (W = kWgrad: false without, true with the filter-weight cotangent).
// K7 msg_bwd_kernel<kGeoRes, W, .> replaces
//   colblock_pallas.py:1570 _msg_fm_bwd_geores_kernel (wgrad off / on).
// K15 msg_bwd_kernel<kSrc, W, .> replaces the two row-9 kernels
//   colblock_pallas.py:834 _msg_fm_bwd_src_kernel and :945
//   _msg_fm_bwd_src_res_kernel (they differ only in how the TPU stages
//   tables in VMEM): the message VJP on a geo of B+4 channels [rbf_aug,
//   dir] that autograd differentiates (any radial basis and cutoff).  It
//   runs K7's schedule and per-edge reductions but no geometry chain:
//   each real slot's geometry cotangent ggeo = [grbf (B+1), gdir (3)] is
//   written at the slot's own position (one writer per slot; the wrapper
//   zero-fills, so padded slots stay 0).
// K21 msg_bwd_kernel<kSrc, W, .> on edge-major geometry replaces the row-12
//   backward colblock_pallas.py:391 _msg_bwd_kernel (launchers :478 and
//   colblock_shard.py:307 _msg_hx_bwd_call): dxmu over the whole source
//   table, grbf, gdir and (W) gFW.
// The forward body (K1, K6, K20) and the layout are described in
// colblock_message.cu.
//
// The backward needs no source-index mode: its blocks own source columns of
// whichever table, whose slots the wrapper sorts by their row in it
// (``esorted``, ops/colblock.py::source_order); block (col, g) owns the
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
// it; K15/K21 return ggeo for every real slot and skip none.
//
// What bounds it on the H100: per real slot the filter (B+1) x 3F FMAs
// twice (the recomputed filter and the basis cotangent grbf = gW FW^T) and
// the destination row's cotangents (4F floats, 2 KB a slot through L2);
// the wgrad instances add gFW = sum_e rbf_aug_e^T gW_e, another (B+1) x 3F
// FMAs.  At the bench that is ~0.1 ms of FP32 at the data sheet's peak.
//
// The design: one thread per feature f of all three parts; the block walks
// its slots in chunks of kE = 16 (one m16 tile of the tensor-core
// products) and keeps FW_aug's rows in shared memory unless reading them
// through L1 fits more blocks on an SM (bwd_shape): the kernel is bound by
// latency, and three blocks of 128 threads an SM run it faster than two.
// Per chunk:
//   P1  the whole block stages the next chunk's indices and channels (or
//       offsets) with cp.async while this one runs, and forms this chunk's
//       geometry, the E slots over all threads (the bucket from compares);
//   P2  thread f loads its 3 x (B+1) filter weights into registers
//       (Filter<kRegB4>), and for kUB slots at a time loads their
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
//   P4  the geometry chain (or K15/K21's ggeo store): a warp takes kP4
//       slots, the lanes over the basis functions, their shuffle sums
//       interleaved, then lane j finishes slot j;
//   P5  the position cotangents of the chunk (done at the next chunk's P1),
//       summed straight into the block's own slices of gRo and of the
//       partial gRd: one warp for the own side, one for the destination
//       side; the lanes that hold equal rows find each other
//       (__match_any_sync) and the lowest adds the group's values in slot
//       order: one writer per element and one order per sum.
// No atomics anywhere: every result is deterministic from run to run.

#include "colblock_message.cuh"

namespace {

constexpr int kE = 16;        // slots a chunk (one m16 tile)
constexpr int kUB = 2;        // slots whose cotangent rows load together
constexpr int kP4 = 4;        // slots a warp chains together (P4)

template <int kMode>
__host__ __device__ constexpr int staged(int B1) {  // staged floats a slot
  return kMode == kFused ? 3 : (kMode == kGeoRes ? B1 + 4 : B1 + 3);
}

template <int kMode, bool kWgrad, int kB4>
__global__ void __maxnreg__(kMaxRegs)
    msg_bwd_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                   const float* __restrict__ R, GeoView<const float> gv,
                   const float* __restrict__ FW,
                   const float* __restrict__ coff,
                   const float* __restrict__ cw,
                   const int* __restrict__ qcol, const int* __restrict__ dcol,
                   const int* __restrict__ esorted,
                   const int* __restrict__ grp,
                   const float* __restrict__ g_dq,
                   const float* __restrict__ g_dmu, float* __restrict__ dx,
                   float* __restrict__ dmu_out, float* __restrict__ gRo,
                   float* __restrict__ gRd, GeoView<float> gg,
                   double* __restrict__ gFWp, int nx, int ny, int P, int Ktot,
                   KOffs ko, int G, int B, int ldx, float rc, int fwsm) {
  constexpr bool kChain = kMode != kSrc;
  extern __shared__ __align__(16) double smem8[];
  constexpr int E = kE;
  const int F = blockDim.x, D3 = 3 * F, B1 = B + 1, NW = F >> 5;
  const int n4 = (B1 + 3) >> 2, LDR = 4 * n4, LDG = D3 + 4;
  const int nt = (LDR + 7) >> 3, NP = 8 * nt;   // grbf's n-tiles
  const int nks = NW;                            // grbf's slices of 3F
  const int nst = staged<kMode>(B1);
  const int col = blockIdx.x, g = blockIdx.y;
  const int ci = col / ny, cj = col - ci * ny;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int* gb = grp + ((size_t)col * (G + 1) + g) * 2;
  const int r0 = gb[0], e0 = gb[1], r1 = gb[2], e1 = gb[3];

  const size_t own0 = (size_t)col * P;
  double* s_gfw = smem8;                          // [B1][D3] (kWgrad)
  float4* s_rbf = reinterpret_cast<float4*>(smem8 + (kWgrad ? B1 * D3 : 0));
  float* s_fw = reinterpret_cast<float*>(s_rbf + E * n4);  // [B1][LDG]
  float* s_gw = s_fw + (fwsm ? B1 * LDG : 0);  // [E][LDG] filter cotangent
  float* s_part = s_gw + E * LDG;       // [nks][E][NP] grbf slices
  float* s_dir = s_part + nks * E * NP; // [E][3] unit direction
  float* s_d = s_dir + 3 * E;           // [E] distance
  float* s_gdir = s_d + E;              // [E][NW][3] per-warp dir cotangent
  float* s_grij = s_gdir + E * NW * 3;  // [E][3]
  float* st_g = s_grij + 3 * E;         // [2][nst][E] staged
  int* s_src = reinterpret_cast<int*>(st_g + 2 * nst * E);  // [2][E]
  int* s_dst = s_src + 2 * E;           // [2][E] global destination row
  int* s_c9 = s_dst + 2 * E;            // [2][E]
  int* s_slot = s_c9 + 2 * E;           // [E]
  int* st_q = s_slot + E;               // [2][E] staged qcol
  int* st_d = st_q + 2 * E;             // [2][E] staged dcol
  int* s_dcol = st_d + 2 * E;           // [9] destination column of c9

  // FW_aug's rows in shared memory where they fit (fwsm), else read from
  // global memory through L1: both by generic loads, which the barriers
  // keep inside the chunk loop
  const float* fwp = fwsm ? s_fw : FW;
  const int ldf = fwsm ? LDG : D3;
  if (fwsm)
    for (int t = tid; t < B1 * D3; t += F)
      s_fw[(t / D3) * LDG + t % D3] = FW[t];
  if (tid < 9)
    s_dcol[tid] = ((ci - (tid / 3 - 1) + nx) % nx) * ny +
                  (cj - (tid % 3 - 1) + ny) % ny;
  // the position cotangents are summed in this block's own slices of gRo
  // (its rows of the own column) and of the partial gRd (bucket c9's
  // destination column, partial g): zeroed here, one writer per element
  float* o_gRo = gRo + own0 * 3;          // [3][P]
  float* o_gRd = gRd + (size_t)g * 9 * nx * ny * 3 * P;
  if constexpr (kChain) {
    for (int t = tid; t < 3 * (r1 - r0); t += F)
      o_gRo[t / (r1 - r0) * P + r0 + t % (r1 - r0)] = 0.f;
    for (int t = tid; t < 27 * P; t += F) {
      const int c9 = t / (3 * P);
      const int dcl = ((ci - (c9 / 3 - 1) + nx) % nx) * ny +
                      (cj - (c9 % 3 - 1) + ny) % ny;
      o_gRd[((size_t)c9 * nx * ny + dcl) * 3 * P + t % (3 * P)] = 0.f;
    }
  }
  if constexpr (kWgrad)
    for (int t = tid; t < B1 * D3; t += F) s_gfw[t] = 0.0;

  // staging: thread tid serves slot st_t of a chunk, channels st_p, st_p +
  // st_np, ...
  const int st_t = tid % E, st_p = tid / E, st_np = F / E;
  auto stage = [&](int buf, int base, int slot) {
    if (base + st_t < e1) {
      if (st_p == 0) {
        cp_async4(st_q + buf * E + st_t, qcol + slot);
        cp_async4(st_d + buf * E + st_t, dcol + slot);
      }
      const int dcolumn = slot / Ktot, k = slot - dcolumn * Ktot;
      float* sg = st_g + buf * nst * E + st_t;
      for (int c = st_p; c < nst; c += st_np) {
        const float* src;
        if constexpr (kMode == kFused)
          src = coff + ((size_t)dcolumn * 3 + c) * Ktot + k;
        else
          src = gv.at(dcolumn, k, c, B1);
        cp_async4(sg + c * E, src);
      }
    }
    cp_async_commit();
  };
  auto slot_at = [&](int e) { return e < e1 ? esorted[e] : 0; };

  auto put = [&](int r, float vq, float vr, float vm, float v0, float v1,
                 float v2) {
    const size_t ro = (own0 + r) * ldx + tid;
    dx[ro] = vq;
    dx[ro + F] = vr;
    dx[ro + 2 * F] = vm;
    dmu_out[ro] = v0;
    dmu_out[ro + F] = v1;
    dmu_out[ro + 2 * F] = v2;
  };

  // P5: the position cotangents of the chunk in half pb of the index
  // buffers; side 0 (own rows) on warp 0, side 1 (destination rows) on
  // warp 1 (warp 0 when the block has one)
  auto scatter = [&](int pb) {
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      if (warp != (NW > 1 ? side : 0)) continue;
      const int sv = lane < E ? s_src[pb * E + lane] : -1;
      const bool ok = sv >= 0;
      int key = -1 - lane, c9 = 0, dv = 0;
      if (ok) {
        if (side == 0) {
          key = sv;
        } else {
          c9 = s_c9[pb * E + lane];
          dv = s_dst[pb * E + lane] - s_dcol[c9] * P;
          key = c9 * P + dv;
        }
      }
      const unsigned same = __match_any_sync(0xffffffffu, key);
      if (ok && lane == __ffs(same) - 1) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f;
        for (unsigned m = same; m; m &= m - 1) {
          const float* gr = s_grij + (__ffs(m) - 1) * 3;
          a0 += gr[0];
          a1 += gr[1];
          a2 += gr[2];
        }
        if (side == 0) {
          o_gRo[sv] += a0;
          o_gRo[P + sv] += a1;
          o_gRo[2 * P + sv] += a2;
        } else {
          float* o = o_gRd + ((size_t)c9 * nx * ny + s_dcol[c9]) * 3 * P + dv;
          o[0] -= a0;
          o[P] -= a1;
          o[2 * P] -= a2;
        }
      }
    }
  };

  int run = -1, next = r0;  // open source row; first row not yet written
  float ax = 0.f, ar = 0.f, am = 0.f, b0 = 0.f, b1 = 0.f, b2 = 0.f;
  float xq = 0.f, xr = 0.f, xm = 0.f, mu0 = 0.f, mu1 = 0.f, mu2 = 0.f;
  const float pi_rc = kPi / rc;
  const unsigned emask = (1u << E) - 1u;
  int sl_cur = slot_at(e0 + st_t);
  stage(0, e0, sl_cur);
  int sl_nxt = slot_at(e0 + E + st_t);
  int pbuf = -1, it = 0;
  for (int base = e0; base < e1; base += E, ++it) {
    const int buf = it & 1;
    int sl_nn = 0;
    if (base + E < e1) {
      stage(buf ^ 1, base + E, sl_nxt);
      sl_nn = slot_at(base + 2 * E + st_t);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // (A) this chunk staged; the last chunk's P4 done
    if constexpr (kChain)
      if (pbuf >= 0) scatter(pbuf);
    // P1: slot st_t's decode and geometry; its basis row spread over the
    // st_np threads of the slot (zero where the slot adds nothing)
    const int n = min(E, e1 - base);
    const float* sg = st_g + buf * nst * E + st_t;
    bool live = false;
    int qv = -1, dv = 0, c9 = 0, dcolumn = 0;
    float d = 1.f, ux = 0.f, uy = 0.f, uz = 0.f, fcut = 0.f;
    if (st_t < n) {
      qv = st_q[buf * E + st_t];
      dv = st_d[buf * E + st_t];
      dcolumn = sl_cur / Ktot;
      c9 = bucket_of(sl_cur - dcolumn * Ktot, ko);
      if constexpr (kMode == kFused) {
        const float* rs = R + (own0 + qv) * 3;
        const float* rd = R + ((size_t)dcolumn * P + dv) * 3;
        const float rx = rs[0] + sg[0] - rd[0];
        const float ry = rs[1] + sg[E] - rd[1];
        const float rz = rs[2] + sg[2 * E] - rd[2];
        d = sqrtf(rx * rx + ry * ry + rz * rz);
        live = d < rc;
        const float inv = 1.f / d;
        ux = rx * inv;
        uy = ry * inv;
        uz = rz * inv;
        fcut = live ? 0.5f * (cos_cut(d, rc) + 1.f) : 0.f;
      } else {
        if constexpr (kMode == kGeoRes) {
          for (int c = 0; c < B1; ++c) live |= sg[c * E] != 0.f;
          d = sg[(B1 + 3) * E];
        } else {
          live = true;
        }
        ux = sg[B1 * E];
        uy = sg[(B1 + 1) * E];
        uz = sg[(B1 + 2) * E];
      }
    }
    float* rb = reinterpret_cast<float*>(s_rbf + st_t * n4);
    for (int b = st_p; b < LDR; b += st_np) {
      float v = 0.f;
      if (live && b < B1) {
        if constexpr (kMode == kFused) {
          if (b < B) {
            const float df = d - __ldg(cw + 2 * b);
            v = expf(__ldg(cw + 2 * b + 1) * df * df) * fcut;
          } else {
            v = fcut;
          }
        } else {
          v = sg[b * E];
        }
      }
      rb[b] = v;
    }
    if (st_p == 0) {
      s_src[buf * E + st_t] = live ? qv : -1;
      s_dst[buf * E + st_t] = dcolumn * P + dv;
      s_c9[buf * E + st_t] = c9;
      s_slot[st_t] = sl_cur;
      s_d[st_t] = d;
      s_dir[st_t * 3 + 0] = ux;
      s_dir[st_t * 3 + 1] = uy;
      s_dir[st_t * 3 + 2] = uz;
    }
    __syncthreads();  // (B)
    // P2: the chunk's slots that add something, in order, kUB at a time:
    // their cotangent rows loaded together, their filters, then the run
    // sums in slot order, then the dir cotangents' warp sums together
    const unsigned livem = __ballot_sync(
        0xffffffffu, lane < E && s_src[buf * E + min(lane, E - 1)] >= 0);
    for (unsigned m = ~livem & emask; m; m &= m - 1) {
      float* gw = s_gw + (__ffs(m) - 1) * LDG + tid;
      gw[0] = 0.f;
      gw[F] = 0.f;
      gw[2 * F] = 0.f;
    }
    if (livem) {
      Filter<kB4> fw;  // registers live in P2 only
      fw.load(fwp, ldf, B1, F, tid);
      for (unsigned todo = livem; todo;) {
        int tt[kUB];
        float gq[kUB], g0[kUB], g1[kUB], g2[kUB], wq[kUB], wr[kUB],
            wm[kUB], p0[kUB], p1[kUB], p2[kUB];
#pragma unroll
        for (int u = 0; u < kUB; ++u) {
          tt[u] = todo ? __ffs(todo) - 1 : -1;
          todo &= todo - 1;
          const int ts = tt[u] < 0 ? tt[0] : tt[u];
          const size_t dr = (size_t)s_dst[buf * E + ts];
          gq[u] = __ldcg(g_dq + dr * F + tid);
          const float* gm = g_dmu + dr * D3 + tid;
          g0[u] = __ldcg(gm);
          g1[u] = __ldcg(gm + F);
          g2[u] = __ldcg(gm + 2 * F);
        }
        int rows[kUB];
#pragma unroll
        for (int u = 0; u < kUB; ++u) rows[u] = tt[u] < 0 ? tt[0] : tt[u];
        fw.apply_n(s_rbf, rows, n4, wq, wr, wm);
#pragma unroll
        for (int u = 0; u < kUB; ++u) {
          p0[u] = p1[u] = p2[u] = 0.f;
          const int t = tt[u];
          if (t < 0) continue;
          const int sv = s_src[buf * E + t];
          if (sv != run) {  // the run of row `run` ended
            if (run >= 0) {
              put(run, ax, ar, am, b0, b1, b2);
              next = run + 1;
            }
            for (; next < sv; ++next) put(next, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f);
            run = sv;
            ax = ar = am = b0 = b1 = b2 = 0.f;
            const size_t so = (own0 + sv) * ldx + tid;
            xq = __ldcg(x + so);
            xr = __ldcg(x + so + F);
            xm = __ldcg(x + so + 2 * F);
            mu0 = __ldcg(mu + so);
            mu1 = __ldcg(mu + so + F);
            mu2 = __ldcg(mu + so + 2 * F);
          }
          const float* dd = s_dir + t * 3;
          const float gp1 = g0[u] * dd[0] + g1[u] * dd[1] + g2[u] * dd[2];
          const float gp2 = g0[u] * mu0 + g1[u] * mu1 + g2[u] * mu2;
          ax = fmaf(gq[u], wq[u], ax);
          ar = fmaf(gp1, wr[u], ar);
          am = fmaf(gp2, wm[u], am);
          const float xmw = xm * wm[u], xrw = xr * wr[u];
          b0 = fmaf(g0[u], xmw, b0);
          b1 = fmaf(g1[u], xmw, b1);
          b2 = fmaf(g2[u], xmw, b2);
          float* gw = s_gw + t * LDG + tid;
          gw[0] = gq[u] * xq;
          gw[F] = gp1 * xr;
          gw[2 * F] = gp2 * xm;
          p0[u] = g0[u] * xrw;
          p1[u] = g1[u] * xrw;
          p2[u] = g2[u] * xrw;
        }
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1) {
#pragma unroll
          for (int u = 0; u < kUB; ++u) {
            p0[u] += __shfl_xor_sync(0xffffffffu, p0[u], sh);
            p1[u] += __shfl_xor_sync(0xffffffffu, p1[u], sh);
            p2[u] += __shfl_xor_sync(0xffffffffu, p2[u], sh);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int u = 0; u < kUB; ++u) {
            if (tt[u] < 0) break;
            float* gd = s_gdir + (tt[u] * NW + warp) * 3;
            gd[0] = p0[u];
            gd[1] = p1[u];
            gd[2] = p2[u];
          }
        }
      }
    }
    __syncthreads();  // (C)
    // P3: grbf slices (gW [E, 3F] . FW^T [3F, LDR]): warp w takes the
    // k-steps w, w + NW, ... of 3F, the n-tiles three at a time: per tile
    // three accumulators (the big product and the two cross terms), nine
    // independent chains
    {
      const int ks = D3 >> 3;
      for (int j0 = 0; j0 < nt; j0 += 3) {
        float acc[3][3][4] = {};
        for (int kk = warp; kk < ks; kk += NW) {
          const int k8 = kk * 8;
          const float* A = s_gw + gid * LDG + k8 + tig;
          uint32_t ab[4], as[4];
          split_tf32(A[0], ab[0], as[0]);
          split_tf32(A[8 * LDG], ab[1], as[1]);
          split_tf32(A[4], ab[2], as[2]);
          split_tf32(A[8 * LDG + 4], ab[3], as[3]);
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) {
            const int nrow = (j0 + jj) * 8 + gid;  // basis row of FW_aug
            if (j0 + jj < nt) {
              const bool ok = nrow < B1;
              const float* Bp = fwp + (ok ? nrow : 0) * ldf + k8 + tig;
              uint32_t bb[2], bs[2];
              split_tf32(ok ? Bp[0] : 0.f, bb[0], bs[0]);
              split_tf32(ok ? Bp[4] : 0.f, bb[1], bs[1]);
              mma_tf32(acc[jj][1], as, bb);
              mma_tf32(acc[jj][2], ab, bs);
              mma_tf32(acc[jj][0], ab, bb);
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          if (j0 + jj < nt) {
            const float* a = acc[jj][0];
            const float* c1 = acc[jj][1];
            const float* c2 = acc[jj][2];
            float* o = s_part + (warp * E + gid) * NP + (j0 + jj) * 8 + 2 * tig;
            o[0] = a[0] + (c1[0] + c2[0]);
            o[1] = a[1] + (c1[1] + c2[1]);
            o[8 * NP] = a[2] + (c1[2] + c2[2]);
            o[8 * NP + 1] = a[3] + (c1[3] + c2[3]);
          }
        }
      }
    }
    if constexpr (kWgrad) {
      // the chunk's gFW = rbf_aug^T [B1, E] . gW [E, 3F]: pairs of n-tiles
      // of 3F over the warps, both m-tiles, three accumulators a tile; the
      // chunk's f32 sums added to the block's f64 partial
      const int mtw = (B1 + 15) >> 4, ntw = D3 >> 3, kw = E >> 3;
      for (int j0 = 2 * warp; j0 < ntw; j0 += 2 * NW) {
        float acc[2][2][3][4] = {};
        for (int kk = 0; kk < kw; ++kk) {
          const float* ra =
              reinterpret_cast<const float*>(s_rbf + (kk * 8 + tig) * n4);
          const float* rz =
              reinterpret_cast<const float*>(s_rbf + (kk * 8 + tig + 4) * n4);
          uint32_t ab[2][4], as[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int ba = mi * 16 + gid, bz = ba + 8;
            split_tf32(ba < LDR ? ra[ba] : 0.f, ab[mi][0], as[mi][0]);
            split_tf32(bz < LDR ? ra[bz] : 0.f, ab[mi][1], as[mi][1]);
            split_tf32(ba < LDR ? rz[ba] : 0.f, ab[mi][2], as[mi][2]);
            split_tf32(bz < LDR ? rz[bz] : 0.f, ab[mi][3], as[mi][3]);
          }
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const float* Bp = s_gw + (kk * 8 + tig) * LDG + (j0 + jj) * 8 + gid;
            uint32_t bb[2], bs[2];
            split_tf32(Bp[0], bb[0], bs[0]);
            split_tf32(Bp[4 * LDG], bb[1], bs[1]);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              if (mi < mtw) {
                mma_tf32(acc[mi][jj][1], as[mi], bb);
                mma_tf32(acc[mi][jj][2], ab[mi], bs);
                mma_tf32(acc[mi][jj][0], ab[mi], bb);
              }
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int ba = mi * 16 + gid, bz = ba + 8;
            const float* a = acc[mi][jj][0];
            const float* c1 = acc[mi][jj][1];
            const float* c2 = acc[mi][jj][2];
            double* o = s_gfw + (size_t)ba * D3 + (j0 + jj) * 8 + 2 * tig;
            if (mi < mtw && ba < B1) {
              o[0] += (double)a[0] + ((double)c1[0] + (double)c2[0]);
              o[1] += (double)a[1] + ((double)c1[1] + (double)c2[1]);
            }
            if (mi < mtw && bz < B1) {
              o[8 * D3] += (double)a[2] + ((double)c1[2] + (double)c2[2]);
              o[8 * D3 + 1] += (double)a[3] + ((double)c1[3] + (double)c2[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // (D)
    // P4: kP4 slots of a warp at a time, the lanes over the basis functions,
    // their shuffle sums together; lane j then chains slot j of the group
    for (int t0 = warp; t0 < E; t0 += kP4 * NW) {
      float sd[kP4], sp[kP4];
#pragma unroll
      for (int j = 0; j < kP4; ++j) {
        sd[j] = sp[j] = 0.f;
        const int t = t0 + j * NW;
        if (t >= E || s_src[buf * E + t] < 0) continue;
        const float* part = s_part + t * NP;
        const float* rbt = reinterpret_cast<const float*>(s_rbf + t * n4);
        if constexpr (kMode == kSrc) {
          const int slot = s_slot[t], dcl = slot / Ktot, k = slot - dcl * Ktot;
          for (int b = lane; b < B1; b += 32) {
            float gbv = 0.f;
            for (int s = 0; s < nks; ++s) gbv += part[s * E * NP + b];
            *gg.at(dcl, k, b, B1) = gbv;
          }
          if (lane < 3) {
            float v = 0.f;
            for (int w = 0; w < NW; ++w) v += s_gdir[(t * NW + w) * 3 + lane];
            *gg.at(dcl, k, B1 + lane, B1) = v;
          }
        } else {
          const float dt = s_d[t], inv_fc = 1.f / fmaxf(rbt[B], 1e-30f);
          for (int b = lane; b < B; b += 32) {
            float gbv = 0.f;
            for (int s = 0; s < nks; ++s) gbv += part[s * E * NP + b];
            const float df = dt - __ldg(cw + 2 * b);
            const float coeff = __ldg(cw + 2 * b + 1);
            const float phi =
                kMode == kFused ? expf(coeff * df * df) : rbt[b] * inv_fc;
            sd[j] = fmaf(gbv, 2.f * coeff * df * phi, sd[j]);
            sp[j] = fmaf(gbv, phi, sp[j]);
          }
        }
      }
      if constexpr (kChain) {
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1) {
#pragma unroll
          for (int j = 0; j < kP4; ++j) {
            sd[j] += __shfl_xor_sync(0xffffffffu, sd[j], sh);
            sp[j] += __shfl_xor_sync(0xffffffffu, sp[j], sh);
          }
        }
        float sdj = sd[0], spj = sp[0];
#pragma unroll
        for (int j = 1; j < kP4; ++j)
          if (lane == j) {
            sdj = sd[j];
            spj = sp[j];
          }
        const int t = t0 + lane * NW;
        if (lane < kP4 && t < E && s_src[buf * E + t] >= 0) {
          const float* part = s_part + t * NP;
          const float* rbt = reinterpret_cast<const float*>(s_rbf + t * n4);
          const float dt = s_d[t], fct = rbt[B];
          float gfc = 0.f;
          for (int s = 0; s < nks; ++s) gfc += part[s * E * NP + B];
          float gd0 = 0.f, gd1 = 0.f, gd2 = 0.f;
          for (int w = 0; w < NW; ++w) {
            const float* gd = s_gdir + (t * NW + w) * 3;
            gd0 += gd[0];
            gd1 += gd[1];
            gd2 += gd[2];
          }
          const bool in = kMode == kFused ? dt < rc : fct > 0.f;
          const float dfcut = in ? -0.5f * pi_rc * sin_cut(dt, rc) : 0.f;
          const float gdd = sdj * fct + (spj + gfc) * dfcut;
          const float* u3 = s_dir + t * 3;
          const float sdot = gd0 * u3[0] + gd1 * u3[1] + gd2 * u3[2];
          const float inv = 1.f / fmaxf(dt, 1e-6f);
          float* gr = s_grij + t * 3;
          gr[0] = (gd0 - u3[0] * sdot) * inv + gdd * u3[0];
          gr[1] = (gd1 - u3[1] * sdot) * inv + gdd * u3[1];
          gr[2] = (gd2 - u3[2] * sdot) * inv + gdd * u3[2];
        }
      }
    }
    pbuf = buf;
    sl_cur = sl_nxt;
    sl_nxt = sl_nn;
  }
  __syncthreads();
  if constexpr (kChain)
    if (pbuf >= 0) scatter(pbuf);
  if (run >= 0) {  // close the last run
    put(run, ax, ar, am, b0, b1, b2);
    next = run + 1;
  }
  for (; next < r1; ++next) put(next, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f);
  if constexpr (kWgrad) {  // this block's gFW partial
    double* out = gFWp + ((size_t)col * G + g) * B1 * D3;
    for (int t = tid; t < B1 * D3; t += F) out[t] = s_gfw[t];
  }
}

template <int kMode, bool kWgrad>
size_t bwd_smem(int F, int B, bool fwsm) {
  const int B1 = B + 1, D3 = 3 * F, n4 = (B1 + 3) / 4, NW = F / 32;
  const int NP = 8 * ((4 * n4 + 7) / 8), E = kE;
  const size_t fl = (size_t)((fwsm ? B1 : 0) + E) * (D3 + 4) +
                    (size_t)NW * E * NP + 4 * E + (size_t)E * NW * 3 + 3 * E +
                    2 * (size_t)staged<kMode>(B1) * E;
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
template <int kMode, bool kWgrad, int kB4>
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
    if (cudaFuncSetAttribute(msg_bwd_kernel<kMode, kWgrad, kB4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, msg_bwd_kernel<kMode, kWgrad, kB4>, F, smem) !=
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

template <int kMode, bool kWgrad, int kB4>
int launch_bwd(const float* x, const float* mu, const float* R,
               GeoView<const float> gv, const float* FW, const float* coff,
               const float* cw, const int* qcol, const int* dcol,
               const int* esorted, const int* grp, const float* g_dq,
               const float* g_dmu, float* dx, float* dmu_out, float* gRo,
               float* gRd, GeoView<float> gg, double* gFWp, int nx, int ny,
               int P, int Ktot, const int* koffs, int G, int F, int B,
               int ldx, int n_src, float rc, cudaStream_t stream) {
  if (F % 32 != 0 || F > kMaxThreads) return (int)cudaErrorInvalidValue;
  const BwdShape sh = bwd_shape<kMode, kWgrad, kB4>(F, B);
  if (sh.fwsm < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      msg_bwd_kernel<kMode, kWgrad, kB4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return (int)err;
  msg_bwd_kernel<kMode, kWgrad, kB4><<<dim3(n_src, G), F, sh.smem, stream>>>(
      x, mu, R, gv, FW, coff, cw, qcol, dcol, esorted, grp, g_dq, g_dmu, dx,
      dmu_out, gRo, gRd, gg, gFWp, nx, ny, P, Ktot, make_koffs(koffs), G, B,
      ldx, rc, sh.fwsm);
  return (int)cudaGetLastError();
}

// the kWgrad instance when a gFW partial buffer is given, else the plain
// one; the register instance where FW_aug's rows fit it, else the L1 one
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
  const bool reg = B + 1 <= 4 * kRegB4;
  auto* fn = gFWp != nullptr
                 ? (reg ? launch_bwd<kMode, true, kRegB4>
                        : launch_bwd<kMode, true, 0>)
                 : (reg ? launch_bwd<kMode, false, kRegB4>
                        : launch_bwd<kMode, false, 0>);
  return fn(x, mu, R, gv, FW, coff, cw, qcol, dcol, esorted, grp, g_dq,
            g_dmu, dx, dmu_out, gRo, gRd, gg, gFWp, nx, ny, P, Ktot, koffs,
            G, F, B, ldx, n_src, rc, stream);
}

template <int kMode, bool kWgrad, int kB4>
int bwd_blocks(int F, int B) {
  const BwdShape sh = bwd_shape<kMode, kWgrad, kB4>(F, B);
  if (sh.fwsm < 0) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      msg_bwd_kernel<kMode, kWgrad, kB4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, msg_bwd_kernel<kMode, kWgrad, kB4>, F, sh.smem);
  return err != cudaSuccess ? -(int)err : n;
}

template <int kMode>
int bwd_blocks_any(int wgrad, int F, int B) {
  const bool reg = B + 1 <= 4 * kRegB4;
  if (wgrad)
    return reg ? bwd_blocks<kMode, true, kRegB4>(F, B)
               : bwd_blocks<kMode, true, 0>(F, B);
  return reg ? bwd_blocks<kMode, false, kRegB4>(F, B)
             : bwd_blocks<kMode, false, 0>(F, B);
}

}  // namespace

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

// blocks of the backward instance for (mode, wgrad, F, B) resident on one
// SM (negative: a CUDA error, or it fits no block's shared memory)
extern "C" int spk_msg_bwd_blocks(int mode, int wgrad, int F, int B) {
  if (mode == kFused) return bwd_blocks_any<kFused>(wgrad, F, B);
  if (mode == kGeoRes) return bwd_blocks_any<kGeoRes>(wgrad, F, B);
  return bwd_blocks_any<kSrc>(wgrad, F, B);
}
