// The column message backward's body for Hopper (sm_90a), one copy for
// its two kernels: the tuned instances (colblock_message_bwd.cu::
// msg_bwd_kernel, kGen false: one thread a feature, F % 32 == 0 and F <=
// 256, FW_aug [B+1][3F], gFW's f64 partial in shared memory; that file's
// header describes the design, P1-P5) and the general ones
// (colblock_message_gen.cu::msg_bwd_gen_kernel, kGen true: every other
// width and basis, feature tile z of NT threads on FW_aug padded to
// [B+1][Z][3][NT], the features past F zeros; that file's header says what
// differs).  The general instances alone split P3 over grbf's n-tiles
// where there are at least as many as warps (bwd_slices) and, with kScr,
// keep the arrays that grow with B in a scratch in global memory.
// Everything here has internal linkage; each source includes it once.
#pragma once

#include "colblock_message.cuh"

namespace {

// slots a chunk (one m16 tile); slots a warp chains together in P4;
// k8-steps of P3 that a warp's accumulators carry (3NT / 8 / NW, a k-split
// warp's share, at every NT)
constexpr int kBwdE = 16;
constexpr int kBwdP4 = 4;
constexpr int kBwdCarry = 12;

template <int kMode>
__host__ __device__ constexpr int bwd_staged(int B1) {  // staged floats a slot
  return kMode == kFused ? 3 : (kMode == kGeoRes ? B1 + 4 : B1 + 3);
}

// P3's grbf slices in a general instance: one a warp (the warps split the
// k-steps of 3NT) or, where grbf has at least as many n8-tiles nt as the
// block has warps, one (the warps split the n-tiles)
__host__ __device__ inline int bwd_slices(int NW, int nt) {
  return nt >= NW ? 1 : NW;
}

// The floats of a general block's arrays that grow with B: the basis rows
// [E][n4] float4, the grbf slices [nks][E][NP] and the staged channels
// [2][nst][E] (in shared memory, or with kScr in the block's slice of the
// scratch)
template <int kMode>
__host__ __device__ size_t bwd_basis_floats(int NT, int B) {
  const int B1 = B + 1, n4 = (B1 + 3) / 4, NP = 8 * ((4 * n4 + 7) / 8);
  return (size_t)kBwdE * (4 * n4 + bwd_slices(NT / 32, NP / 8) * NP +
                          2 * bwd_staged<kMode>(B1));
}

// The body: block (x, g, z) of NT threads walks the source rows of range g
// of column col0 + x (the source schedule esorted, grp), for features f0 +
// tid < F of feature tile z (f0 = z NT; kGen false: Z = 1, NT = F).
// FWp: FW_aug as [B1][Z][3][NT] (row stride Z 3NT), its tile's rows in
// shared memory (fwsm) or read through L1.  gFW's f64 partial: the block's
// own in shared memory (gsm; the tuned instances always) or its slice of
// gFWp [blocks][B1][Z 3NT]; gRo [Z][n_src][3][P], gRd [Z][G][9][nx ny][3][P]
// and ggeo (gg, a tile's partial at gg_zr, gg_zd floats) are the tiles'
// partials.  kScr: the bwd_basis_floats arrays in block (x, g, z)'s slice
// of scr, staged by loads and stores in place of cp.async.
template <int kMode, bool kWgrad, int kB4, int kP, bool kGen, bool kScr>
__device__ __forceinline__ void msg_bwd_body(
    const FeatT<kP>* __restrict__ x, const FeatT<kP>* __restrict__ mu,
    const float* __restrict__ R, GeoView<const float> gv,
    const float* __restrict__ FWp, const float* __restrict__ coff,
    const float* __restrict__ cw, const int* __restrict__ qcol,
    const int* __restrict__ dcol, const int* __restrict__ esorted,
    const int* __restrict__ grp, const FeatT<kP>* __restrict__ g_dq,
    const FeatT<kP>* __restrict__ g_dmu, float* __restrict__ dx,
    float* __restrict__ dmu_out, float* __restrict__ gRo,
    float* __restrict__ gRd, GeoView<float> gg, size_t gg_zr, size_t gg_zd,
    double* __restrict__ gFWp, int nx, int ny, int P, int Ktot, KOffs ko,
    int G, int F, int B, int ldx, float rc, int fwsm, int gsm, CellStack cs,
    float* scr, int n_src, int col0) {
  constexpr bool kChain = kMode == kFused || kMode == kGeoRes;
  extern __shared__ __align__(16) double smem8[];
  constexpr int E = kBwdE, kUB = kGen ? 4 : 2;  // kUB: slots P2 loads at once
  const int NT = blockDim.x, K3 = 3 * NT, D3 = 3 * F, B1 = B + 1;
  const int NW = NT >> 5, Z = kGen ? gridDim.z : 1;
  const int z = kGen ? blockIdx.z : 0, f0 = z * NT;
  const int n4 = (B1 + 3) >> 2, LDR = 4 * n4, LDG = K3 + 4;
  const int nt = (LDR + 7) >> 3, NP = 8 * nt;   // grbf's n-tiles
  const int nks = kGen ? bwd_slices(NW, nt) : NW;  // grbf's slices
  const int nst = bwd_staged<kMode>(B1);
  const int col = col0 + blockIdx.x, g = blockIdx.y, ncol = nx * ny;
  const int ci = col / ny, cj = col - ci * ny;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int f = f0 + tid;
  const bool real = !kGen || f < F;
  const int* gb = grp + ((size_t)col * (G + 1) + g) * 2;
  const int r0 = gb[0], e0 = gb[1], r1 = gb[2], e1 = gb[3];

  const size_t own0 = (size_t)col * P;
  const int ldfw = Z * K3;                 // FWp's row stride
  const float* fwz = FWp + (size_t)z * K3;  // the tile's slice
  // gFW's partial: [B1][3NT] here (gsm) or the block's slice in global
  // memory, row stride ldgw
  double* s_gfw = gsm ? smem8
                      : (kWgrad ? gFWp + ((size_t)col * G + g) * B1 * ldfw +
                                      (size_t)z * K3
                                : nullptr);
  const int ldgw = gsm ? K3 : ldfw;
  float* sm = reinterpret_cast<float*>(smem8 + (kWgrad && gsm ? B1 * K3 : 0));
  // kScr: the block's slice of the scratch, [rbf | grbf slices | staged]
  float* scb = nullptr;
  if constexpr (kScr)
    scb = scr + (((size_t)blockIdx.z * gridDim.y + g) * gridDim.x +
                 blockIdx.x) * bwd_basis_floats<kMode>(NT, B);
  float4* s_rbf = reinterpret_cast<float4*>(kScr ? scb : sm);  // [E][n4]
  float* s_fw = kScr ? sm : reinterpret_cast<float*>(s_rbf + E * n4);
  float* s_gw = s_fw + (fwsm ? B1 * LDG : 0);  // [E][LDG] filter cotangent
  float* s_part =                              // [nks][E][NP] grbf slices
      kScr ? reinterpret_cast<float*>(s_rbf + E * n4) : s_gw + E * LDG;
  float* s_dir = kScr ? s_gw + E * LDG : s_part + nks * E * NP;  // [E][3]
  float* s_d = s_dir + 3 * E;           // [E] distance
  float* s_gdir = s_d + E;              // [E][NW][3] per-warp dir cotangent
  float* s_grij = s_gdir + E * NW * 3;  // [E][3]
  float* st_g = kScr ? s_part + nks * E * NP : s_grij + 3 * E;  // [2][nst][E]
  int* s_src =                          // [2][E]
      reinterpret_cast<int*>(kScr ? s_grij + 3 * E : st_g + 2 * nst * E);
  int* s_dst = s_src + 2 * E;           // [2][E] global destination row
  int* s_c9 = s_dst + 2 * E;            // [2][E]
  int* s_slot = s_c9 + 2 * E;           // [E]
  int* st_q = s_slot + E;               // [2][E] staged qcol (qidx)
  int* st_d = st_q + 2 * E;             // [2][E] staged dcol (not kCell)
  int* s_dcol = st_d + 2 * E;           // [9] destination column of c9

  // the tile's FW_aug rows in shared memory (fwsm), else read through L1
  const float* fwp = fwsm ? s_fw : fwz;
  const int ldf = fwsm ? LDG : ldfw;
  if (fwsm)
    for (int t = tid; t < B1 * K3; t += NT)
      s_fw[(t / K3) * LDG + t % K3] = fwz[(size_t)(t / K3) * ldfw + t % K3];
  if (tid < 9)
    s_dcol[tid] = ((ci - (tid / 3 - 1) + nx) % nx) * ny +
                  (cj - (tid % 3 - 1) + ny) % ny;
  // the tile's slices of the position cotangents: gRo [Z][cols][3][P]
  // (this block's rows of its own column) and gRd [Z][G][9][cols][3][P]
  // (bucket c9's destination column, range g), zeroed here
  float* o_gRo = gRo + ((size_t)z * n_src + col) * 3 * P;
  float* o_gRd = gRd + ((size_t)z * G + g) * 9 * ncol * 3 * P;
  if constexpr (kChain) {
    for (int t = tid; t < 3 * (r1 - r0); t += NT)
      o_gRo[t / (r1 - r0) * P + r0 + t % (r1 - r0)] = 0.f;
    for (int t = tid; t < 27 * P; t += NT) {
      const int c9 = t / (3 * P);
      const int dcl = ((ci - (c9 / 3 - 1) + nx) % nx) * ny +
                      (cj - (c9 % 3 - 1) + ny) % ny;
      o_gRd[((size_t)c9 * ncol + dcl) * 3 * P + t % (3 * P)] = 0.f;
    }
  }
  if constexpr (kWgrad)
    for (int t = tid; t < B1 * K3; t += NT)
      s_gfw[(size_t)(t / K3) * ldgw + t % K3] = 0.0;
  // the tile's partial of the geometry cotangent (K15, K21, K19)
  const GeoView<float> gz{gg.rbf == nullptr ? nullptr : gg.rbf + z * gg_zr,
                          gg.dir == nullptr ? nullptr : gg.dir + z * gg_zd,
                          gg.col_r, gg.slot_r, gg.ch_r,
                          gg.col_d, gg.slot_d, gg.ch_d};

  // staging: thread tid serves slot st_t of a chunk, channels st_p, st_p +
  // st_np, ...
  const int st_t = tid % E, st_p = tid / E, st_np = NT / E;
  auto stage = [&](int buf, int base, int slot) {
    if (base + st_t < e1) {
      if (st_p == 0) {
        cp_async4(st_q + buf * E + st_t, qcol + slot);
        if constexpr (kMode != kCell)
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
        if constexpr (kScr)
          sg[c * E] = __ldg(src);
        else
          cp_async4(sg + c * E, src);
      }
    }
    cp_async_commit();
  };
  auto slot_at = [&](int e) { return e < e1 ? esorted[e] : 0; };

  auto put = [&](int r, float vq, float vr, float vm, float v0, float v1,
                 float v2) {
    if (!real) return;
    const size_t ro = (own0 + r) * ldx + f;
    dx[ro] = vq;
    dx[ro + F] = vr;
    dx[ro + 2 * F] = vm;
    dmu_out[ro] = v0;
    dmu_out[ro + F] = v1;
    dmu_out[ro + 2 * F] = v2;
  };

  // P5: the position cotangents of the chunk in half pb of the index
  // buffers; side 0 (own rows) on warp 0, side 1 (destination rows) on
  // warp 1 (warp 0 when the block has one): the lanes that hold equal rows
  // find each other and the lowest adds the group's values in slot order
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
          float* o = o_gRd + ((size_t)c9 * ncol + s_dcol[c9]) * 3 * P + dv;
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
      if constexpr (kMode == kCell) {
        dcolumn = sl_cur / Ktot;
        cs.decode(sl_cur - dcolumn * Ktot, st_q[buf * E + st_t], c9, qv, dv);
      } else {
        qv = st_q[buf * E + st_t];
        dv = st_d[buf * E + st_t];
        dcolumn = sl_cur / Ktot;
        c9 = bucket_of(sl_cur - dcolumn * Ktot, ko);
      }
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
      gw[NT] = 0.f;
      gw[2 * NT] = 0.f;
    }
    if (livem) {
      Filter<kB4> fw;  // registers live in P2 only
      fw.load(fwp, ldf, B1, NT, tid);
      for (unsigned todo = livem; todo;) {
        int tt[kUB];
        float gq[kUB], g0[kUB], g1[kUB], g2[kUB], wq[kUB],
            wr[kUB], wm[kUB], p0[kUB], p1[kUB], p2[kUB];
#pragma unroll
        for (int u = 0; u < kUB; ++u) {
          tt[u] = todo ? __ffs(todo) - 1 : -1;
          todo &= todo - 1;
          const int ts = tt[u] < 0 ? tt[0] : tt[u];
          const size_t dr = (size_t)s_dst[buf * E + ts];
          gq[u] = g0[u] = g1[u] = g2[u] = 0.f;
          if (real) {
            gq[u] = feat_cg<kP>(g_dq + dr * F + f);
            const FeatT<kP>* gm = g_dmu + dr * D3 + f;
            g0[u] = feat_cg<kP>(gm);
            g1[u] = feat_cg<kP>(gm + F);
            g2[u] = feat_cg<kP>(gm + 2 * F);
          }
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
            xq = xr = xm = mu0 = mu1 = mu2 = 0.f;
            if (real) {
              const size_t so = (own0 + sv) * ldx + f;
              xq = feat_cg<kP>(x + so);
              xr = feat_cg<kP>(x + so + F);
              xm = feat_cg<kP>(x + so + 2 * F);
              mu0 = feat_cg<kP>(mu + so);
              mu1 = feat_cg<kP>(mu + so + F);
              mu2 = feat_cg<kP>(mu + so + 2 * F);
            }
          }
          const float* dd = s_dir + t * 3;
          const float gp1 = g0[u] * dd[0] + g1[u] * dd[1] + g2[u] * dd[2];
          const float gp2 = g0[u] * mu0 + g1[u] * mu1 + g2[u] * mu2;
          const float xmw = xm * wm[u], xrw = xr * wr[u];
          if constexpr (kP == 3) {
            ax = fmaf(gq[u], wq[u], ax);
            ar = fmaf(gp1, wr[u], ar);
            am = fmaf(gp2, wm[u], am);
            b0 = fmaf(g0[u], xmw, b0);
            b1 = fmaf(g1[u], xmw, b1);
            b2 = fmaf(g2[u], xmw, b2);
          } else {  // the edge's source cotangents rounded, then summed
            ax += pieces<kP>(gq[u] * wq[u]);
            ar += pieces<kP>(gp1 * wr[u]);
            am += pieces<kP>(gp2 * wm[u]);
            b0 += pieces<kP>(g0[u] * xmw);
            b1 += pieces<kP>(g1[u] * xmw);
            b2 += pieces<kP>(g2[u] * xmw);
          }
          float* gw = s_gw + t * LDG + tid;
          gw[0] = gq[u] * xq;
          gw[NT] = gp1 * xr;
          gw[2 * NT] = gp2 * xm;
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
    // P3: grbf (gW [E, 3NT] . FW^T [3NT, LDR]) on the tensor cores, the
    // n-tiles three at a time (3xTF32: three accumulators a tile, nine
    // independent chains; the bf16 instance one bf16 product per k16-step
    // and tile).  Warp w takes the k-steps w, w + NW, ... of 3NT of every
    // n-tile into its slice (nks = NW: 12 k8-steps a warp at every NT), or
    // (nks = 1) the n-tiles w, w + NW, ... over every k-step, its
    // accumulators carried kBwdCarry k8-steps (a k-split warp's share) and
    // then added to the one slice in order: 3NT / 8 k-steps carried in one
    // fragment would lose f32 accuracy.
    const int jw = nks == 1 ? warp : 0, js = nks == 1 ? NW : 1;
    const int kw = nks == 1 ? 0 : warp, kst = nks == 1 ? 1 : NW;
    float* slice = s_part + (nks == 1 ? 0 : warp) * E * NP;
    // add v (a thread's four elements of n-tile j) to the slice, or store
    // it where the carry group kg is the warp's first
    auto put_p3 = [&](int j, int kg, float v0, float v1, float v2, float v3) {
      float* o = slice + gid * NP + j * 8 + 2 * tig;
      if (kg == kw) {
        o[0] = v0;
        o[1] = v1;
        o[8 * NP] = v2;
        o[8 * NP + 1] = v3;
      } else {
        o[0] += v0;
        o[1] += v1;
        o[8 * NP] += v2;
        o[8 * NP + 1] += v3;
      }
    };
    if constexpr (kP == 1) {
      // the k-split, one carry group a warp; or the n-split's carry groups
      const int ks = K3 >> 4, kc = nks == NW ? ks : kBwdCarry / 2;
      for (int j0 = jw; j0 < nt; j0 += 3 * js) {
        for (int kg = kw; kg < ks; kg += kc) {
          float acc[3][4] = {};
          for (int kk = kg; kk < min(ks, kg + kc); kk += kst) {
            const int k16 = kk * 16;
            const float* A = s_gw + gid * LDG + k16 + 2 * tig;
            const uint32_t a[4] = {pack_bf16(A[0], A[1]),
                                   pack_bf16(A[8 * LDG], A[8 * LDG + 1]),
                                   pack_bf16(A[8], A[9]),
                                   pack_bf16(A[8 * LDG + 8], A[8 * LDG + 9])};
#pragma unroll
            for (int jj = 0; jj < 3; ++jj) {
              const int j = j0 + jj * js, nrow = j * 8 + gid;  // FW_aug row
              if (j < nt) {
                const bool ok = nrow < B1;
                const float* Bp = fwp + (size_t)(ok ? nrow : 0) * ldf + k16 +
                                  2 * tig;
                const uint32_t b[2] = {ok ? pack_bf16(Bp[0], Bp[1]) : 0u,
                                       ok ? pack_bf16(Bp[8], Bp[9]) : 0u};
                mma_bf16(acc[jj], a, b);
              }
            }
          }
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) {
            const int j = j0 + jj * js;
            if (j < nt)
              put_p3(j, kg, acc[jj][0], acc[jj][1], acc[jj][2], acc[jj][3]);
          }
        }
      }
    } else if (nks == NW) {  // the k-split, one carry group a warp
      const int ks = K3 >> 3;
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
              const float* Bp = fwp + (size_t)(ok ? nrow : 0) * ldf + k8 +
                                tig;
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
            float* o = slice + gid * NP + (j0 + jj) * 8 + 2 * tig;
            o[0] = a[0] + (c1[0] + c2[0]);
            o[1] = a[1] + (c1[1] + c2[1]);
            o[8 * NP] = a[2] + (c1[2] + c2[2]);
            o[8 * NP + 1] = a[3] + (c1[3] + c2[3]);
          }
        }
      }
    } else {  // the n-split in carry groups
      const int ks = K3 >> 3;
      for (int j0 = jw; j0 < nt; j0 += 3 * js) {
        for (int kg = 0; kg < ks; kg += kBwdCarry) {
          float acc[3][3][4] = {};
          for (int kk = kg; kk < min(ks, kg + kBwdCarry); ++kk) {
            const int k8 = kk * 8;
            const float* A = s_gw + gid * LDG + k8 + tig;
            uint32_t ab[4], as[4];
            split_tf32(A[0], ab[0], as[0]);
            split_tf32(A[8 * LDG], ab[1], as[1]);
            split_tf32(A[4], ab[2], as[2]);
            split_tf32(A[8 * LDG + 4], ab[3], as[3]);
#pragma unroll
            for (int jj = 0; jj < 3; ++jj) {
              const int j = j0 + jj * js, nrow = j * 8 + gid;  // FW_aug row
              if (j < nt) {
                const bool ok = nrow < B1;
                const float* Bp = fwp + (size_t)(ok ? nrow : 0) * ldf + k8 +
                                  tig;
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
            const int j = j0 + jj * js;
            if (j < nt) {
              const float* a = acc[jj][0];
              const float* c1 = acc[jj][1];
              const float* c2 = acc[jj][2];
              put_p3(j, kg, a[0] + (c1[0] + c2[0]), a[1] + (c1[1] + c2[1]),
                     a[2] + (c1[2] + c2[2]), a[3] + (c1[3] + c2[3]));
            }
          }
        }
      }
    }
    if constexpr (kWgrad && kP == 1) {
      // the chunk's gFW = rbf_aug^T [B1, E] . gW [E, 3NT] in bf16: pairs of
      // n-tiles of 3NT over the warps, two m-tiles of B1 at a time, the
      // chunk's 16 slots one k16-step; its f32 sums added to the f64
      // partial
      const int mtw = (B1 + 15) >> 4, ntw = K3 >> 3;
      const float* r0 = reinterpret_cast<const float*>(s_rbf + 2 * tig * n4);
      const float* r1 = r0 + 4 * n4;
      const float* r8 = r0 + 32 * n4;
      const float* r9 = r8 + 4 * n4;
      for (int m0 = 0; m0 < mtw; m0 += 2) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int ba = (m0 + mi) * 16 + gid, bz = ba + 8;
          const bool oa = ba < LDR, oz = bz < LDR;
          a[mi][0] = pack_bf16(oa ? r0[ba] : 0.f, oa ? r1[ba] : 0.f);
          a[mi][1] = pack_bf16(oz ? r0[bz] : 0.f, oz ? r1[bz] : 0.f);
          a[mi][2] = pack_bf16(oa ? r8[ba] : 0.f, oa ? r9[ba] : 0.f);
          a[mi][3] = pack_bf16(oz ? r8[bz] : 0.f, oz ? r9[bz] : 0.f);
        }
        for (int j0 = 2 * warp; j0 < ntw; j0 += 2 * NW) {
          float acc[2][2][4] = {};
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const float* Bq = s_gw + 2 * tig * LDG + (j0 + jj) * 8 + gid;
            const uint32_t b[2] = {pack_bf16(Bq[0], Bq[LDG]),
                                   pack_bf16(Bq[8 * LDG], Bq[9 * LDG])};
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              if (m0 + mi < mtw) mma_bf16(acc[mi][jj], a[mi], b);
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int ba = (m0 + mi) * 16 + gid, bz = ba + 8;
              const float* c = acc[mi][jj];
              double* o = s_gfw + (size_t)ba * ldgw + (j0 + jj) * 8 + 2 * tig;
              if (m0 + mi < mtw && ba < B1) {
                o[0] += (double)c[0];
                o[1] += (double)c[1];
              }
              if (m0 + mi < mtw && bz < B1) {
                o[8 * (size_t)ldgw] += (double)c[2];
                o[8 * (size_t)ldgw + 1] += (double)c[3];
              }
            }
          }
        }
      }
    } else if constexpr (kWgrad) {
      // the chunk's gFW = rbf_aug^T [B1, E] . gW [E, 3NT]: pairs of n-tiles
      // of 3NT over the warps, two m-tiles of B1 at a time, three
      // accumulators a tile; the chunk's f32 sums added to the f64 partial
      const int mtw = (B1 + 15) >> 4, ntw = K3 >> 3, kw = E >> 3;
      for (int m0 = 0; m0 < mtw; m0 += 2) {
        for (int j0 = 2 * warp; j0 < ntw; j0 += 2 * NW) {
          float acc[2][2][3][4] = {};
          for (int kk = 0; kk < kw; ++kk) {
            const float* ra =
                reinterpret_cast<const float*>(s_rbf + (kk * 8 + tig) * n4);
            const float* rz = reinterpret_cast<const float*>(
                s_rbf + (kk * 8 + tig + 4) * n4);
            uint32_t ab[2][4], as[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const int ba = (m0 + mi) * 16 + gid, bz = ba + 8;
              split_tf32(ba < LDR ? ra[ba] : 0.f, ab[mi][0], as[mi][0]);
              split_tf32(bz < LDR ? ra[bz] : 0.f, ab[mi][1], as[mi][1]);
              split_tf32(ba < LDR ? rz[ba] : 0.f, ab[mi][2], as[mi][2]);
              split_tf32(bz < LDR ? rz[bz] : 0.f, ab[mi][3], as[mi][3]);
            }
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const float* Bq =
                  s_gw + (kk * 8 + tig) * LDG + (j0 + jj) * 8 + gid;
              uint32_t bb[2], bs[2];
              split_tf32(Bq[0], bb[0], bs[0]);
              split_tf32(Bq[4 * LDG], bb[1], bs[1]);
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) {
                if (m0 + mi < mtw) {
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
              const int ba = (m0 + mi) * 16 + gid, bz = ba + 8;
              const float* a = acc[mi][jj][0];
              const float* c1 = acc[mi][jj][1];
              const float* c2 = acc[mi][jj][2];
              double* o = s_gfw + (size_t)ba * ldgw + (j0 + jj) * 8 + 2 * tig;
              if (m0 + mi < mtw && ba < B1) {
                o[0] += (double)a[0] + ((double)c1[0] + (double)c2[0]);
                o[1] += (double)a[1] + ((double)c1[1] + (double)c2[1]);
              }
              if (m0 + mi < mtw && bz < B1) {
                o[8 * (size_t)ldgw] +=
                    (double)a[2] + ((double)c1[2] + (double)c2[2]);
                o[8 * (size_t)ldgw + 1] +=
                    (double)a[3] + ((double)c1[3] + (double)c2[3]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // (D)
    // P4: kBwdP4 slots of a warp at a time, the lanes over the basis
    // functions, their shuffle sums together; lane j then chains slot j of
    // the group
    for (int t0 = warp; t0 < E; t0 += kBwdP4 * NW) {
      float sd[kBwdP4], sp[kBwdP4];
#pragma unroll
      for (int j = 0; j < kBwdP4; ++j) {
        sd[j] = sp[j] = 0.f;
        const int t = t0 + j * NW;
        if (t >= E || s_src[buf * E + t] < 0) continue;
        const float* part = s_part + t * NP;
        const float* rbt = reinterpret_cast<const float*>(s_rbf + t * n4);
        if constexpr (!kChain) {
          const int slot = s_slot[t], dcl = slot / Ktot;
          const int k = slot - dcl * Ktot;
          for (int b = lane; b < B1; b += 32) {
            float gbv = 0.f;
            for (int s = 0; s < nks; ++s) gbv += part[s * E * NP + b];
            *gz.at(dcl, k, b, B1) = gbv;
          }
          if (lane < 3) {
            float v = 0.f;
            for (int w = 0; w < NW; ++w) v += s_gdir[(t * NW + w) * 3 + lane];
            *gz.at(dcl, k, B1 + lane, B1) = v;
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
          for (int j = 0; j < kBwdP4; ++j) {
            sd[j] += __shfl_xor_sync(0xffffffffu, sd[j], sh);
            sp[j] += __shfl_xor_sync(0xffffffffu, sp[j], sh);
          }
        }
        float sdj = sd[0], spj = sp[0];
#pragma unroll
        for (int j = 1; j < kBwdP4; ++j)
          if (lane == j) {
            sdj = sd[j];
            spj = sp[j];
          }
        const int t = t0 + lane * NW;
        if (lane < kBwdP4 && t < E && s_src[buf * E + t] >= 0) {
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
  if constexpr (kWgrad) {  // the block's gFW partial, where it was summed here
    if (gsm) {
      double* out = gFWp + ((size_t)col * G + g) * B1 * ldfw + (size_t)z * K3;
      for (int t = tid; t < B1 * K3; t += NT)
        out[(size_t)(t / K3) * ldfw + t % K3] = s_gfw[t];
    }
  }
}

}  // namespace
