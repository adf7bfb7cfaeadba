"""Smoke run of the PyTorch/CUDA port on one GPU (run from the repo root):

    python3 chip_smoke.py [--seed 0] [--steps 300]

Phases (any failure exits non-zero before the last line is printed):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``schnetpack_tpu_torch/csrc`` (one nvcc per
   source, started together; sm_90a);
3. hold each kernel K1-K15 against its plain PyTorch twin on the card at
   the shapes of the MD runs below (10,976-atom argon box in the layout the
   port's neighbor list builds, F=128, B=20, f32, random features and
   cotangents from --seed; K6/K7 on the geo that K5 computes there, K15 on
   K5's geo without the d channel, K9/K10 on the raw-phi geo of K5's raw
   form, with the trained SchNet's first filter network; K11-K14 at the
   positions' width D = 3 and SO3net's D = 9 x 64; K2, K7 and K15 also in
   their wgrad instances, which return the filter-weight cotangent gFW, a
   sum over all ~200k edges: those are held to the twin evaluated in
   float64, since the f32 twin's own sum is off by ~1e-5 there),
   tolerance rtol 1e-4 / atol 1e-5 elementwise; time both,
   the one PyTorch call that computes the same function where there is
   one (K11-K14: ``index_select`` and the mask, ``index_add_``), and work
   out each kernel's bound from the bytes of its inputs and outputs at
   3.35 TB/s and its FP32 operations at 67 TFLOP/s (H100 SXM data sheet);
4. hold the port's energy and forces on the card to the JAX references
   (force rms <= 1e-4 eV/Ang, energy within 1e-5 relative): PaiNN in both
   message forms (``fuse`` = hybrid and full) to
   ``tests/data/port_ref_painn_argon.npz``, printing the force rms between
   the two, SchNet to ``tests/data/port_ref_schnet_argon.npz``, SO3net
   to ``tests/data/port_ref_so3net_argon.npz``, and PaiNN on the row-9
   path with a trainable Gaussian basis (the fixture's centers and widths)
   and with a Bessel basis to ``tests/data/port_ref_painn_{trbf,bessel}_
   argon.npz``;
5. the neighbor list's device rebuild at full size: jitter the lattice by
   a seeded uniform +-0.25 A (the 0.3 A skin check fires, the capacities
   hold), rebuild once on the device and once on the host, and require
   equal edge sets (original atom ids, periodic shifts) and forces within
   rms 1e-5 eV/Ang; time both;
6. run NVE velocity Verlet at 0.5 fs of the 10,976-atom periodic FCC argon
   box with the trained PaiNN-128x3 (``scripts/assets/
   bench_painn_argon.msgpack``), the trained SchNet-128x3
   (``scripts/assets/bench_schnet_argon.msgpack``), the trained
   SO3net-64x3 (lmax 2, ``scripts/assets/bench_so3net_argon.msgpack``) and
   the trained PaiNN with the trbf fixture's trainable Gaussian basis,
   Maxwell-Boltzmann momenta at 30 K, the column neighbor list (5 A
   cutoff, 0.6 A skin): a warm-up, a retighten of the capacities, then
   --steps timed steps, on PaiNN's hybrid path, PaiNN's full path,
   SchNet's path, SO3net's path and PaiNN's row-9 path (``painn_trbf``);
   check finite positions, 0 < T < 300 K, total-energy drift <= 1e-4
   eV/atom, the launches per step of every kernel (hybrid: K5 1,
   K6/K7/K3/K4 3; full: K1/K2/K3/K4 3; SchNet: K5 raw 1, K9/K10 3, K8 1;
   SO3net: K11 4, K12 3, K13 4, K14 4; painn_trbf: K11-K14 1 each,
   K6/K15/K3/K4 3; every other kernel 0),
   and that every rebuild after the retighten went through the device
   unless it overflowed;
7. print the kernel table and the card as JSON, then the result line.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSET = {
    "painn": os.path.join(ROOT, "scripts", "assets",
                          "bench_painn_argon.msgpack"),
    "schnet": os.path.join(ROOT, "scripts", "assets",
                           "bench_schnet_argon.msgpack"),
    "so3net": os.path.join(ROOT, "scripts", "assets",
                           "bench_so3net_argon.msgpack"),
}
#: the JAX reference of each path (``scripts/make_port_reference*.py``)
REFERENCE = {
    path: os.path.join(ROOT, "tests", "data", f"port_ref_{name}_argon.npz")
    for path, name in [("hybrid", "painn"), ("full", "painn"),
                       ("schnet", "schnet"), ("so3net", "so3net"),
                       ("painn_trbf", "painn_trbf"),
                       ("painn_bessel", "painn_bessel")]
}
CUTOFF, SKIN = 5.0, 0.6          # Angstrom
RTOL, ATOL = 1e-4, 1e-5          # kernel vs twin, elementwise
FORCE_RMS_TOL = 1e-4             # eV/Ang vs the JAX reference
ENERGY_RTOL = 1e-5
DRIFT_TOL = 1e-4                 # eV/atom, max |E_tot(t) - E_tot(0)|
REBUILD_FORCE_RMS_TOL = 1e-5     # eV/Ang, device vs host neighbor state
REBUILD_JITTER = 0.25            # Angstrom, per component
HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12          # FP32 outside the tensor cores, same
#: kernel launches per MD step on each path (PaiNN's two message forms,
#: SchNet, SO3net: the positions' gather and expand, then per block the
#: feature gather and the message fold and, by autograd, their VJPs, with
#: no gather VJP for block 0, whose input carries no gradient)
PER_STEP = {
    "hybrid": {"geo_fwd": 1, "msg_fwd_geo": 3, "msg_bwd_geores": 3,
               "mix_fwd": 3, "mix_bwd": 3},
    "full": {"msg_fwd": 3, "msg_bwd": 3, "mix_fwd": 3, "mix_bwd": 3},
    "schnet": {"geo_fwd_raw": 1, "cf_fwd": 3, "cf_bwd": 3, "geo_bwd": 1},
    "so3net": {"gather_fwd": 4, "gather_bwd": 3, "expand_fwd": 4,
               "fold_fwd": 4},
    "painn_trbf": {"gather_fwd": 1, "gather_bwd": 1, "expand_fwd": 1,
                   "fold_fwd": 1, "msg_fwd_geo": 3, "msg_bwd_src": 3,
                   "mix_fwd": 3, "mix_bwd": 3},
}
#: the MD paths of phase 6
PATHS = ("hybrid", "full", "schnet", "so3net", "painn_trbf")


def fcc_box(n_target: int, a: float = 5.26):
    """FCC argon supercell with ~n_target atoms (``bench.py::fcc_box``)."""
    n = int(round((n_target / 4) ** (1 / 3)))
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                    -1).reshape(-1, 1, 3)
    return ((base[None] + grid) * a).reshape(-1, 3), np.eye(3) * a * n


def cuda_ms(fn, reps=10):
    """Mean CUDA-event time of ``fn`` after one warm-up call."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_f64(fn, *args):
    """``fn`` on float64 copies of its float32 tensor arguments, its outputs
    rounded to float32."""
    out = fn(*[a.double() if torch.is_tensor(a) and a.dtype == torch.float32
               else a for a in args])
    return tuple(o.float() for o in out)


def compare(name, got, want):
    err = 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"{name}: {m}")
        err = max(err, float((g - w).abs().max()))
    return err


def molecule(R, cell):
    from schnetpack_tpu_torch import properties as P

    return {P.Z: np.full(len(R), 18, np.int64), P.R: R, P.cell: cell,
            P.pbc: np.ones(3, bool)}


def model_of(path):
    return path if path in ("schnet", "so3net") else "painn"


def potential(path="full"):
    """The trained model of a path and its parameters: PaiNN-128x3 with the
    message form ``path`` ("hybrid" or "full", PaiNN's own default),
    SchNet-128x3 (``path`` "schnet"), SO3net-64x3, lmax 2, with its
    ``PairwiseDistances`` input module (``path`` "so3net"), or PaiNN-128x3
    on the row-9 path with ``PairwiseDistances``: with the trbf fixture's
    trainable Gaussian basis ("painn_trbf") or a Bessel basis
    ("painn_bessel")."""
    from schnetpack_tpu_torch.atomistic import (
        Atomwise, Forces, PairwiseDistances,
    )
    from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
    from schnetpack_tpu_torch.model import NeuralNetworkPotential
    from schnetpack_tpu_torch.nn import BesselRBF, GaussianRBF
    from schnetpack_tpu_torch.representation import PaiNN, SchNet, SO3net

    inputs = []
    radial_from = None
    if path == "so3net":
        rep = SO3net(n_atom_basis=64, n_interactions=3, lmax=2, n_rbf=20,
                     cutoff=CUTOFF)
        inputs = [PairwiseDistances()]
    elif path == "schnet":
        rep = SchNet(n_atom_basis=128, n_interactions=3, n_rbf=20,
                     cutoff=CUTOFF)
    elif path in ("painn_trbf", "painn_bessel"):
        trbf = path == "painn_trbf"
        radial = (GaussianRBF(20, CUTOFF, trainable=True) if trbf
                  else BesselRBF(20, CUTOFF))
        rep = PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
                    cutoff=CUTOFF, radial_basis=radial)
        inputs = [PairwiseDistances()]
        radial_from = REFERENCE[path] if trbf else None
    else:
        rep = PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
                    cutoff=CUTOFF, fuse=path)
    pot = NeuralNetworkPotential(rep, [Atomwise(n_in=rep.n_atom_basis),
                                       Forces()], input_modules=inputs)
    return pot, params_from_jax(load_jax_params(ASSET[model_of(path)],
                                                radial_from=radial_from))


def layout_str(state):
    from schnetpack_tpu_torch import properties as P

    nx, ny, Ktot = state[P.cell_qcol].shape
    return (f"dims=({nx}, {ny}, {state['cell_order'].shape[0] // (nx * ny)})"
            f" Ktot={Ktot}")


def calculator(pot, params, jitter=0.25, headroom=1.0 / 12.0):
    from schnetpack_tpu_torch.md import CellBlockNeighborListMD
    from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
    from schnetpack_tpu_torch.units import _parse_unit, md_units

    conv = _parse_unit("Ang") * md_units().length
    nbl = CellBlockNeighborListMD(CUTOFF * conv, skin=SKIN * conv,
                                  layout="column", jitter_fraction=jitter,
                                  bucket_headroom=headroom)
    return SchNetPackCalculator(pot, params, cutoff=CUTOFF, cutoff_shell=SKIN,
                                neighbor_list=nbl)


def run_inputs(calc, system):
    """(R, coff_fm, refs) of the model's inputs for ``system``."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.ops.colblock import ColRefs

    st = calc.init_state(system)
    inputs = calc.model_inputs(system, st)
    R = inputs[P.R].contiguous()
    qcol = inputs[P.cell_qcol]
    refs = ColRefs(qcol, inputs[P.cell_dcol],
                   R.shape[0] // (qcol.shape[0] * qcol.shape[1]),
                   tuple(inputs[P.cell_ksz]))
    print(f"layout: {layout_str(st)} A'={R.shape[0]}", flush=True)
    return R, inputs[P.cell_coff_fm].contiguous(), refs


def nbytes(*tensors):
    """Bytes of the tensors (nested tuples allowed), each counted once; an
    int stands for that many bytes."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, int):
            total += t
    return total


def bound(n_bytes, flops):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes at the HBM rate and the FP32 operations at the
    FP32 peak."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def geo_flops(B):
    """FP32 operations of one edge's geometry: displacement, distance,
    direction, cosine cutoff and B Gaussians (a transcendental counts 1)."""
    return 4 * B + 30


def check_kernels(cases):
    """Each kernel against its twin (rtol/atol elementwise), both timed,
    with its bound (from the bytes of ``inputs`` and of the kernel's
    outputs, and ``flops``) and the time of ``library``, one PyTorch call
    that computes the same function, where there is one; returns the rows
    of the kernel table."""
    rows = []
    for c in cases:
        name, kern, plain = c["name"], c["kern"], c["plain"]
        got = kern()
        err = compare(name, got, (c.get("ref") or plain)())
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        lib_ms = cuda_ms(c["library"]) if c.get("library") else None
        bound_ms, bound_by = bound(nbytes(c["inputs"], got), c["flops"])
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"kernel {name}{c.get('tag', '')}: max_abs_err={err:.3e} "
              f"{ms:.4f} ms (plain twin {plain_ms:.4f} ms, library {lib}, "
              f"bound {bound_ms:.4f} ms by {bound_by})", flush=True)
        row = {"name": name, "route": "cuda",
               "source": f"schnetpack_tpu_torch/csrc/{c['src']}",
               "replaces": f"schnetpack_tpu/ops/{c['replaces']}",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms}
        if c.get("wgrad"):   # the kernel's wgrad instance, also gFW
            (w,) = check_kernels([dict(c, **c["wgrad"], wgrad=None,
                                       tag=" + gFW (wgrad)")])
            row["wgrad"] = {k: w[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}
        rows.append(row)
    return rows


def case(name, src, replaces, kern, plain, inputs, flops, library=None,
         wgrad=None):
    """One kernel of the table; ``wgrad`` (``kern``, ``plain``, ``flops``
    and ``ref``, what the kernel is held to, where that is not ``plain``)
    adds its wgrad instance as a sub-row."""
    return {"name": name, "src": src, "replaces": replaces, "kern": kern,
            "plain": plain, "inputs": inputs, "flops": flops,
            "library": library, "wgrad": wgrad}


def real_edges(refs):
    return int((refs.qcol >= 0).sum())


def kernel_phase(calc, system, seed, dev):
    """K1-K7 and K15 against their twins at the MD run's shapes; returns
    rows.

    Operations per real edge e (an FMA counts 2): the filter (B+1) x 3F
    FMAs, 16F for the products and sums of the message, twice both for a
    backward, and the geometry where a kernel computes it; a wgrad
    instance adds the (B+1) x 3F FMAs of gFW; per atom row the mixing's
    22 F^2 (44 F^2 backward: input cotangents and the recomputed
    forward)."""
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op
    from schnetpack_tpu_torch.ops import colblock_message as msg
    from schnetpack_tpu_torch.ops import painn_mixing as mix

    R, coff, refs = run_inputs(calc, system)
    rep = calc.model.representation
    F, Ap = rep.n_atom_basis, R.shape[0]
    B = rep.cw.shape[0]
    ne = real_edges(refs)
    idx = (refs.qcol, refs.dcol)
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=0.3):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    x, mu = rnd(Ap, 3 * F), rnd(Ap, 3 * F)
    g_dq, g_dmu = rnd(Ap, F, scale=1.0), rnd(Ap, 3 * F, scale=1.0)
    FW = rep.FW_aug[0].contiguous()
    margs = (x, mu, R, FW, coff, rep.cw, refs, rep.cutoff)
    gargs = (R, coff, refs, rep.cw, rep.cutoff)
    geo = geo_op.geo_fwd_kernel(*gargs)
    geo4 = geo_op.geo_fwd_kernel(*gargs, with_d=False)
    hargs = (x, mu, geo, FW, refs)
    bargs = (x, mu, geo, FW, rep.cw, refs, rep.cutoff, g_dq, g_dmu)
    sargs = (x, mu, geo4, FW, refs, g_dq, g_dmu)
    m0 = rep.mixing[0]
    w = (m0.kmix, m0.k0, m0.b0, m0.k1, m0.b1)
    xargs = (rnd(Ap, F, scale=1.0), mu, g_dq * 0.3, g_dmu * 0.3, *w,
             m0.epsilon, m0.activation)
    msg_fwd = ne * (6 * F * (B + 1) + 16 * F)
    msg_bwd = 2 * msg_fwd
    gfw = ne * 6 * F * (B + 1)

    cases = [
        case("msg_fwd", "colblock_message.cu", "colblock_pallas.py:1889",
             lambda: msg.msg_fwd_kernel(*margs),
             lambda: msg.msg_fwd_plain(*margs),
             (x, mu, R, FW, coff, rep.cw, idx), msg_fwd + ne * geo_flops(B)),
        case("msg_bwd", "colblock_message.cu", "colblock_pallas.py:1239",
             lambda: msg.msg_bwd_kernel(*margs, g_dq, g_dmu),
             lambda: msg.msg_bwd_plain(*margs, g_dq, g_dmu)[:3],
             (x, mu, R, FW, coff, rep.cw, idx, g_dq, g_dmu),
             msg_bwd + 2 * ne * geo_flops(B),
             wgrad={"kern": lambda: msg.msg_bwd_kernel(*margs, g_dq, g_dmu,
                                                       wgrad=True),
                    "plain": lambda: msg.msg_bwd_plain(*margs, g_dq, g_dmu),
                    "ref": lambda: in_f64(msg.msg_bwd_plain, *margs, g_dq,
                                          g_dmu),
                    "flops": msg_bwd + 2 * ne * geo_flops(B) + gfw}),
        case("mix_fwd", "painn_mixing.cu", "painn_mixing.py:73",
             lambda: mix.mix_fwd_kernel(*xargs),
             lambda: mix.painn_mixing_plain(*xargs), xargs[:9],
             22 * F * F * Ap),
        case("mix_bwd", "painn_mixing.cu", "painn_mixing.py:83",
             lambda: mix.mix_bwd_kernel(*xargs, g_dq, g_dmu),
             lambda: mix.painn_mixing_bwd_plain(*xargs, g_dq, g_dmu),
             (xargs[:9], g_dq, g_dmu), 44 * F * F * Ap),
        case("geo_fwd", "colblock_geo.cu", "colblock_geo.py:202",
             lambda: (geo_op.geo_fwd_kernel(*gargs),),
             lambda: (geo_op.geo_fwd_plain(*gargs),),
             (R, coff, idx, rep.cw), ne * geo_flops(B)),
        case("msg_fwd_geo", "colblock_message.cu", "colblock_pallas.py:687",
             lambda: msg.msg_fwd_geo_kernel(*hargs),
             lambda: msg.msg_fwd_geo_plain(*hargs),
             (x, mu, geo, FW, idx), msg_fwd),
        case("msg_bwd_geores", "colblock_message.cu",
             "colblock_pallas.py:1570",
             lambda: msg.msg_bwd_geores_kernel(*bargs),
             lambda: msg.msg_bwd_geores_plain(*bargs)[:3],
             (x, mu, geo, FW, rep.cw, idx, g_dq, g_dmu),
             msg_bwd + ne * geo_flops(B),
             wgrad={"kern": lambda: msg.msg_bwd_geores_kernel(*bargs,
                                                              wgrad=True),
                    "plain": lambda: msg.msg_bwd_geores_plain(*bargs),
                    "ref": lambda: in_f64(msg.msg_bwd_geores_plain, *bargs),
                    "flops": msg_bwd + ne * geo_flops(B) + gfw}),
        case("msg_bwd_src", "colblock_message.cu",
             "colblock_pallas.py:834",
             lambda: msg.msg_bwd_src_kernel(*sargs),
             lambda: msg.msg_bwd_src_plain(*sargs)[:3],
             (x, mu, geo4, FW, idx, g_dq, g_dmu), msg_bwd,
             wgrad={"kern": lambda: msg.msg_bwd_src_kernel(*sargs,
                                                           wgrad=True),
                    "plain": lambda: msg.msg_bwd_src_plain(*sargs),
                    "ref": lambda: in_f64(msg.msg_bwd_src_plain, *sargs),
                    "flops": msg_bwd + gfw}),
    ]
    return check_kernels(cases)


def schnet_kernel_phase(calc, system, seed, dev):
    """K5 raw, K8, K9 and K10 against their twins at the SchNet run's
    shapes, with the trained SchNet's first filter network; returns rows.
    The filter network is B x F + F x F FMAs per real edge, twice that in
    the backward."""
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op
    from schnetpack_tpu_torch.ops import schnet_columns as cf

    R, coff, refs = run_inputs(calc, system)
    rep = calc.model.representation
    F, Ap, B = rep.n_atom_basis, R.shape[0], rep.n_rbf
    ne = real_edges(refs)
    idx = (refs.qcol, refs.dcol)
    g = torch.Generator().manual_seed(seed + 10)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    gargs = (R, coff, refs, rep.cw, rep.cutoff)
    geo = geo_op.geo_fwd_kernel(*gargs, with_d=False, raw_phi=True)
    ggeo = rnd(*geo.shape)
    i0 = rep.interactions[0]
    cargs = (rnd(Ap, F, scale=0.3), geo,
             i0.filter_0.weight.t().contiguous(), i0.filter_0.bias,
             i0.filter_1.weight.t().contiguous(), i0.filter_1.bias, refs)
    g_out = rnd(Ap, F)
    assert geo.shape[2] == B + 4
    filt = 2 * ne * (B * F + F * F)
    cases = [
        case("geo_fwd_raw", "colblock_geo.cu", "colblock_geo.py:202",
             lambda: (geo_op.geo_fwd_kernel(*gargs, with_d=False,
                                            raw_phi=True),),
             lambda: (geo_op.geo_fwd_plain(*gargs, with_d=False,
                                           raw_phi=True),),
             (R, coff, idx, rep.cw), ne * geo_flops(B)),
        case("geo_bwd", "colblock_geo.cu", "colblock_geo.py:230",
             lambda: (geo_op.geo_bwd_kernel(ggeo, *gargs),),
             lambda: (geo_op.geo_bwd_plain(ggeo, *gargs),),
             (ggeo, R, coff, idx, rep.cw), 2 * ne * geo_flops(B)),
        case("cf_fwd", "schnet_columns.cu", "schnet_columns.py:79",
             lambda: (cf.cf_fwd_kernel(*cargs),),
             lambda: (cf.cf_fwd_plain(*cargs),), (cargs[:6], idx),
             filt + ne * 6 * F),
        case("cf_bwd", "schnet_columns.cu", "schnet_columns.py:145",
             lambda: cf.cf_bwd_kernel(*cargs, g_out),
             lambda: cf.cf_bwd_plain(*cargs, g_out)[:2],
             (cargs[:6], idx, g_out), 2 * filt + ne * 12 * F),
    ]
    return check_kernels(cases)


def select_kernel_phase(calc, system, seed, dev):
    """K11-K14 against their twins at the SO3net run's shapes, at the
    positions' width (D = 3) and the convolutions' (D = 9 F), each beside
    its library call; returns one row per kernel at D = 9 F, with the
    D = 3 numbers under "d3".  The sums are one add per real edge and
    feature and need only the real slots' rows of their input; the copies
    do no arithmetic."""
    from schnetpack_tpu_torch.ops import colblock_select as sel
    from schnetpack_tpu_torch.ops.colblock import decode_i, decode_j

    R, _, refs = run_inputs(calc, system)
    rep = calc.model.representation
    Ap = R.shape[0]
    ne = real_edges(refs)
    nx, ny, Ktot = refs.qcol.shape
    g = torch.Generator().manual_seed(seed + 20)
    j, jvalid = decode_j(refs)
    i, ivalid = decode_i(refs)
    jf, jm = j.reshape(-1), jvalid.reshape(-1, 1).float()
    if_, im = i.reshape(-1), ivalid.reshape(-1, 1).float()
    jpad = torch.where(jvalid, j, Ap).reshape(-1)
    ipad = torch.where(ivalid, i, Ap).reshape(-1)

    def cases(D, table, edges):
        flat = edges.reshape(-1, D)
        return [
            case("gather_fwd", "colblock_select.cu", "colblock_pallas.py:121",
                 lambda: (sel.gather_fwd_kernel(table, refs),),
                 lambda: (sel.gather_fwd_plain(table, refs),),
                 (table, refs.qcol), 0,
                 lambda: table.index_select(0, jf).mul_(jm)),
            case("gather_bwd", "colblock_select.cu", "colblock_pallas.py:148",
                 lambda: (sel.gather_bwd_kernel(edges, refs),),
                 lambda: (sel.gather_bwd_plain(edges, refs),),
                 (4 * ne * D, refs.qcol), ne * D,
                 lambda: table.new_zeros((Ap + 1, D)).index_add_(
                     0, jpad, flat)),
            case("expand_fwd", "colblock_select.cu", "colblock_pallas.py:211",
                 lambda: (sel.expand_fwd_kernel(table, refs),),
                 lambda: (sel.expand_fwd_plain(table, refs),),
                 (table, refs.dcol), 0,
                 lambda: table.index_select(0, if_).mul_(im)),
            case("fold_fwd", "colblock_select.cu", "colblock_pallas.py:244",
                 lambda: (sel.fold_fwd_kernel(edges, refs),),
                 lambda: (sel.fold_fwd_plain(edges, refs),),
                 (4 * ne * D, refs.dcol), ne * D,
                 lambda: table.new_zeros((Ap + 1, D)).index_add_(
                     0, ipad, flat)),
        ]

    D = rep.convs[0].cg_deg.shape[0] * rep.n_atom_basis
    wide = cases(D, torch.randn((Ap, D), generator=g).to(dev),
                 torch.randn((nx, ny, Ktot, D), generator=g).to(dev))
    rows = check_kernels(wide)
    del wide
    narrow = cases(3, R, torch.randn((nx, ny, Ktot, 3), generator=g).to(dev))
    for c in narrow:
        c["tag"] = " (D = 3)"
    for row, r3 in zip(rows, check_kernels(narrow)):
        row["d3"] = {k: r3[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")}
    return rows


def reference_phase(dev):
    """Both PaiNN message forms, SchNet, SO3net and PaiNN's row-9 path with
    a trainable Gaussian and a Bessel basis against their JAX references;
    forces per path."""
    from schnetpack_tpu_torch.md import load_molecules

    out = {}
    for path in REFERENCE:
        ref = np.load(REFERENCE[path])
        pot, params = potential(path)
        calc = calculator(pot, params)
        system = load_molecules([molecule(ref["R"].astype(np.float64),
                                          ref["cell"])], device=dev)
        system = calc.calculate(system, calc.init_state(system))
        F = (system.forces[0] / calc.force_conversion).cpu().numpy()
        E = float(system.energy[0, 0]) / calc.energy_conversion
        rms = float(np.sqrt(np.mean((F - ref["forces"]) ** 2)))
        dE = abs(E - float(ref["energy"])) / abs(float(ref["energy"]))
        print(f"reference ({path}): force rms err {rms:.3e} eV/Ang (max "
              f"{np.abs(F - ref['forces']).max():.3e}), energy {E:.6f} vs "
              f"{float(ref['energy']):.6f} eV (rel {dE:.2e})", flush=True)
        assert np.isfinite(F).all() and F.shape == ref["forces"].shape
        assert rms <= FORCE_RMS_TOL, f"{path}: force rms {rms}"
        assert dE <= ENERGY_RTOL, f"{path}: energy rel err {dE}"
        out[path] = F
    d = out["hybrid"] - out["full"]
    print(f"hybrid vs full forces: rms {np.sqrt(np.mean(d ** 2)):.3e}, max "
          f"{np.abs(d).max():.3e} eV/Ang", flush=True)


def edge_keys(state, A, inv_cell):
    """Sorted int64 keys (original i, original j, periodic shift) of every
    edge of a column neighbor state."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.ops.colblock import ColRefs, decode_i, decode_j

    qcol = state[P.cell_qcol]
    nx, ny, _ = qcol.shape
    refs = ColRefs(qcol, state[P.cell_dcol],
                   state["cell_order"].shape[0] // (nx * ny),
                   tuple(state[P.cell_ksz]))
    j, valid = decode_j(refs)
    i, _ = decode_i(refs)
    order = state["cell_order"]
    shift = torch.round(state[P.cell_coff_fm].movedim(2, 3) @ inv_cell)
    code = ((shift.long() + 1)
            * torch.tensor([9, 3, 1], device=shift.device)).sum(-1)
    keys = (order[i] * A + order[j]) * 27 + code
    return torch.sort(keys[valid]).values


def rebuild_phase(seed, dev):
    """Device rebuild against a host build on a jittered lattice."""
    from schnetpack_tpu_torch.md import load_molecules
    from schnetpack_tpu_torch.ops.colblock_rebuild import rebin_and_rebuild

    pos, cell = fcc_box(10_000)
    pot, params = potential("hybrid")
    calc = calculator(pot, params, jitter=0.5, headroom=1.0 / 6.0)
    nbl = calc.nbl
    system = load_molecules([molecule(pos, cell)], device=dev)
    calc.init_state(system)
    jit = np.random.RandomState(seed + 2).uniform(
        -REBUILD_JITTER, REBUILD_JITTER, pos.shape) * calc.position_conversion
    moved = system.replace(positions=system.positions + torch.as_tensor(
        jit[None], dtype=system.positions.dtype, device=dev))
    assert nbl._dev_rebuild is not None, "the bench box should be eligible"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assert nbl.maybe_rebuild(moved), "the skin check did not fire"
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    assert (nbl.n_builds, nbl.n_device_builds) == (1, 1), (
        f"host {nbl.n_builds}, device {nbl.n_device_builds}, overflows "
        f"{nbl.n_device_overflows}")
    st_dev = nbl.state()
    info = nbl._dev_rebuild
    dev_ms = cuda_ms(lambda: rebin_and_rebuild(
        moved.positions, st_dev["cell_order"], st_dev["cell_atom_mask"],
        st_dev["cell_Z"], st_dev["cell_idx_m"], info["cell"], info["nx"],
        info["ny"], info["P"], info["ks"], info["rc"]))
    F_dev = calc.calculate(moved, st_dev).forces[0]
    t0 = time.perf_counter()
    nbl.build(moved)
    host_s = time.perf_counter() - t0
    st_host = nbl.state()
    F_host = calc.calculate(moved, st_host).forces[0]

    inv_cell = torch.linalg.inv(info["cell"])
    keys = [edge_keys(st, pos.shape[0], inv_cell) for st in (st_dev, st_host)]
    rms = float(((F_dev - F_host) / calc.force_conversion).pow(2).mean()
                .sqrt())
    print(f"device rebuild: {keys[0].numel()} edges (host {keys[1].numel()}),"
          f" {layout_str(st_dev)}; first call {first_ms:.3f} ms wall, steady "
          f"{dev_ms:.3f} ms (CUDA events); host build {host_s:.3f} s; force "
          f"rms device vs host {rms:.3e} eV/Ang", flush=True)
    assert torch.equal(keys[0], keys[1]), "device and host edge sets differ"
    assert rms <= REBUILD_FORCE_RMS_TOL, f"force rms {rms}"


def md_phase(path, pos, cell, steps, seed, dev, launches):
    """NVE run on one path of ``PATHS``; returns (launch counts,
    ms/step)."""
    from schnetpack_tpu_torch.md import (
        MaxwellBoltzmannInit, Simulator, VelocityVerlet, load_molecules,
    )
    from schnetpack_tpu_torch.units import md_units

    pot, params = potential(path)
    calc = calculator(pot, params)
    nbl = calc.nbl
    system = load_molecules([molecule(pos, cell)], device=dev)
    system = MaxwellBoltzmannInit(30.0).initialize_system(
        system, torch.Generator().manual_seed(seed + 1))
    sim = Simulator(system, VelocityVerlet(0.5), calc)
    sim.simulate(100, chunk_size=100)            # warm-up (equilibration)
    nbl.retighten(sim.system, jitter_fraction=0.05,
                  bucket_headroom=1.0 / 24.0)
    sim.calc_state = nbl.state()
    print(f"md ({path}) after retighten: {layout_str(sim.calc_state)}",
          flush=True)
    builds0 = (nbl.n_builds, nbl.n_device_builds, nbl.n_device_overflows)
    for counts in launches:
        for k in counts:
            counts[k] = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    sim.simulate(steps, chunk_size=100)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms_step = start.elapsed_time(end) / steps
    counts = {k: v for c in launches for k, v in c.items()}
    host, device, overflows = (
        a - b for a, b in zip((nbl.n_builds, nbl.n_device_builds,
                               nbl.n_device_overflows), builds0))

    s = sim.system
    A = s.total_atoms
    R = s.positions.cpu().numpy()
    T = float(s.temperature.mean())
    logs = sim.logs[-(steps // 100):]
    E_pot = np.concatenate([lg["energy"][:, 0, 0] for lg in logs])
    T_log = np.concatenate([lg["temperature"][:, 0, 0] for lg in logs])
    E_kin = 1.5 * A * md_units().kB * T_log            # MD energy units
    E_tot = (E_pot + E_kin) / calc.energy_conversion   # eV
    drift = float(np.abs(E_tot - E_tot[0]).max()) / A
    print(f"md ({path}): {steps} steps, {A} atoms, ms/step (CUDA events) "
          f"{ms_step:.3f}, wall {1e3 * wall / steps:.3f} ms/step, "
          f"{A / (ms_step * 1e-3):.4g} atom-steps/s, T_end={T:.2f} K, "
          f"max |E_tot - E_tot(0)| = {drift:.3e} eV/atom, rebuilds: "
          f"{device} on the device, {host} on the host, {overflows} "
          f"overflows", flush=True)
    assert np.isfinite(R).all(), "non-finite positions"
    assert 0.0 < T < 300.0, f"temperature {T} K"
    assert drift <= DRIFT_TOL, f"energy drift {drift} eV/atom"
    for k, v in counts.items():
        want = PER_STEP[path].get(k, 0) * steps
        assert v == want, f"{path}: {k} launched {v} times, want {want}"
    assert host == overflows, (
        f"{host} host rebuilds after the retighten, {overflows} overflows")
    return counts, ms_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    import schnetpack_tpu_torch  # noqa: F401 (sets f32 matmul precision)
    from schnetpack_tpu_torch.md import load_molecules
    from schnetpack_tpu_torch.ops import _build
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op
    from schnetpack_tpu_torch.ops import colblock_message as msg
    from schnetpack_tpu_torch.ops import colblock_select as sel
    from schnetpack_tpu_torch.ops import painn_mixing as mix
    from schnetpack_tpu_torch.ops import schnet_columns as cf

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.build_seconds:.1f} s)", flush=True)

    pos, cell = fcc_box(10_000)
    system = load_molecules([molecule(pos, cell)], device=dev)
    rows = kernel_phase(calculator(*potential("hybrid")), system, args.seed,
                        dev)
    rows += schnet_kernel_phase(calculator(*potential("schnet")), system,
                                args.seed, dev)
    rows += select_kernel_phase(calculator(*potential("so3net")), system,
                                args.seed, dev)
    reference_phase(dev)
    rebuild_phase(args.seed, dev)
    launches = (msg.LAUNCHES, mix.LAUNCHES, geo_op.LAUNCHES, cf.LAUNCHES,
                sel.LAUNCHES)
    total = {}
    ms_step = {}
    for path in PATHS:
        counts, ms_step[path] = md_phase(path, pos, cell, args.steps,
                                         args.seed, dev, launches)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    for row in rows:
        row["launches"] = total[row["name"]]
        assert row["launches"] > 0, f"{row['name']} never ran in the MD"
    print(f"md ms/step PaiNN hybrid {ms_step['hybrid']:.3f}, PaiNN full "
          f"{ms_step['full']:.3f}, SchNet {ms_step['schnet']:.3f}, SO3net "
          f"{ms_step['so3net']:.3f}, PaiNN trbf {ms_step['painn_trbf']:.3f} "
          f"on {smi}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
