"""Smoke run of the PyTorch/CUDA port on one GPU (run from the repo root):

    python3 chip_smoke.py [--seed 0] [--steps 300]

Phases (any failure exits non-zero before the last line is printed):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``schnetpack_tpu_torch/csrc`` (one nvcc per
   source, started together; sm_90a) and print ptxas's registers, stack
   frame and spills of every instance of the message kernels;
3. hold each kernel K1-K21 against its plain PyTorch twin on the card at
   the shapes of the MD runs below (10,976-atom argon box in the layout the
   port's neighbor list builds, F=128, B=20, f32, random features and
   cotangents from --seed; K6/K7 on the geo that K5 computes there, K15 on
   K5's geo without the d channel, K9/K10 on the raw-phi geo of K5's raw
   form, with the trained SchNet's first filter network; K11-K14 at the
   positions' width D = 3 and SO3net's D = 9 x 64; K1/K2 again at F = 256
   on the same layout (a sub-row); K2, K7 and K15 also in
   their wgrad instances, which return the filter-weight cotangent gFW, a
   sum over all ~200k edges: those are held to the twin evaluated in
   float64, since the f32 twin's own sum is off by ~1e-5 there, as are
   K4's wgrad instance (the mixing weights' cotangents, at 12,800 rows)
   and K10's (the SchNet filter weights', on the SchNet run's layout);
   K20/K21 (row 12) and K21's wgrad instance in the wrap, halo_x and
   halo_xy source-index modes on the painn_slab layout (the bench box on
   the slab path's own grid and capacities, F = 128, B = 20, on the box's
   own basis and directions), and K11/K12 in the halo modes at D = 3; K16-K19
   on the 27-cell atom layout of the painn_cell run, K16/K17 at D = 3,
   K18/K19 on the basis and directions of the box's own geometry, K19 also
   in its wgrad instance, and K3/K4 again at that layout's 16,000 rows),
   tolerance rtol 1e-4 / atol 1e-5 elementwise, the copies K11 and K13
   (every width and mode) bit for bit; time both per call (``ms``: CUDA
   events around 10 back-to-back calls, so the host's time where it is
   the longer), the kernel also on the device (``device_ms``: its kernels'
   durations in ``torch.profiler``'s CUDA trace of 10 calls), and the one
   PyTorch call that computes the same function where there is one
   (K11-K14, K16, K17: ``index_select`` and the mask, ``index_add_``) both
   ways (``library_ms``, ``library_device_ms``); and work
   out each kernel's bound from the bytes of its inputs and outputs at
   3.35 TB/s and its FP32 operations at 67 TFLOP/s (H100 SXM data sheet),
   the operations those this run's data needs (the filter and products
   of K1/K2, K6/K7, K18 and K20 only on the slots inside the cutoff);
4. hold the port's energy and forces on the card to the JAX references
   (force rms <= 1e-4 eV/Ang, energy within 1e-5 relative): PaiNN in both
   message forms (``fuse`` = hybrid and full) to
   ``tests/data/port_ref_painn_argon.npz``, printing the force rms between
   the two, SchNet to ``tests/data/port_ref_schnet_argon.npz``, SO3net
   to ``tests/data/port_ref_so3net_argon.npz``, and PaiNN on the row-9
   path with a trainable Gaussian basis (the fixture's centers and widths)
   and with a Bessel basis to ``tests/data/port_ref_painn_{trbf,bessel}_
   argon.npz``, and PaiNN on the 27-cell atom layout (``painn_cell``) and
   on the slab path (``painn_slab``, through ``make_sharded_column_eval``
   on one card) to ``port_ref_painn_argon.npz``, printing their force rms
   against ``full``; then the gradient of the energy with respect to every
   parameter of PaiNN-128x3 (``fuse`` full and hybrid, and on the slab
   path) and SchNet-128x3 on that box, with the energy output only, against
   ``tests/data/port_ref_{painn,schnet}_grad_argon.npz``: per leaf
   ||g - g_jax|| <= 1e-4 ||g_jax||, a leaf under 1e-3 of the largest
   leaf's norm against 1e-7 of that norm; the launches of one evaluation
   (the mixing's, the cfconv's and row 12's wgrad instances, and K2/K7,
   whose wgrad instances count under their own names), and its time beside
   the frozen force evaluation;
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
   SchNet's path, SO3net's path and PaiNN's row-9 path (``painn_trbf``),
   and PaiNN on the 27-cell atom layout (``painn_cell``, the same cutoff
   and skin);
   check finite positions, 0 < T < 300 K, total-energy drift <= 1e-4
   eV/atom, the launches per step of every kernel (hybrid: K5 1,
   K6/K7/K3/K4 3; full: K1/K2/K3/K4 3; SchNet: K5 raw 1, K9/K10 3, K8 1;
   SO3net: K11 4, K12 3, K13 4, K14 4; painn_trbf: K11-K14 1 each,
   K6/K15/K3/K4 3; painn_cell: K16/K17 1, K18/K19/K3/K4 3; every other
   kernel 0), that on the column paths every rebuild after the retighten
   went through the device unless it overflowed, and that painn_cell, whose
   layout has no device rebuild, rebuilt on the host only (printing the
   count and wall time of those builds and the ms/step without them);
   then 300 NVE steps of ``painn_slab`` through the port's
   ``SpatialColumnSimulator`` on one card (30 K Maxwell-Boltzmann momenta
   from --seed, dt 0.5 fs, chunks of 50 steps with a host re-bin before
   each): finite, 0 < T < 300 K, drift of the total energy at the chunk
   boundaries <= 1e-4 eV/atom, per force evaluation (one per step and one
   at each chunk's start) K11/K12 halo 1, K13/K14 1, K20/K21/K3/K4 3 and
   every other kernel 0, the chunks' ms/step (CUDA events) apart from the
   re-bin's host seconds;
7. print the kernel table (every row and sub-row with ``ms`` and
   ``device_ms``, ``library_ms`` and ``library_device_ms``) and the card
   as JSON, then the result line.

The parameter gradients of phase 4 run before the device rebuild of phase
5, and the launches of row 12's, the mixing's and the cfconv's wgrad
instances in the table are those of phase 4's evaluations.
"""
import argparse
import json
import os
import re
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
                       ("painn_bessel", "painn_bessel"),
                       ("painn_cell", "painn")]
}
CUTOFF, SKIN = 5.0, 0.6          # Angstrom
RTOL, ATOL = 1e-4, 1e-5          # kernel vs twin, elementwise
#: the mixing's and cfconv's weight cotangents vs the f64 twin, normwise
#: (||g - w|| <= NORM_RTOL ||w||): sums over 12,800 rows or ~200k edges of
#: products of the kernels' f32 factors, whose rounding (~1e-6 relative
#: after 128-long dot products) walks; f64 partials remove only the
#: summation order's error
NORM_RTOL = 1e-5
#: the message kernels' sources and their templates' parameters, for the
#: ptxas report of the build
MSG_SOURCES = {"colblock_message.cu": ("kGeo", "kB4"),
               "colblock_message_bwd.cu": ("kMode", "kWgrad", "kB4")}
#: the numbers of a kernel row that its sub-rows carry
SUB_KEYS = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms", "wgrad")
FORCE_RMS_TOL = 1e-4             # eV/Ang vs the JAX reference
ENERGY_RTOL = 1e-5
GRAD_RTOL = 1e-4                 # per leaf, ||g - g_jax|| / ||g_jax||
GRAD_FLOOR = 1e-3                # leaves under this share of the largest norm
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
    "painn_cell": {"cell_gather_fwd": 1, "cell_gather_bwd": 1,
                   "cell_msg_fwd": 3, "cell_msg_bwd": 3, "mix_fwd": 3,
                   "mix_bwd": 3},
    "painn_slab": {"gather_fwd": 1, "gather_bwd": 1, "expand_fwd": 1,
                   "fold_fwd": 1, "msg_fwd_edge": 3, "msg_bwd_edge": 3,
                   "mix_fwd": 3, "mix_bwd": 3},
}
#: the energy parameter gradients of phase 4: their JAX fixture, and the
#: launches of one evaluation (the positions carry no gradient, so no
#: position VJP runs)
GRAD_REFERENCE = {path: os.path.join(ROOT, "tests", "data",
                                     f"port_ref_{name}_grad_argon.npz")
                  for path, name in [("full", "painn"), ("hybrid", "painn"),
                                     ("schnet", "schnet"),
                                     ("painn_slab", "painn")]}
GRAD_LAUNCHES = {
    "full": {"msg_fwd": 3, "msg_bwd": 3, "mix_fwd": 3, "mix_bwd_wgrad": 3},
    "hybrid": {"geo_fwd": 1, "msg_fwd_geo": 3, "msg_bwd_geores": 3,
               "mix_fwd": 3, "mix_bwd_wgrad": 3},
    "schnet": {"geo_fwd_raw": 1, "cf_fwd": 3, "cf_bwd_wgrad": 3},
    "painn_slab": {"gather_fwd": 1, "expand_fwd": 1, "msg_fwd_edge": 3,
                   "msg_bwd_edge_wgrad": 3, "mix_fwd": 3,
                   "mix_bwd_wgrad": 3},
}
#: the slab path's NVE run: time step (0.5 fs in the Angstrom/eV/amu frame,
#: whose time unit is 10.1805 fs), steps per chunk, start temperature
SLAB_DT = 0.5 / 10.180505
SLAB_CHUNK = 50
SLAB_T0 = 30.0                   # K
KB_EV = 8.617333262e-5           # eV / K

#: the MD paths of phase 6
PATHS = ("hybrid", "full", "schnet", "so3net", "painn_trbf", "painn_cell")


def ptxas_report(log: str, params):
    """(instance, registers, stack frame, spill stores, spill loads) of
    each kernel in ptxas's -v report ``log``; the instance is the kernel's
    name with its template arguments, read from the mangled name."""
    out, name, frame = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            k = re.search(r"\d([a-z_]+_kernel)I(.*?)EEv", name)
            args = re.findall(r"L[a-z](\d+)E", k.group(2)) if k else []
            inst = (f"{k.group(1)}<" + ", ".join(
                f"{p}={a}" for p, a in zip(params, args)) + ">"
                    if k else name)
            out.append((inst, int(m.group(1)), *frame))
            name, frame = None, (0, 0, 0)
    return out


def fcc_box(n_target: int, a: float = 5.26):
    """FCC argon supercell with ~n_target atoms (``bench.py::fcc_box``)."""
    n = int(round((n_target / 4) ** (1 / 3)))
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                    -1).reshape(-1, 1, 3)
    return ((base[None] + grid) * a).reshape(-1, 3), np.eye(3) * a * n


def cuda_ms(fn, reps=10):
    """Mean per-call time of ``fn`` after one warm-up call: one CUDA-event
    pair around ``reps`` back-to-back calls, so the host's work per call
    where it is longer than the device's."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: traces that ``device_ms`` took, and those it took again (lost kernels)
TRACES = {"taken": 0, "retaken": 0}


def device_ms(fn, reps=10, tries=5):
    """Mean device time of ``fn``: the durations of the kernels (and
    copies) that ``reps`` back-to-back calls ran on the card, summed from
    ``torch.profiler``'s CUDA trace, over ``reps``.  A first step of
    ``reps`` calls warms the tracer up and is dropped, and the measured
    calls start a few ms into their step (the trace can miss the first
    kernels of a window); a trace in which some kernel did not run a
    multiple of ``reps`` times lost kernels and is taken again.  The
    step's own range on the device (``ProfilerStep``) is no kernel."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(tries):
        TRACES["taken"] += 1
        traced = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: traced.extend(
                         e for e in p.key_averages()
                         if e.device_type == cuda
                         and not e.key.startswith("ProfilerStep"))) as prof:
            for _ in range(2):
                time.sleep(0.005)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        us = sum(e.device_time_total for e in traced)
        if us > 0 and all(e.count % reps == 0 for e in traced):
            return us / 1e3 / reps
        TRACES["retaken"] += 1
    raise AssertionError(
        f"the profiler's trace lost kernels in {tries} tries: "
        f"{[(e.key, e.count) for e in traced]}")


def in_f64(fn, *args):
    """``fn`` on float64 copies of its float32 tensor arguments, its outputs
    rounded to float32."""
    out = fn(*[a.double() if torch.is_tensor(a) and a.dtype == torch.float32
               else a for a in args])
    return tuple(o.float() for o in out)


def compare(name, got, want, norm_from=None, exact=False):
    """Max abs difference; elementwise rtol/atol (``exact``: equal), from
    output ``norm_from`` on normwise."""
    rtol, atol = (0.0, 0.0) if exact else (RTOL, ATOL)
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if norm_from is not None and i >= norm_from:
            d = float((g.double() - w.double()).norm())
            assert d <= NORM_RTOL * float(w.double().norm()), (
                f"{name}: output {i} off by {d} (norm {w.norm()})")
        else:
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{name}: {m}")
        err = max(err, float((g - w).abs().max()))
    return err


def molecule(R, cell):
    from schnetpack_tpu_torch import properties as P

    return {P.Z: np.full(len(R), 18, np.int64), P.R: R, P.cell: cell,
            P.pbc: np.ones(3, bool)}


def model_of(path):
    return path if path in ("schnet", "so3net") else "painn"


def potential(path="full", forces=True):
    """The trained model of a path and its parameters: PaiNN-128x3 with the
    message form ``path`` ("hybrid" or "full", PaiNN's own default),
    SchNet-128x3 (``path`` "schnet"), SO3net-64x3, lmax 2, with its
    ``PairwiseDistances`` input module (``path`` "so3net"), or PaiNN-128x3
    on the row-9 path with ``PairwiseDistances``: with the trbf fixture's
    trainable Gaussian basis ("painn_trbf") or a Bessel basis
    ("painn_bessel"), or PaiNN-128x3 with ``PairwiseDistances`` for the
    27-cell atom layout ("painn_cell") and the slab path ("painn_slab");
    without ``forces`` the energy output only (the parameter gradients'
    model)."""
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
    elif path in ("painn_cell", "painn_slab"):
        rep = PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
                    cutoff=CUTOFF)
        inputs = [PairwiseDistances()]
    else:
        rep = PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
                    cutoff=CUTOFF, fuse=path)
    heads = [Atomwise(n_in=rep.n_atom_basis)] + ([Forces()] if forces else [])
    pot = NeuralNetworkPotential(rep, heads, input_modules=inputs)
    return pot, params_from_jax(load_jax_params(ASSET[model_of(path)],
                                                radial_from=radial_from))


def layout_str(state):
    from schnetpack_tpu_torch import properties as P

    if P.cell_qidx in state:
        return f"dims={tuple(state[P.cell_qidx].shape)}"
    nx, ny, Ktot = state[P.cell_qcol].shape
    return (f"dims=({nx}, {ny}, {state['cell_order'].shape[0] // (nx * ny)})"
            f" Ktot={Ktot}")


def calculator(pot, params, jitter=0.25, headroom=1.0 / 12.0,
               layout="column", wgrad=False):
    from schnetpack_tpu_torch.md import CellBlockNeighborListMD
    from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
    from schnetpack_tpu_torch.units import _parse_unit, md_units

    conv = _parse_unit("Ang") * md_units().length
    nbl = CellBlockNeighborListMD(CUTOFF * conv, skin=SKIN * conv,
                                  layout=layout, jitter_fraction=jitter,
                                  bucket_headroom=headroom)
    return SchNetPackCalculator(pot, params, cutoff=CUTOFF, cutoff_shell=SKIN,
                                neighbor_list=nbl, wgrad=wgrad)


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
    """Each kernel against its twin (rtol/atol elementwise, ``exact``:
    equal), both timed per call (``cuda_ms``), the kernel and ``library``
    (one PyTorch call that computes the same function, where there is one)
    also on the device (``device_ms``), with its bound (from the bytes of
    ``inputs`` and of the kernel's outputs, and ``flops``); returns the
    rows of the kernel table."""
    rows = []
    for c in cases:
        name, kern, plain = c["name"], c["kern"], c["plain"]
        got = kern()
        err = compare(name, got, (c.get("ref") or plain)(),
                      c.get("norm_from"), c.get("exact", False))
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        dev_ms = device_ms(kern)
        lib_ms = lib_dev_ms = None
        if c.get("library"):
            lib_ms = cuda_ms(c["library"])
            lib_dev_ms = device_ms(c["library"])
        bound_ms, bound_by = bound(nbytes(c["inputs"], got), c["flops"])
        lib = ("none" if lib_ms is None
               else f"{lib_ms:.4f} ms (device {lib_dev_ms:.4f})")
        print(f"kernel {name}{c.get('tag', '')}: max_abs_err={err:.3e} "
              f"{ms:.4f} ms (device {dev_ms:.4f}; plain twin {plain_ms:.4f} "
              f"ms, library {lib}, bound {bound_ms:.4f} ms by {bound_by})",
              flush=True)
        row = {"name": name, "route": "cuda",
               "source": f"schnetpack_tpu_torch/csrc/{c['src']}",
               "replaces": f"schnetpack_tpu/ops/{c['replaces']}",
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "library_device_ms": lib_dev_ms}
        if c.get("wgrad"):   # the kernel's wgrad instance, also gFW
            (w,) = check_kernels([dict(c, **c["wgrad"], wgrad=None,
                                       tag=c.get("tag", "") + " (wgrad)")])
            row["wgrad"] = sub_row(w)
        rows.append(row)
    return rows


def sub_row(row):
    """The numbers of a row, for a sub-row of another (a wgrad instance, a
    width, a source-index mode or a layout)."""
    return {k: row[k] for k in SUB_KEYS if k in row}


def case(name, src, replaces, kern, plain, inputs, flops, library=None,
         wgrad=None, exact=False):
    """One kernel of the table; ``wgrad`` (``kern``, ``plain``, ``flops``
    and ``ref``, what the kernel is held to, where that is not ``plain``)
    adds its wgrad instance as a sub-row; ``exact``: a copy, held to its
    twin bit for bit."""
    return {"name": name, "src": src, "replaces": replaces, "kern": kern,
            "plain": plain, "inputs": inputs, "flops": flops,
            "library": library, "wgrad": wgrad, "exact": exact}


def real_edges(refs):
    return int((refs.qcol >= 0).sum())


def live_edges(refs, live):
    """Real slots where ``live`` ([nx, ny, Ktot] or its flat form) holds:
    the slots inside the cutoff, whose filter and message the kernels that
    skip fcut = 0 compute."""
    return int(((refs.qcol >= 0) & live.reshape(refs.qcol.shape)).sum())


def kernel_phase(calc, system, seed, dev):
    """K1-K7 and K15 against their twins at the MD run's shapes; returns
    rows.

    Operations per edge (an FMA counts 2): the filter (B+1) x 3F FMAs, 16F
    for the products and sums of the message, twice both for a backward,
    and the geometry where a kernel computes it, on every real slot; a
    wgrad instance adds the (B+1) x 3F FMAs of gFW.  The filter, message
    and gFW count only the slots inside the cutoff (``live_edges``) for
    K1/K2 and K6/K7, which skip the others (fcut = 0 adds exactly 0), and
    every real slot for K15, which returns each slot's geometry
    cotangent.  Per atom row the mixing's
    22 F^2 (44 F^2 backward: input cotangents and the recomputed
    forward; the wgrad instance another 22 F^2 for the weights'
    cotangents)."""
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
    ni = live_edges(refs, geo[:, :, B + 4] < rep.cutoff)
    print(f"slots: {ne} real, {ni} inside the cutoff", flush=True)
    per_edge, gfw_edge = 6 * F * (B + 1) + 16 * F, 6 * F * (B + 1)
    msg_fwd, gfw = ni * per_edge, ni * gfw_edge
    msg_bwd = 2 * msg_fwd
    src_bwd, src_gfw = 2 * ne * per_edge, ne * gfw_edge   # every slot

    cases = [
        case("msg_fwd", "colblock_message.cu", "colblock_pallas.py:1889",
             lambda: msg.msg_fwd_kernel(*margs),
             lambda: msg.msg_fwd_plain(*margs),
             (x, mu, R, FW, coff, rep.cw, idx), msg_fwd + ne * geo_flops(B)),
        case("msg_bwd", "colblock_message_bwd.cu", "colblock_pallas.py:1239",
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
             (xargs[:9], g_dq, g_dmu), 44 * F * F * Ap,
             wgrad={"kern": lambda: mix.mix_bwd_kernel(*xargs, g_dq, g_dmu,
                                                       wgrad=True),
                    "plain": lambda: mix.painn_mixing_bwd_plain(
                        *xargs, g_dq, g_dmu, wgrad=True),
                    "ref": lambda: in_f64(
                        lambda *a: mix.painn_mixing_bwd_plain(*a, wgrad=True),
                        *xargs, g_dq, g_dmu),
                    "flops": 66 * F * F * Ap, "norm_from": 2}),
        case("geo_fwd", "colblock_geo.cu", "colblock_geo.py:202",
             lambda: (geo_op.geo_fwd_kernel(*gargs),),
             lambda: (geo_op.geo_fwd_plain(*gargs),),
             (R, coff, idx, rep.cw), ne * geo_flops(B)),
        case("msg_fwd_geo", "colblock_message.cu", "colblock_pallas.py:687",
             lambda: msg.msg_fwd_geo_kernel(*hargs),
             lambda: msg.msg_fwd_geo_plain(*hargs),
             (x, mu, geo, FW, idx), msg_fwd),
        case("msg_bwd_geores", "colblock_message_bwd.cu",
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
        case("msg_bwd_src", "colblock_message_bwd.cu",
             "colblock_pallas.py:834",
             lambda: msg.msg_bwd_src_kernel(*sargs),
             lambda: msg.msg_bwd_src_plain(*sargs)[:3],
             (x, mu, geo4, FW, idx, g_dq, g_dmu), src_bwd,
             wgrad={"kern": lambda: msg.msg_bwd_src_kernel(*sargs,
                                                           wgrad=True),
                    "plain": lambda: msg.msg_bwd_src_plain(*sargs),
                    "ref": lambda: in_f64(msg.msg_bwd_src_plain, *sargs),
                    "flops": src_bwd + src_gfw}),
    ]
    rows = check_kernels(cases)
    del cases
    # K1/K2 at F = 256 on the same layout (random features and weights):
    # sub-rows "f256" of their rows
    F2 = 256
    x2, mu2, FW2 = rnd(Ap, 3 * F2), rnd(Ap, 3 * F2), rnd(B + 1, 3 * F2)
    c2 = (rnd(Ap, F2, scale=1.0), rnd(Ap, 3 * F2, scale=1.0))
    a2 = (x2, mu2, R, FW2, coff, rep.cw, refs, rep.cutoff)
    fwd2 = ni * (6 * F2 * (B + 1) + 16 * F2)
    wide = [
        case("msg_fwd", "colblock_message.cu", "colblock_pallas.py:1889",
             lambda: msg.msg_fwd_kernel(*a2),
             lambda: msg.msg_fwd_plain(*a2),
             (x2, mu2, R, FW2, coff, rep.cw, idx), fwd2 + ne * geo_flops(B)),
        case("msg_bwd", "colblock_message_bwd.cu", "colblock_pallas.py:1239",
             lambda: msg.msg_bwd_kernel(*a2, *c2),
             lambda: msg.msg_bwd_plain(*a2, *c2)[:3],
             (x2, mu2, R, FW2, coff, rep.cw, idx, *c2),
             2 * fwd2 + 2 * ne * geo_flops(B)),
    ]
    for c in wide:
        c["tag"] = " (F = 256)"
    for row, r2 in zip(rows, check_kernels(wide)):
        row["f256"] = sub_row(r2)
    return rows


def schnet_kernel_phase(calc, system, seed, dev):
    """K5 raw, K8, K9 and K10 (and K10's wgrad instance) against their
    twins at the SchNet run's shapes, with the trained SchNet's first
    filter network; returns rows.  The filter network is B x F + F x F FMAs
    per real edge, twice that in the backward, and the wgrad instance's
    filter-weight cotangents another B x F + F x F."""
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
             (cargs[:6], idx, g_out), 2 * filt + ne * 12 * F,
             wgrad={"kern": lambda: cf.cf_bwd_kernel(*cargs, g_out,
                                                     wgrad=True),
                    "plain": lambda: cf.cf_bwd_plain(*cargs, g_out),
                    "ref": lambda: in_f64(cf.cf_bwd_plain, *cargs, g_out),
                    "flops": 3 * filt + ne * 12 * F, "norm_from": 2}),
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
                 lambda: table.index_select(0, jf).mul_(jm), exact=True),
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
                 lambda: table.index_select(0, if_).mul_(im), exact=True),
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
        row["d3"] = sub_row(r3)
    return rows


def cell_kernel_phase(calc, system, seed, dev):
    """K16-K19 against their twins at the painn_cell run's shapes (the
    27-cell layout of the bench box): K16/K17 at D = 3 on the positions and
    a random cotangent, K18/K19 on the rbf_aug and directions of the box's
    own geometry (the cell path's plain torch, zero at padded slots) with
    random features and cotangents from ``seed`` and the trained PaiNN's
    first filter weights; and K3/K4 at this layout's row count (16,000
    slots against the column layout's 12,800), built as in
    ``kernel_phase`` with the first mixing block's weights; returns rows.
    Operations per edge or row as in ``kernel_phase``: K18 counts the
    filter and message on the slots inside the cutoff (a zero basis row
    adds exactly 0), K19 on every real slot, since it returns each slot's
    basis and direction cotangents; K17 is one add per real edge and
    coordinate.  The library calls of K16/K17 take the
    source rows decoded once on the refs, while the kernels decode
    ``qidx`` themselves."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.atomistic.distances import cell_refs
    from schnetpack_tpu_torch.ops import cellblock_gather as cg
    from schnetpack_tpu_torch.ops import painn_fused as pf
    from schnetpack_tpu_torch.ops import painn_mixing as mix

    st = calc.init_state(system)
    inputs = calc.model_inputs(system, st)
    R = inputs[P.R].contiguous()
    refs = cell_refs(inputs)
    rep = calc.model.representation
    with torch.no_grad():
        rbf, dirs = rep._cell_geometry(calc.model.input_modules[0](inputs))
    rbf, dirs = rbf.contiguous(), dirs.contiguous()
    print(f"layout: {layout_str(st)} A'={R.shape[0]}", flush=True)
    F, Ap, K = rep.n_atom_basis, R.shape[0], refs.dims[4]
    B = rbf.shape[-1] - 1
    ne = int((refs.qidx >= 0).sum())
    live = (refs.qidx >= 0).reshape(rbf.shape[:-1]) & (rbf != 0).any(-1)
    ni = int(live.sum())
    g = torch.Generator().manual_seed(seed + 30)

    def rnd(*shape, scale=0.3):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    xmu, g3 = rnd(Ap, 6 * F), rnd(Ap, K, 3, scale=1.0)
    g_dq, g_dmu = rnd(Ap, F, scale=1.0), rnd(Ap, 3 * F, scale=1.0)
    margs = (xmu, rbf, dirs, rep.FW_aug[0].contiguous(), refs)
    j, valid = cg.decode_cell_j(refs)
    jf, jm = j.reshape(-1), valid.reshape(-1, 1).float()
    jpad = torch.where(valid, j, Ap).reshape(-1)
    msg_fwd = ni * (6 * F * (B + 1) + 16 * F)   # K18: live slots
    msg_bwd = 2 * ne * (6 * F * (B + 1) + 16 * F)   # K19: every slot
    gfw = ne * 6 * F * (B + 1)
    m0 = rep.mixing[0]
    xargs = (rnd(Ap, F, scale=1.0), rnd(Ap, 3 * F), g_dq * 0.3, g_dmu * 0.3,
             m0.kmix, m0.k0, m0.b0, m0.k1, m0.b1, m0.epsilon, m0.activation)
    cases = [
        case("mix_fwd", "painn_mixing.cu", "painn_mixing.py:73",
             lambda: mix.mix_fwd_kernel(*xargs),
             lambda: mix.painn_mixing_plain(*xargs), xargs[:9],
             22 * F * F * Ap),
        case("mix_bwd", "painn_mixing.cu", "painn_mixing.py:83",
             lambda: mix.mix_bwd_kernel(*xargs, g_dq, g_dmu),
             lambda: mix.painn_mixing_bwd_plain(*xargs, g_dq, g_dmu),
             (xargs[:9], g_dq, g_dmu), 44 * F * F * Ap),
        case("cell_gather_fwd", "cellblock_gather.cu",
             "cellblock_pallas.py:88",
             lambda: (cg.cell_gather_fwd_kernel(R, refs),),
             lambda: (cg.cell_gather_plain(R, refs),), (R, refs.qidx), 0,
             lambda: R.index_select(0, jf).mul_(jm)),
        case("cell_gather_bwd", "cellblock_gather.cu",
             "cellblock_pallas.py:143",
             lambda: (cg.cell_gather_bwd_kernel(g3, refs),),
             lambda: (cg.cell_gather_bwd_plain(g3, refs),),
             (4 * ne * 3, refs.qidx), ne * 3,
             lambda: R.new_zeros((Ap + 1, 3)).index_add_(
                 0, jpad, g3.reshape(-1, 3))),
        case("cell_msg_fwd", "painn_fused.cu", "painn_fused.py:116",
             lambda: pf.cell_msg_fwd_kernel(*margs),
             lambda: pf.cell_msg_fwd_plain(*margs),
             (margs[:4], refs.qidx), msg_fwd),
        case("cell_msg_bwd", "painn_fused.cu", "painn_fused.py:185",
             lambda: pf.cell_msg_bwd_kernel(*margs, g_dq, g_dmu),
             lambda: pf.cell_msg_bwd_plain(*margs, g_dq, g_dmu)[:3],
             (margs[:4], refs.qidx, g_dq, g_dmu), msg_bwd,
             wgrad={"kern": lambda: pf.cell_msg_bwd_kernel(
                        *margs, g_dq, g_dmu, wgrad=True),
                    "plain": lambda: pf.cell_msg_bwd_plain(*margs, g_dq,
                                                           g_dmu),
                    "ref": lambda: in_f64(pf.cell_msg_bwd_plain, *margs,
                                          g_dq, g_dmu),
                    "flops": msg_bwd + gfw}),
    ]
    for c in cases[:2]:
        c["tag"] = f" (27-cell, A' = {Ap})"
    return check_kernels(cases)


def slab_simulator(pos, cell, dev, pot=None, params=None):
    """The port's ``SpatialColumnSimulator`` of the bench box on one card
    (the trained PaiNN-128x3 unless ``pot`` is given)."""
    from schnetpack_tpu_torch.parallel import (
        SpatialColumnSimulator, make_column_mesh,
    )
    from schnetpack_tpu_torch.transform.atomistic import ATOMIC_MASSES

    if pot is None:
        pot, params = potential("painn_slab")
    pot.load_state_dict(params)
    n = len(pos)
    return SpatialColumnSimulator(
        pot, params, pos, np.full(n, 18), np.full(n, ATOMIC_MASSES[18]), cell,
        make_column_mesh(1, device=dev), cutoff=CUTOFF, skin=SKIN,
        dt=SLAB_DT)


def slab_temperature(masses, p):
    """The instantaneous temperature (K) of momenta p (amu Ang / 10.18 fs)."""
    return float((p ** 2 / masses[:, None]).sum() / (3 * len(p) * KB_EV))


def slab_momenta(sim, seed):
    """Maxwell-Boltzmann momenta at SLAB_T0 from ``seed`` (numpy), no net
    momentum, rescaled to SLAB_T0 exactly, into the simulator."""
    rng = np.random.RandomState(seed + 1)
    m = sim.masses[:, None]
    p = rng.standard_normal(sim.R.shape) * np.sqrt(m * KB_EV * SLAB_T0)
    p -= m * (p.sum(0) / m.sum())
    sim.p = p * np.sqrt(SLAB_T0 / slab_temperature(sim.masses, p))


def slab_inputs(sim, R, dev):
    """(layout, model inputs) of the slab path at positions ``R`` with the
    simulator's grid and sticky capacities."""
    from schnetpack_tpu_torch.parallel import column_inputs

    sim.R = np.asarray(R, np.float64)
    lay = sim.layout()
    return lay, column_inputs(lay, sim.R, sim.Z, device=dev)


def edge_kernel_phase(pos, cell, seed, dev):
    """K20, K21 (and K21's wgrad instance) in the three source-index modes
    and K11/K12 in the two halo modes (D = 3) against their twins on the
    painn_slab layout of the bench box: the basis and directions of the
    box's own geometry (the slab path's plain torch), random xmu over each
    mode's source table and random cotangents from ``seed``, the trained
    PaiNN's first filter weights; returns K20's and K21's rows in the
    path's mode (halo_x), the others under "modes", and K11's and K12's
    results per halo mode (for their rows' "modes").  Operations per
    edge as in ``kernel_phase``: K20 (and K6) counts the filter and
    message on the slots inside the cutoff, K21 (as K15) on every real
    slot; K12 is one add per real edge and
    coordinate, the library calls of K11/K12 take the decoded halo
    rows."""
    import dataclasses

    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.atomistic.distances import column_refs
    from schnetpack_tpu_torch.ops import colblock_edge as edge
    from schnetpack_tpu_torch.ops import colblock_select as sel
    from schnetpack_tpu_torch.ops.colblock import decode_src
    from schnetpack_tpu_torch.ops.colblock_shard import COLS_AXIS, COLS_AXIS_Y

    sim = slab_simulator(pos, cell, dev)
    lay, inputs = slab_inputs(sim, pos, dev)
    pot = sim.pot.to(dev)
    with torch.no_grad():
        rep = pot.representation
        inputs = pot.input_modules[0](inputs)
        rbf, dirs = rep._edge_geometry(inputs, P.col_rij,
                                       inputs[P.cell_emask])
    rbf, dirs = rbf.contiguous(), dirs.contiguous()
    refs0 = column_refs(inputs)
    nx, ny, Ktot = refs0.qcol.shape
    print(f"layout (painn_slab): dims=({nx}, {ny}, {refs0.P}) Ktot={Ktot} "
          f"A'={nx * ny * refs0.P}", flush=True)
    F, B = rep.n_atom_basis, rbf.shape[-1] - 1
    ne = real_edges(refs0)
    ni = live_edges(refs0, (rbf != 0).any(-1))
    FW = rep.FW_aug[0].detach().contiguous()
    g = torch.Generator().manual_seed(seed + 40)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    g_dq, g_dmu = rnd(nx * ny * refs0.P, F), rnd(nx * ny * refs0.P, 3 * F)
    msg_fwd = ni * (6 * F * (B + 1) + 16 * F)   # K20 skips fcut = 0
    msg_bwd = 2 * ne * (6 * F * (B + 1) + 16 * F)   # K21: every slot
    gfw = ne * 6 * F * (B + 1)
    idx = (refs0.qcol, refs0.dcol)
    rows, modes = {}, {}
    for mode, axis in [("halo_x", COLS_AXIS), ("wrap", None),
                       ("halo_xy", (COLS_AXIS, COLS_AXIS_Y))]:
        refs = dataclasses.replace(refs0, shard_axis=axis, cache={})
        n_src = refs.src_rows
        xmu = rnd(n_src, 6 * F, scale=0.3)
        margs = (xmu, rbf, dirs, FW, refs)
        cases = [
            case("msg_fwd_edge", "colblock_message.cu",
                 "colblock_pallas.py:322",
                 lambda: edge.msg_fwd_edge_kernel(*margs),
                 lambda: edge.msg_fwd_edge_plain(*margs),
                 (margs[:4], idx), msg_fwd),
            case("msg_bwd_edge", "colblock_message_bwd.cu",
                 "colblock_pallas.py:391",
                 lambda: edge.msg_bwd_edge_kernel(*margs, g_dq, g_dmu),
                 lambda: edge.msg_bwd_edge_plain(*margs, g_dq, g_dmu)[:3],
                 (margs[:4], idx, g_dq, g_dmu), msg_bwd,
                 wgrad={"kern": lambda: edge.msg_bwd_edge_kernel(
                            *margs, g_dq, g_dmu, wgrad=True),
                        "plain": lambda: edge.msg_bwd_edge_plain(
                            *margs, g_dq, g_dmu),
                        "ref": lambda: in_f64(edge.msg_bwd_edge_plain,
                                              *margs, g_dq, g_dmu),
                        "flops": msg_bwd + gfw}),
        ]
        if mode != "wrap":
            table = rnd(n_src, 3)
            g3 = rnd(nx, ny, Ktot, 3)
            j, valid = decode_src(refs)
            jf, jm = j.reshape(-1), valid.reshape(-1, 1).float()
            jpad = torch.where(valid, j, n_src).reshape(-1)
            cases += [
                case("gather_fwd", "colblock_select.cu",
                     "colblock_shard.py:131",
                     lambda: (sel.gather_fwd_kernel(table, refs),),
                     lambda: (sel.gather_fwd_plain(table, refs),),
                     (table, refs.qcol), 0,
                     lambda: table.index_select(0, jf).mul_(jm),
                     exact=True),
                case("gather_bwd", "colblock_select.cu",
                     "colblock_shard.py:154",
                     lambda: (sel.gather_bwd_kernel(g3, refs),),
                     lambda: (sel.gather_bwd_plain(g3, refs),),
                     (4 * ne * 3, refs.qcol), ne * 3,
                     lambda: table.new_zeros((n_src + 1, 3)).index_add_(
                         0, jpad, g3.reshape(-1, 3))),
            ]
        for c in cases:
            c["tag"] = f" ({mode})"
        for row in check_kernels(cases):
            if mode == "halo_x" and row["name"].startswith("msg"):
                rows[row["name"]] = row
            else:
                modes.setdefault(row["name"], {})[mode] = sub_row(row)
    for name, row in rows.items():
        row["modes"] = modes.pop(name)
    return list(rows.values()), modes


def slab_reference_phase(dev):
    """PaiNN on the slab path through ``make_sharded_column_eval`` on one
    card against ``port_ref_painn_argon.npz``; returns its forces in the
    original atom order."""
    from schnetpack_tpu_torch.parallel import make_sharded_column_eval

    ref = np.load(REFERENCE["full"])
    sim = slab_simulator(ref["R"].astype(np.float64), ref["cell"], dev)
    lay, inputs = slab_inputs(sim, ref["R"], dev)
    E, Fs = make_sharded_column_eval(sim.pot, sim.params, inputs,
                                     sim.mesh)(inputs)
    F = Fs.detach().cpu().numpy()[lay.rank]
    E = float(E[0])
    rms = float(np.sqrt(np.mean((F - ref["forces"]) ** 2)))
    dE = abs(E - float(ref["energy"])) / abs(float(ref["energy"]))
    nx, ny, _ = lay.qcol.shape
    print(f"reference (painn_slab, dims=({nx}, {ny}, {lay.dims[2]}) "
          f"Ktot={lay.qcol.shape[2]}): force rms err {rms:.3e} eV/Ang (max "
          f"{np.abs(F - ref['forces']).max():.3e}), energy {E:.6f} vs "
          f"{float(ref['energy']):.6f} eV (rel {dE:.2e})", flush=True)
    assert np.isfinite(F).all() and F.shape == ref["forces"].shape
    assert rms <= FORCE_RMS_TOL, f"painn_slab: force rms {rms}"
    assert dE <= ENERGY_RTOL, f"painn_slab: energy rel err {dE}"
    return F


def grad_phase(dev, launches):
    """The energy's gradient with respect to every parameter on each path
    of ``GRAD_REFERENCE`` against its JAX fixture, with the launches of one
    evaluation (counts set to 0 just before it, read just after); returns
    the launch counts summed over the paths."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.md import load_molecules

    total = {}
    for path, fixture in GRAD_REFERENCE.items():
        ref = np.load(fixture)
        pot, params = potential(path, forces=False)
        fpot, _ = potential(path)
        if path == "painn_slab":
            sim = slab_simulator(ref["R"].astype(np.float64), ref["cell"],
                                 dev, pot, params)
            _, inputs = slab_inputs(sim, ref["R"], dev)
            pot.to(dev)
        else:
            calc = calculator(pot, params, wgrad=True)
            system = load_molecules([molecule(ref["R"].astype(np.float64),
                                              ref["cell"])], device=dev)
            inputs = calc.model_inputs(system, calc.init_state(system))
        fpot.load_state_dict(params)
        fpot.to(dev).requires_grad_(False)
        names, leaves = zip(*pot.named_parameters())

        def evaluate():
            E = pot(dict(inputs))[P.energy][0]
            return E, torch.autograd.grad(E, leaves)

        for counts in launches:
            for k in counts:
                counts[k] = 0
        E, grads = evaluate()
        torch.cuda.synchronize()
        counts = {k: v for c in launches for k, v in c.items() if v}
        assert counts == GRAD_LAUNCHES[path], (
            f"{path} gradient: launches {counts}, want "
            f"{GRAD_LAUNCHES[path]}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        norms = {n: float(np.linalg.norm(ref[f"grad/{n}"])) for n in names}
        floor = GRAD_FLOOR * max(norms.values())
        errs = {n: float(np.linalg.norm(g.double().cpu().numpy()
                                        - ref[f"grad/{n}"]))
                / max(norms[n], floor) for n, g in zip(names, grads)}
        worst = max(errs, key=errs.get)
        dE = (abs(float(E.detach()) - float(ref["energy"]))
              / abs(float(ref["energy"])))
        grad_ms = cuda_ms(evaluate, reps=5)
        force_ms = cuda_ms(lambda: fpot(dict(inputs)), reps=5)
        print(f"gradient ({path}): {len(names)} leaves, worst {worst} "
              f"||dg||/||g|| {errs[worst]:.3e} (|g| {norms[worst]:.3e}), "
              f"energy rel err {dE:.2e}; energy + parameter gradient "
              f"{grad_ms:.3f} ms, frozen energy + forces {force_ms:.3f} ms",
              flush=True)
        assert set(f"grad/{n}" for n in names) == {
            k for k in ref.files if k.startswith("grad/")}
        assert all(np.isfinite(g.cpu().numpy()).all() for g in grads)
        assert errs[worst] <= GRAD_RTOL, f"{path}: {worst} {errs[worst]}"
        assert dE <= ENERGY_RTOL, f"{path}: energy rel err {dE}"
    return total


def slab_md_phase(pos, cell, steps, seed, dev, launches):
    """NVE on the slab path through ``SpatialColumnSimulator``; returns
    (launch counts, ms/step).  The counts are set to 0 before each chunk
    and read after it; the total energy is evaluated at the chunk
    boundaries, outside them.  The ms/step is the chunks' CUDA-event time
    over the steps, without the host re-bins (printed apart)."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.parallel import make_sharded_column_eval

    sim = slab_simulator(pos, cell, dev)
    slab_momenta(sim, seed)
    A = len(pos)

    def temperature(p_):
        return slab_temperature(sim.masses, p_)

    def total_energy():
        lay, inputs = slab_inputs(sim, sim.R, dev)
        E, _ = make_sharded_column_eval(sim.pot, None, inputs,
                                        sim.mesh)(inputs)
        return float(E[0]) + 1.5 * A * KB_EV * temperature(sim.p)

    E_tot = [total_energy()]
    counts = {}
    n_chunks = -(-steps // SLAB_CHUNK)
    for _ in range(n_chunks):
        for c in launches:
            for k in c:
                c[k] = 0
        sim.simulate(SLAB_CHUNK, chunk_size=SLAB_CHUNK)
        torch.cuda.synchronize()
        for c in launches:
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
        E_tot.append(total_energy())
    ms_step = sum(sim.chunk_ms) / (n_chunks * SLAB_CHUNK)
    T = temperature(sim.p)
    drift = float(np.abs(np.asarray(E_tot) - E_tot[0]).max()) / A
    lay = sim.layout()
    print(f"md (painn_slab): {n_chunks * SLAB_CHUNK} steps, {A} atoms, "
          f"dims={lay.dims[:3]} Ktot={lay.qcol.shape[2]}, ms/step (CUDA "
          f"events, chunks only) {ms_step:.3f}, {A / (ms_step * 1e-3):.4g} "
          f"atom-steps/s, host re-bins {sim.rebuilds} in "
          f"{sim.host_seconds:.3f} s wall, T_end={T:.2f} K, max |E_tot - "
          f"E_tot(0)| at the chunk boundaries = {drift:.3e} eV/atom",
          flush=True)
    assert np.isfinite(sim.R).all(), "non-finite positions"
    assert 0.0 < T < 300.0, f"temperature {T} K"
    assert drift <= DRIFT_TOL, f"energy drift {drift} eV/atom"
    evals = n_chunks * (SLAB_CHUNK + 1)
    for k, v in counts.items():
        want = PER_STEP["painn_slab"].get(k, 0) * evals
        assert v == want, f"painn_slab: {k} launched {v} times, want {want}"
    return counts, ms_step


def layout_of(path):
    """The neighbor-list layout of an MD path."""
    return "atom" if path == "painn_cell" else "column"


def reference_phase(dev):
    """Both PaiNN message forms, SchNet, SO3net, PaiNN's row-9 path with a
    trainable Gaussian and a Bessel basis, PaiNN on the 27-cell layout and
    on the slab path against their JAX references; forces per path."""
    from schnetpack_tpu_torch.md import load_molecules

    out = {}
    for path in REFERENCE:
        ref = np.load(REFERENCE[path])
        pot, params = potential(path)
        calc = calculator(pot, params, layout=layout_of(path))
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
    out["painn_slab"] = slab_reference_phase(dev)
    for other in ("hybrid", "painn_cell", "painn_slab"):
        d = out[other] - out["full"]
        print(f"{other} vs full forces: rms {np.sqrt(np.mean(d ** 2)):.3e}, "
              f"max {np.abs(d).max():.3e} eV/Ang", flush=True)


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
    ms/step).  The ms/step is the CUDA-event time of the run over the
    steps, host rebuilds included; for painn_cell, whose rebuilds all run
    on the host, it is also printed with their wall time subtracted."""
    from schnetpack_tpu_torch.md import (
        MaxwellBoltzmannInit, Simulator, VelocityVerlet, load_molecules,
    )
    from schnetpack_tpu_torch.units import md_units

    pot, params = potential(path)
    calc = calculator(pot, params, layout=layout_of(path))
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
    build_s0 = nbl.build_seconds
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
    host_s = nbl.build_seconds - build_s0

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
          f"{device} on the device, {host} on the host ({host_s:.3f} s "
          f"wall), {overflows} overflows; ms/step without the host builds "
          f"{ms_step - 1e3 * host_s / steps:.3f}", flush=True)
    assert np.isfinite(R).all(), "non-finite positions"
    assert 0.0 < T < 300.0, f"temperature {T} K"
    assert drift <= DRIFT_TOL, f"energy drift {drift} eV/atom"
    for k, v in counts.items():
        want = PER_STEP[path].get(k, 0) * steps
        assert v == want, f"{path}: {k} launched {v} times, want {want}"
    if layout_of(path) == "atom":
        assert device == 0, f"{device} device rebuilds on the atom layout"
    else:
        assert host == overflows, (
            f"{host} host rebuilds after the retighten, {overflows} "
            "overflows")
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
    from schnetpack_tpu_torch.ops import cellblock_gather as cg
    from schnetpack_tpu_torch.ops import colblock_edge as edge
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op
    from schnetpack_tpu_torch.ops import colblock_message as msg
    from schnetpack_tpu_torch.ops import colblock_select as sel
    from schnetpack_tpu_torch.ops import painn_fused as pf
    from schnetpack_tpu_torch.ops import painn_mixing as mix
    from schnetpack_tpu_torch.ops import schnet_columns as cf

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.build_seconds:.1f} s)", flush=True)
    for src, params in MSG_SOURCES.items():
        for inst, regs, frame, st, ld in ptxas_report(
                _build.build_log.get(src, ""), params):
            print(f"ptxas {src}: {inst}: {regs} registers, {frame} bytes "
                  f"stack frame, {st} bytes spill stores, {ld} bytes spill "
                  "loads", flush=True)

    pos, cell = fcc_box(10_000)
    system = load_molecules([molecule(pos, cell)], device=dev)
    rows = kernel_phase(calculator(*potential("hybrid")), system, args.seed,
                        dev)
    rows += schnet_kernel_phase(calculator(*potential("schnet")), system,
                                args.seed, dev)
    rows += select_kernel_phase(calculator(*potential("so3net")), system,
                                args.seed, dev)
    edge_rows, halo_modes = edge_kernel_phase(pos, cell, args.seed, dev)
    rows += edge_rows
    by_name = {row["name"]: row for row in rows}
    for name, modes in halo_modes.items():   # K11/K12 on the slab's halo
        by_name[name]["modes"] = modes
    for row in cell_kernel_phase(calculator(*potential("painn_cell"),
                                            layout="atom"), system,
                                 args.seed, dev):
        if row["name"] in by_name:   # K3/K4 at the 27-cell layout's rows
            by_name[row["name"]]["cell"] = sub_row(row)
        else:
            rows.append(row)
    print(f"profiler: {TRACES['taken']} traces, {TRACES['retaken']} taken "
          "again (lost kernels)", flush=True)
    reference_phase(dev)
    launches = (msg.LAUNCHES, mix.LAUNCHES, geo_op.LAUNCHES, cf.LAUNCHES,
                sel.LAUNCHES, cg.LAUNCHES, pf.LAUNCHES, edge.LAUNCHES)
    wgrad_launches = grad_phase(dev, launches)
    rebuild_phase(args.seed, dev)
    total = {}
    ms_step = {}
    for path in PATHS:
        counts, ms_step[path] = md_phase(path, pos, cell, args.steps,
                                         args.seed, dev, launches)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    counts, ms_step["painn_slab"] = slab_md_phase(pos, cell, args.steps,
                                                  args.seed, dev, launches)
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    for row in rows:
        row["launches"] = total[row["name"]]
        assert row["launches"] > 0, f"{row['name']} never ran in the MD"
        key = row["name"] + "_wgrad"
        if key in wgrad_launches:   # an instance with its own counter
            row["wgrad"]["launches"] = wgrad_launches[key]
    for key in ("mix_bwd_wgrad", "cf_bwd_wgrad", "msg_bwd_edge_wgrad"):
        assert wgrad_launches.get(key, 0) > 0, f"{key} never ran"
    print(f"md ms/step PaiNN hybrid {ms_step['hybrid']:.3f}, PaiNN full "
          f"{ms_step['full']:.3f}, SchNet {ms_step['schnet']:.3f}, SO3net "
          f"{ms_step['so3net']:.3f}, PaiNN trbf {ms_step['painn_trbf']:.3f}, "
          f"PaiNN cell {ms_step['painn_cell']:.3f}, PaiNN slab "
          f"{ms_step['painn_slab']:.3f} on {smi}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
