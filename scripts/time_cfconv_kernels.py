"""Time K9 and K10, SchNet's cfconv and its VJP, of one source tree on
the GPU.

Builds the kernels of the tree at ``--root`` (default: this repository;
another checkout, e.g. an archive of a parent commit, for an A/B inside one
call) and times K9, K10 and K10's wgrad instance at the SchNet MD run's
shapes (``chip_smoke.py`` phase 3: the 10,976-atom argon box in the layout
the port's neighbor list builds, F = 128, B = 20, the trained SchNet's
first filter network, random features and cotangent from ``--seed``):
CUDA events around ``--reps`` calls after a warm-up, and with
``--device-ms`` also the device time, the kernels' durations in
``torch.profiler``'s CUDA trace, as ``chip_smoke.py`` reads it.  ``--set
NAME=VALUE`` times a copy of the tree's package, made under ``_scratch/``
of this repository, whose ``csrc/schnet_columns.cu`` has the constant NAME
set to VALUE (the kernels' tuning constants, e.g. ``kGroups=4``);
``--groups NAME=G`` fixes the row ranges a column of K9 (``fwd``), K10
(``bwd``) or K10's wgrad instance (``wgrad``) at G instead of the module's
``FWD_RANGES``, ``BWD_RANGES`` or ``WGRAD_RANGES``.  ``--tol`` prints the
worst miss of the float64 twin, as a share of the tolerance, of K9's
output and K10's dh and ggeo
(elementwise, ``chip_smoke.RTOL``/``ATOL``) and of the wgrad instance's
weight cotangents (normwise, ``chip_smoke.NORM_RTOL``), beside the f32
twin's own.  Prints ptxas's registers, stack frame and spills of the
cfconv kernels where it built them, then one line per kernel, and the
card.  Run from the repository root on a GPU:

    python3 scripts/time_cfconv_kernels.py [--root DIR] [--device-ms] \
        [--tol] [--groups NAME=G ...] [--set NAME=VALUE ...]
"""
import argparse
import importlib.util
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device-ms", action="store_true",
                    help="also the device time from torch.profiler")
    ap.add_argument("--tol", action="store_true",
                    help="the worst miss of the float64 twin")
    ap.add_argument("--groups", action="append", default=[],
                    metavar="NAME=G",
                    help="row ranges a column of fwd, bwd or wgrad")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="a constant of csrc/schnet_columns.cu, in a copy")
    args = ap.parse_args()
    if args.set:
        args.root = variant(args.root, args.set)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_cfconv_kernels: no CUDA device")
    from schnetpack_tpu_torch.md import load_molecules
    from schnetpack_tpu_torch.ops import _build
    from schnetpack_tpu_torch.ops import schnet_columns as cf

    # this repository's readers and run set-up, whatever --root is
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _build.build()
    src = "schnet_columns.cu"
    for inst, regs, frame, st, ld in smoke.ptxas_report(
            _build.build_log.get(src, ""), smoke.PTXAS_SOURCES[src]):
        print(f"ptxas {src}: {inst}: {regs} registers, {frame} bytes stack "
              f"frame, {st} bytes spill stores, {ld} bytes spill loads "
              f"(tree {args.root})", flush=True)
    for x in args.groups:
        name, value = x.split("=")
        const = {"fwd": "FWD_RANGES", "bwd": "BWD_RANGES",
                 "wgrad": "WGRAD_RANGES"}.get(name)
        if const not in vars(cf):
            sys.exit(f"time_cfconv_kernels: no ranges {name} in the tree's "
                     "ops/schnet_columns.py")
        setattr(cf, const, int(value))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    pos, cell = smoke.fcc_box(10_000)
    system = load_molecules([smoke.molecule(pos, cell)], device=dev)
    calc = smoke.calculator(*smoke.potential("schnet"))
    R, coff, refs = smoke.run_inputs(calc, system)
    rep = calc.model.representation
    F, Ap = rep.n_atom_basis, R.shape[0]
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op

    geo = geo_op.geo_fwd_kernel(R, coff, refs, rep.cw, rep.cutoff,
                                with_d=False, raw_phi=True)
    g = torch.Generator().manual_seed(args.seed + 10)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    i0 = rep.interactions[0]
    cargs = (rnd(Ap, F, scale=0.3), geo,
             i0.filter_0.weight.t().contiguous(), i0.filter_0.bias,
             i0.filter_1.weight.t().contiguous(), i0.filter_1.bias, refs)
    g_out = rnd(Ap, F)
    calls = {"cf_fwd": lambda: (cf.cf_fwd_kernel(*cargs),),
             "cf_bwd": lambda: cf.cf_bwd_kernel(*cargs, g_out),
             "cf_bwd_wgrad": lambda: cf.cf_bwd_kernel(*cargs, g_out,
                                                      wgrad=True)}
    plain = {"cf_fwd": lambda: (cf.cf_fwd_plain(*cargs),),
             "cf_bwd": lambda: cf.cf_bwd_plain(*cargs, g_out)[:2]}
    device_ms = smoke.device_ms if args.device_ms else None
    slots = int((refs.qcol >= 0).sum())
    for name, fn in calls.items():
        out = fn()
        err = max(float((a - b).abs().max()) for a, b in zip(
            out, plain[name.replace("_wgrad", "")]()))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        on_dev = ("" if device_ms is None else
                  f", device {device_ms(fn, reps=args.reps):.4f} ms")
        print(f"{name}: {start.elapsed_time(end) / args.reps:.4f} ms per "
              f"call{on_dev}, max |kernel - twin| {err:.3g} "
              f"({slots} slots, A' = {Ap}, F = {F}, tree {args.root}) on "
              f"{smi}", flush=True)
    if args.tol:
        tolerance_shares(cf, smoke, cargs, g_out, calls, args.root)


def tolerance_shares(cf, smoke, cargs, g_out, calls, root):
    """max |x - twin64| / (ATOL + RTOL |twin64|) of K9's output and of
    K10's dh and ggeo, and ||x - twin64|| / (NORM_RTOL ||twin64||) of the
    weight cotangents, for the kernels' instances and the f32 twins."""
    def shares(names, out, want):
        got = []
        for i, (x, w) in enumerate(zip(out, want)):
            x, w = x.double(), w.double()
            if i < 2:
                s = ((x - w).abs() / (smoke.ATOL + smoke.RTOL * w.abs())).max()
            else:
                s = (x - w).norm() / (smoke.NORM_RTOL * w.norm())
            got.append(f"{names[i]} {float(s):.3f}")
        return ", ".join(got)

    want = smoke.in_f64(lambda *a: (cf.cf_fwd_plain(*a),), *cargs)
    for who, out in (("cf_fwd", calls["cf_fwd"]()),
                     ("f32 twin", (cf.cf_fwd_plain(*cargs),))):
        print(f"tolerance share of the float64 twin, {who}: "
              f"{shares(('out',), out, want)} (tree {root})", flush=True)
    want = smoke.in_f64(cf.cf_bwd_plain, *cargs, g_out)
    have = {name: calls[name]() for name in ("cf_bwd", "cf_bwd_wgrad")}
    have["f32 twin"] = cf.cf_bwd_plain(*cargs, g_out)
    names = ("dh", "ggeo", "gW1", "gb1", "gW2", "gb2")
    for who, out in have.items():
        print(f"tolerance share of the float64 twin, {who}: "
              f"{shares(names, out, want)} (tree {root})", flush=True)


def variant(root, sets):
    """A copy of ``root``'s package under ``_scratch/`` with the constants
    ``sets`` (NAME=VALUE) of ``csrc/schnet_columns.cu`` replaced."""
    dst = os.path.join(ROOT, "_scratch", "cf_" + "_".join(
        x.replace("=", "") for x in sets))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "schnetpack_tpu_torch"),
                    os.path.join(dst, "schnetpack_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = os.path.join(dst, "schnetpack_tpu_torch", "csrc",
                       "schnet_columns.cu")
    with open(src) as f:
        text = f.read()
    for x in sets:
        name, value = x.split("=")
        text, n = re.subn(rf"\b({name} = )\d+", rf"\g<1>{value}", text)
        if n != 1:
            sys.exit(f"time_cfconv_kernels: no constant {name} in {src}")
    with open(src, "w") as f:
        f.write(text)
    return dst


if __name__ == "__main__":
    main()
