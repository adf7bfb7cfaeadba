"""Time the PaiNN mixing kernels K3/K4 of one source tree on the GPU.

Builds the kernels of the tree at ``--root`` (default: this repository;
another checkout, e.g. an archive of a parent commit, for an A/B inside one
call), and times K3, K4 and, where the tree has it, K4's wgrad instance at
the column layout's 12,800 rows, F = 128, on random inputs from ``--seed``
with the trained PaiNN's first mixing block (CUDA events, mean of
``--reps`` after a warm-up; with ``--device-ms`` also the device time, the
kernels' durations in ``torch.profiler``'s CUDA trace of ``--reps`` calls,
as ``chip_smoke.py`` phase 3 reads it).  ``--set NAME=VALUE`` times a
copy of the tree's package, made under ``_scratch/`` of this repository,
whose ``csrc/painn_mixing.cu`` has the constant NAME set to VALUE (the
kernels' tuning constants, e.g. ``kFwdRows=32``).  Prints ptxas's
registers, stack frame and spills of the mixing kernels where it built
them, then one line per kernel with its largest difference from the plain
twin, and the card.  ``--tol`` adds K3's worst miss of its float64 twin
as a share of the mixing tolerance (``tests/torch_port_cases.py``) on the
card tests' random inputs at F = 128 and 256, both activations.
Run from the repository root on a GPU:

    python3 scripts/time_mixing_kernels.py [--root DIR] [--rows 12800] \
        [--device-ms] [--tol] [--set NAME=VALUE ...]
"""
import argparse
import importlib.util
import inspect
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--rows", type=int, default=12_800)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device-ms", action="store_true",
                    help="also the device time from torch.profiler")
    ap.add_argument("--tol", action="store_true",
                    help="K3's worst miss as a share of the tolerance")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="a constant of csrc/painn_mixing.cu, in a copy")
    args = ap.parse_args()
    if args.set:
        args.root = variant(args.root, args.set)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_mixing_kernels: no CUDA device")
    from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
    from schnetpack_tpu_torch.ops import _build
    from schnetpack_tpu_torch.ops import painn_mixing as mix

    # this repository's readers, whatever --root is
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _build.build()
    src = "painn_mixing.cu"
    for inst, regs, frame, st, ld in smoke.ptxas_report(
            _build.build_log.get(src, ""), smoke.PTXAS_SOURCES[src]):
        print(f"ptxas {src}: {inst}: {regs} registers, {frame} bytes stack "
              f"frame, {st} bytes spill stores, {ld} bytes spill loads "
              f"(tree {args.root})", flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    params = params_from_jax(load_jax_params(os.path.join(
        ROOT, "scripts", "assets", "bench_painn_argon.msgpack")))
    w = [params[f"representation.mixing.0.{k}"].to(dev)
         for k in ("kmix", "k0", "b0", "k1", "b1")]
    F, A = w[0].shape[0], args.rows
    g = torch.Generator().manual_seed(args.seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    xargs = (rnd(A, F), rnd(A, 3 * F, scale=0.3), rnd(A, F, scale=0.3),
             rnd(A, 3 * F, scale=0.3), *w, 1e-8, "ssp")
    cots = (rnd(A, F), rnd(A, 3 * F))
    calls = {"mix_fwd": lambda: mix.mix_fwd_kernel(*xargs),
             "mix_bwd": lambda: mix.mix_bwd_kernel(*xargs, *cots)}
    plain = {"mix_fwd": lambda: mix.painn_mixing_plain(*xargs),
             "mix_bwd": lambda: mix.painn_mixing_bwd_plain(*xargs, *cots)}
    if "wgrad" in inspect.signature(mix.mix_bwd_kernel).parameters:
        calls["mix_bwd_wgrad"] = lambda: mix.mix_bwd_kernel(*xargs, *cots,
                                                            wgrad=True)
    device_ms = smoke.device_ms if args.device_ms else None
    for name, fn in calls.items():
        out = fn()
        err = ("" if name not in plain else ", max |kernel - twin| %.3g" % max(
            float((a - b).abs().max()) for a, b in zip(out, plain[name]())))
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
              f"call{on_dev}{err} ({A} rows, F = {F}, tree {args.root}) on "
              f"{smi}", flush=True)
    if args.tol:
        tolerance_shares(mix, A, dev, args.root)


def tolerance_shares(mix, A, dev, root):
    """K3's max |kernel - twin64| / (MIX_ATOL + MIX_RTOL |twin64|) on the
    inputs of ``test_mixing_forward_at_widths_matches_twin``."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_port_cases import MIX_ATOL, MIX_INPUTS, MIX_RTOL, mixing_case

    for F in (128, 256):
        c = mixing_case(A=A, F=F, seed=F + A + 1)
        ins = [torch.tensor(c[k], device=dev) for k in MIX_INPUTS]
        for act in ("ssp", "silu"):
            got = mix.mix_fwd_kernel(*ins, 1e-8, act)
            want = mix.painn_mixing_plain(*[t.double() for t in ins], 1e-8,
                                          act)
            share = [float(((g.double() - w).abs()
                            / (MIX_ATOL + MIX_RTOL * w.abs())).max())
                     for g, w in zip(got, want)]
            print(f"mix_fwd tolerance share, F = {F}, {act}: q_out "
                  f"{share[0]:.3f}, mu_out {share[1]:.3f} ({A} rows, tree "
                  f"{root})", flush=True)


def variant(root, sets):
    """A copy of ``root``'s package under ``_scratch/`` with the constants
    ``sets`` (NAME=VALUE) of ``csrc/painn_mixing.cu`` replaced."""
    dst = os.path.join(ROOT, "_scratch", "mix_" + "_".join(
        x.replace("=", "") for x in sets))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "schnetpack_tpu_torch"),
                    os.path.join(dst, "schnetpack_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = os.path.join(dst, "schnetpack_tpu_torch", "csrc", "painn_mixing.cu")
    with open(src) as f:
        text = f.read()
    for x in sets:
        name, value = x.split("=")
        text, n = re.subn(rf"\b({name} = )\d+", rf"\g<1>{value}", text)
        if n != 1:
            sys.exit(f"time_mixing_kernels: no constant {name} in {src}")
    with open(src, "w") as f:
        f.write(text)
    return dst


if __name__ == "__main__":
    main()
