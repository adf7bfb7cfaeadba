"""Time the PaiNN mixing kernels K3/K4 of one source tree on the GPU.

Builds the kernels of the tree at ``--root`` (default: this repository;
another checkout, e.g. an archive of a parent commit, for an A/B inside one
call), and times K3, K4 and, where the tree has it, K4's wgrad instance at
the column layout's 12,800 rows, F = 128, on random inputs from ``--seed``
with the trained PaiNN's first mixing block (CUDA events, mean of
``--reps`` after a warm-up; with ``--device-ms`` also the device time, the
kernels' durations in ``torch.profiler``'s CUDA trace of ``--reps`` calls,
as ``chip_smoke.py`` phase 3 reads it).  Prints one line per kernel and the
card.  Run from the repository root on a GPU:

    python3 scripts/time_mixing_kernels.py [--root DIR] [--rows 12800] \
        [--device-ms]
"""
import argparse
import importlib.util
import inspect
import os
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
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_mixing_kernels: no CUDA device")
    from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
    from schnetpack_tpu_torch.ops import painn_mixing as mix

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
    if "wgrad" in inspect.signature(mix.mix_bwd_kernel).parameters:
        calls["mix_bwd_wgrad"] = lambda: mix.mix_bwd_kernel(*xargs, *cots,
                                                            wgrad=True)
    device_ms = None
    if args.device_ms:   # this repository's reader, whatever --root is
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        device_ms = smoke.device_ms
    for name, fn in calls.items():
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        dev = ("" if device_ms is None else
               f", device {device_ms(fn, reps=args.reps):.4f} ms")
        print(f"{name}: {start.elapsed_time(end) / args.reps:.4f} ms per "
              f"call{dev} ({A} rows, F = {F}, tree {args.root}) on {smi}",
              flush=True)


if __name__ == "__main__":
    main()
