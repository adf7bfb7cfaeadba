"""What the kernel timing scripts share (``time_mixing_kernels.py``,
``time_cfconv_kernels.py``, ``time_cell_message_kernels.py``,
``time_fold_kernels.py``).

Each times some of the port's kernels of one source tree on the GPU:
``--root DIR`` (default: this repository; another checkout, e.g. an
archive of a parent commit unpacked under ``_scratch/``, for an A/B inside
one call) names the tree whose package is imported and built, while the
readers and run set-up (``chip_smoke.py``: the box, the trained models,
the bound, ``cuda_ms`` and ``device_ms``) are this repository's.  A kernel
is timed with CUDA events around ``--reps`` calls after a warm-up, and
with ``--device-ms`` also on the device, its kernels' durations in
``torch.profiler``'s CUDA trace.  ``--set NAME=VALUE`` (where a script
takes it) times a copy of the tree's package, made under ``_scratch/``,
with a constant of one source changed.  ``--md STEPS`` (where a script
takes it) runs ``chip_smoke.py``'s NVE phases of some paths on the tree.
"""
import argparse
import importlib.util
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parser(set_source=None, md_help=None):
    """The options every script takes; ``set_source``: the source whose
    constants ``--set`` changes; ``md_help``: what ``--md`` runs."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device-ms", action="store_true",
                    help="also the device time from torch.profiler")
    if set_source:
        ap.add_argument("--set", action="append", default=[],
                        metavar="NAME=VALUE",
                        help=f"a constant of csrc/{set_source}, in a copy")
    if md_help:
        ap.add_argument("--md", type=int, default=0, metavar="STEPS",
                        help=md_help)
    return ap


def open_tree(args, prog, sources, set_source=None):
    """Import the package of ``args.root`` (a ``--set`` copy of it if
    asked), build its kernels and print ptxas's registers, stack frame
    and spills of the kernels of ``sources`` (file name: template
    parameters, or None for ``chip_smoke.PTXAS_SOURCES``'s) that the
    build compiled.  Returns (torch, this repository's ``chip_smoke``,
    the card's name and power limit); ``args.root`` becomes absolute."""
    if getattr(args, "set", None):
        args.root = variant(args.root, set_source, args.set, prog)
    args.root = os.path.abspath(args.root)
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        sys.exit(f"{prog}: no CUDA device")
    from schnetpack_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _build.build()
    for src, params in sources.items():
        if params is None:
            params = smoke.PTXAS_SOURCES.get(src, {})
        for inst, regs, frame, st, ld in smoke.ptxas_report(
                _build.build_log.get(src, ""), params):
            print(f"ptxas {src}: {inst}: {regs} registers, {frame} bytes "
                  f"stack frame, {st} bytes spill stores, {ld} bytes spill "
                  f"loads (tree {args.root})", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return torch, smoke, smi


def times(smoke, fn, args):
    """``fn``'s time per call, and on the device with ``--device-ms``."""
    ms = smoke.cuda_ms(fn, reps=args.reps)
    on_dev = ("" if not args.device_ms else
              f", device {smoke.device_ms(fn, reps=args.reps):.4f} ms")
    return f"{ms:.4f} ms per call{on_dev}"


def variant(root, src, sets, prog):
    """A copy of ``root``'s package under ``_scratch/`` with the constants
    ``sets`` (NAME=VALUE) of ``csrc/<src>`` replaced."""
    dst = os.path.join(ROOT, "_scratch", src.split(".")[0] + "_" + "_".join(
        x.replace("=", "") for x in sets))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "schnetpack_tpu_torch"),
                    os.path.join(dst, "schnetpack_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(dst, "schnetpack_tpu_torch", "csrc", src)
    with open(path) as f:
        text = f.read()
    for x in sets:
        name, value = x.split("=")
        text, n = re.subn(rf"\b({name} = )\d+", rf"\g<1>{value}", text)
        if n != 1:
            sys.exit(f"{prog}: no constant {name} in {path}")
    with open(path, "w") as f:
        f.write(text)
    return dst


def md(smoke, paths, pos, cell, args, dev, smi):
    """``chip_smoke.py``'s NVE phases of ``paths`` (its gates and launch
    counts included) on the tree's package: their ms/step."""
    from schnetpack_tpu_torch.ops import (
        cellblock_gather, colblock_edge, colblock_geo, colblock_message,
        colblock_select, painn_fused, painn_mixing, schnet_columns,
    )

    launches = tuple(m.LAUNCHES for m in (
        colblock_message, painn_mixing, colblock_geo, schnet_columns,
        colblock_select, cellblock_gather, painn_fused, colblock_edge))
    for path in paths:
        if path == "painn_slab":
            _, ms = smoke.slab_md_phase(pos, cell, args.md, args.seed, dev,
                                        launches)
        else:
            _, ms = smoke.md_phase(path, pos, cell, args.md, args.seed, dev,
                                   launches)
        print(f"md {path}: {ms:.3f} ms/step over {args.md} steps (tree "
              f"{args.root}) on {smi}", flush=True)
