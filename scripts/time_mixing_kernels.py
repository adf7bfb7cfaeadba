"""Time the PaiNN mixing kernels K3/K4 of one source tree on the GPU.

Builds the kernels of the tree at ``--root`` (the options and set-up that
the timing scripts share: ``kernel_timing.py``) and times K3, K4 and,
where the tree has it, K4's wgrad instance at the column layout's 12,800
rows, F = 128, on random inputs from ``--seed`` with the trained PaiNN's
first mixing block.  ``--set NAME=VALUE`` changes a constant of
``csrc/painn_mixing.cu`` (the kernels' tuning constants, e.g.
``kFwdRows=32``) in a copy.  Prints ptxas's registers, stack frame and
spills of the mixing kernels where it built them, then one line per
kernel with its largest difference from the plain twin, and the card.
``--tol`` adds K3's worst miss of its float64 twin as a share of the
mixing tolerance (``tests/torch_port_cases.py``) on the card tests'
random inputs at F = 128 and 256, both activations.  ``--width F``
times the kernels at width F with random weights (phase 17's scales)
instead, the general instances where the tuned ones do not take F.  Run
from the repository root on a GPU:

    python3 scripts/time_mixing_kernels.py [--root DIR] [--rows 12800] \
        [--device-ms] [--tol] [--width F] [--set NAME=VALUE ...]
"""
import inspect
import os
import sys

from kernel_timing import ROOT, open_tree, parser, times


def main():
    ap = parser(set_source="painn_mixing.cu")
    ap.add_argument("--rows", type=int, default=12_800)
    ap.add_argument("--tol", action="store_true",
                    help="K3's worst miss as a share of the tolerance")
    ap.add_argument("--width", type=int, default=None, metavar="F",
                    help="random weights at width F")
    args = ap.parse_args()
    torch, smoke, smi = open_tree(args, "time_mixing_kernels",
                                  {"painn_mixing.cu": None,
                                   "painn_mixing_gen.cu": None},
                                  "painn_mixing.cu")
    from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
    from schnetpack_tpu_torch.ops import painn_mixing as mix

    dev = torch.device("cuda")
    params = params_from_jax(load_jax_params(os.path.join(
        ROOT, "scripts", "assets", "bench_painn_argon.msgpack")))
    w = [params[f"representation.mixing.0.{k}"].to(dev)
         for k in ("kmix", "k0", "b0", "k1", "b1")]
    F, A = w[0].shape[0], args.rows
    g = torch.Generator().manual_seed(args.seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    if args.width:
        F = args.width
        w = [rnd(F, 2 * F, scale=F ** -0.5), rnd(2 * F, F, scale=F ** -0.5),
             rnd(F, scale=0.1), rnd(F, 3 * F, scale=F ** -0.5),
             rnd(3 * F, scale=0.1)]

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
    for name, fn in calls.items():
        out = fn()
        err = ("" if name not in plain else ", max |kernel - twin| %.3g" % max(
            float((a - b).abs().max()) for a, b in zip(out, plain[name]())))
        gen = not mix.tuned_width(F, bwd=name.startswith("mix_bwd"))
        print(f"{name}{' (general)' if gen else ''}: "
              f"{times(smoke, fn, args)}{err} ({A} rows, F = {F}, tree "
              f"{args.root}) on {smi}", flush=True)
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


if __name__ == "__main__":
    main()
