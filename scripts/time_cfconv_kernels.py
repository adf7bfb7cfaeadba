"""Time K9 and K10, SchNet's cfconv and its VJP, of one source tree on
the GPU.

Builds the kernels of the tree at ``--root`` (the options and set-up that
the timing scripts share: ``kernel_timing.py``) and times K9, K10 and
K10's wgrad instance at the SchNet MD run's shapes (``chip_smoke.py``
phase 3: the 10,976-atom argon box in the layout the port's neighbor list
builds, F = 128, B = 20, the trained SchNet's first filter network, random
features and cotangent from ``--seed``).  ``--set NAME=VALUE`` changes
a constant of ``csrc/schnet_columns.cu`` (the kernels' tuning constants,
e.g. ``kGroups=4``) in a copy; ``--groups NAME=G`` fixes the row ranges
a column of K9 (``fwd``), K10 (``bwd``) or K10's wgrad instance
(``wgrad``) at G instead of the module's ``FWD_RANGES``, ``BWD_RANGES``
or ``WGRAD_RANGES``.  ``--width F,B`` times the kernels at F filters and B
Gaussians with random filter weights (phase 17's scales) instead, the
general instances at the shapes the tuned ones do not take; ``--atoms
N`` builds the box of about N atoms (phase 17's sweep: 2,000).
``--tol`` prints the worst miss of the float64 twin, as a share of the
tolerance, of K9's output and K10's dh and ggeo (elementwise,
``chip_smoke.RTOL``/``ATOL``) and of the wgrad instance's weight
cotangents (normwise, ``chip_smoke.NORM_RTOL``), beside the f32 twin's
own.  Prints ptxas's registers, stack frame and spills of the
cfconv kernels where it built them, then one line per kernel, and the
card.  Run from the repository root on a GPU:

    python3 scripts/time_cfconv_kernels.py [--root DIR] [--device-ms] \
        [--tol] [--width F,B] [--atoms N] [--groups NAME=G ...] \
        [--set NAME=VALUE ...]
"""
import sys

from kernel_timing import open_tree, parser, times


def main():
    ap = parser(set_source="schnet_columns.cu")
    ap.add_argument("--tol", action="store_true",
                    help="the worst miss of the float64 twin")
    ap.add_argument("--groups", action="append", default=[],
                    metavar="NAME=G",
                    help="row ranges a column of fwd, bwd or wgrad")
    ap.add_argument("--width", default=None, metavar="F,B",
                    help="random filter weights at F filters, B Gaussians")
    ap.add_argument("--atoms", type=int, default=10_000)
    args = ap.parse_args()
    torch, smoke, smi = open_tree(args, "time_cfconv_kernels",
                                  {"schnet_columns.cu": None,
                                   "schnet_columns_gen.cu": None},
                                  "schnet_columns.cu")
    from schnetpack_tpu_torch.md import load_molecules
    from schnetpack_tpu_torch.ops import schnet_columns as cf

    for x in args.groups:
        name, value = x.split("=")
        const = {"fwd": "FWD_RANGES", "bwd": "BWD_RANGES",
                 "wgrad": "WGRAD_RANGES"}.get(name)
        if const not in vars(cf):
            sys.exit(f"time_cfconv_kernels: no ranges {name} in the tree's "
                     "ops/schnet_columns.py")
        setattr(cf, const, int(value))

    dev = torch.device("cuda")
    pos, cell = smoke.fcc_box(args.atoms)
    system = load_molecules([smoke.molecule(pos, cell)], device=dev)
    calc = smoke.calculator(*smoke.potential("schnet"))
    R, coff, refs = smoke.run_inputs(calc, system)
    rep = calc.model.representation
    F, Ap = rep.n_atom_basis, R.shape[0]
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op
    from schnetpack_tpu_torch.ops.radial import gaussian_rbf_table

    g = torch.Generator().manual_seed(args.seed + 10)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    if args.width:
        F, B = map(int, args.width.split(","))
        geo = geo_op.geo_fwd_kernel(
            R, coff, refs, gaussian_rbf_table(B, rep.cutoff, device=dev),
            rep.cutoff, with_d=False, raw_phi=True)
        w = (rnd(B, F, scale=(6.0 / (B + F)) ** 0.5), rnd(F, scale=0.1),
             rnd(F, F, scale=(3.0 / F) ** 0.5), rnd(F, scale=0.1))
    else:
        geo = geo_op.geo_fwd_kernel(R, coff, refs, rep.cw, rep.cutoff,
                                    with_d=False, raw_phi=True)
        i0 = rep.interactions[0]
        w = (i0.filter_0.weight.t().contiguous(), i0.filter_0.bias,
             i0.filter_1.weight.t().contiguous(), i0.filter_1.bias)
    cargs = (rnd(Ap, F, scale=0.3), geo, *w, refs)
    g_out = rnd(Ap, F)
    calls = {"cf_fwd": lambda: (cf.cf_fwd_kernel(*cargs),),
             "cf_bwd": lambda: cf.cf_bwd_kernel(*cargs, g_out),
             "cf_bwd_wgrad": lambda: cf.cf_bwd_kernel(*cargs, g_out,
                                                      wgrad=True)}
    plain = {"cf_fwd": lambda: (cf.cf_fwd_plain(*cargs),),
             "cf_bwd": lambda: cf.cf_bwd_plain(*cargs, g_out)[:2]}
    slots = int((refs.qcol >= 0).sum())
    B = geo.shape[2] - 4
    for name, fn in calls.items():
        out = fn()
        err = max(float((a - b).abs().max()) for a, b in zip(
            out, plain[name.replace("_wgrad", "")]()))
        inst = name if cf.tuned_width(F, B) else name + " (general)"
        print(f"{inst}: {times(smoke, fn, args)}, max |kernel - twin| "
              f"{err:.3g} ({slots} slots, A' = {Ap}, F = {F}, B = {B}, "
              f"tree {args.root}) on {smi}", flush=True)
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


if __name__ == "__main__":
    main()
