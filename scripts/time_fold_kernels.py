"""Time K14, the per-destination fold, and K8, SchNet's geometry VJP (with
K5, the geometry both read), of one source tree on the GPU.

Builds the kernels of the tree at ``--root`` (the options and set-up that
the timing scripts share: ``kernel_timing.py``) and times them at the MD
runs' shapes (``chip_smoke.py`` phase 3: the 10,976-atom argon box in the
layout the port's neighbor list builds): K14 on the SO3net run's layout
at SO3net's D = 9 x 64 and the positions' D = 3, K8 and K5 (raw-phi and
PaiNN's phi*fcut form with d) on the SchNet run's layout with B = 20,
random edge values and cotangents from ``--seed``.  The warm-up call
builds the orders that the tree caches on the refs (in the MD step K9
and K10 build them for K8, and SO3net's first fold for the next).  Each
line gives the kernel's bound as ``chip_smoke.py`` counts it and its
largest difference from the plain twin.  ``colblock.destination_order``,
the order K14 runs on (SO3net's step builds it once for its folds), is
timed too, on refs with an empty cache.  Prints ptxas's registers, stack
frame and spills of the kernels of ``colblock_geo.cu`` and
``colblock_select.cu`` where it built them, then one line per kernel, and
the card.  ``--md STEPS`` also runs ``chip_smoke.py``'s NVE phase
(``md_phase``: its gates and launch counts included) of SchNet and
SO3net, the paths K8 and K14 run on, with the tree's package, and prints
their ms/step.  Run from the repository root on a GPU:

    python3 scripts/time_fold_kernels.py [--root DIR] [--device-ms] \
        [--reps 20] [--seed 0] [--md STEPS]
"""
import dataclasses

from kernel_timing import md, open_tree, parser, times

#: template parameters of the kernels whose ptxas lines are printed
PTXAS = {"colblock_geo.cu": {},
         "colblock_select.cu": {"select_kernel": ("kGather", "V"),
                                "select_narrow_kernel": ("kGather", "kD"),
                                "row_sum_kernel": ("V",),
                                "gather_bwd_kernel": ("V",)}}


def main():
    args = parser(md_help="also the SchNet and SO3net NVE runs, "
                  "ms/step").parse_args()
    torch, smoke, smi = open_tree(args, "time_fold_kernels", PTXAS)
    from schnetpack_tpu_torch.md import load_molecules
    from schnetpack_tpu_torch.ops import colblock as cb
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op
    from schnetpack_tpu_torch.ops import colblock_select as sel

    dev = torch.device("cuda")
    pos, cell = smoke.fcc_box(10_000)
    system = load_molecules([smoke.molecule(pos, cell)], device=dev)
    g = torch.Generator().manual_seed(args.seed + 30)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dev)

    def report(name, fn, plain, inputs, flops, note):
        out = fn()
        err = max(float((a - b).abs().max()) for a, b in zip(out, plain()))
        bound_ms, by = smoke.bound(smoke.nbytes(inputs, out), flops)
        print(f"{name}: {times(smoke, fn, args)}, bound {bound_ms:.4f} ms "
              f"by {by}, max |kernel - twin| {err:.3g} ({note}, tree "
              f"{args.root}) on {smi}", flush=True)

    # K14 on the SO3net run's layout (the op's own inputs and bound, as
    # chip_smoke.py's select phase counts them)
    calc = smoke.calculator(*smoke.potential("so3net"))
    R, _, refs = smoke.run_inputs(calc, system)
    rep = calc.model.representation
    nx, ny, Ktot = refs.qcol.shape
    ne = smoke.real_edges(refs)
    for D in (rep.convs[0].cg_deg.shape[0] * rep.n_atom_basis, 3):
        edges = rnd(nx, ny, Ktot, D)
        report(f"fold_fwd D={D}",
               lambda: (sel.fold_fwd_kernel(edges, refs),),
               lambda: (sel.fold_fwd_plain(edges, refs),),
               (4 * ne * D, refs.dcol), ne * D,
               f"{ne} real slots of {nx * ny * Ktot}, A' = {R.shape[0]}")
        del edges
    print("destination_order (no cache): " + times(
        smoke, lambda: cb.destination_order(
            dataclasses.replace(refs, cache={})), args)
        + f" (tree {args.root}) on {smi}", flush=True)

    # K8 and K5 on the SchNet run's layout
    calc = smoke.calculator(*smoke.potential("schnet"))
    R, coff, refs = smoke.run_inputs(calc, system)
    rep = calc.model.representation
    B = rep.n_rbf
    ne = smoke.real_edges(refs)
    idx = (refs.qcol, refs.dcol)
    gargs = (R, coff, refs, rep.cw, rep.cutoff)
    nx, ny, Ktot = refs.qcol.shape
    ggeo = rnd(nx, ny, B + 4, Ktot)
    note = f"{ne} real slots, A' = {R.shape[0]}, B = {B}"
    report("geo_bwd", lambda: (geo_op.geo_bwd_kernel(ggeo, *gargs),),
           lambda: (geo_op.geo_bwd_plain(ggeo, *gargs),),
           smoke.geo_bwd_bytes(ggeo, coff, refs, R, rep.cw),
           2 * ne * smoke.geo_flops(B), note)
    for raw in (True, False):
        kw = dict(with_d=not raw, raw_phi=raw)
        report(f"geo_fwd{'_raw' if raw else ''}",
               lambda: (geo_op.geo_fwd_kernel(*gargs, **kw),),
               lambda: (geo_op.geo_fwd_plain(*gargs, **kw),),
               (R, coff, idx, rep.cw), ne * smoke.geo_flops(B), note)
    if args.md:
        md(smoke, ("schnet", "so3net"), pos, cell, args, dev, smi)


if __name__ == "__main__":
    main()
