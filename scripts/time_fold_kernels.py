"""Time the row sums and the copies of the column and 27-cell layouts --
K14, the per-destination fold, and K12 its source-order twin, K11 and K13,
K16 and K17, the 27-cell gather and its VJP -- and K8, SchNet's geometry
VJP (with K5, the geometry both read), of one source tree on the GPU.

Builds the kernels of the tree at ``--root`` (the options and set-up
that the timing scripts share: ``kernel_timing.py``) and times them at
the MD runs' shapes (``chip_smoke.py`` phase 3: the 10,976-atom argon
box in the layout the port's neighbor list builds): K14 on the SO3net
run's layout at SO3net's D = 9 x 64 and the positions' D = 3; K11-K14 at
D = 3 on the column layout that PaiNN trbf (and every column path) runs
on; K11 and K12 at D = 3 on the painn_slab layout's halo'd tables, in
the halo_x mode its step runs and in the halo_xy mode; K16 and K17 at
D = 3 on the painn_cell run's 27-cell layout (10, 10, 10, 16, 18); K8 and
K5 (raw-phi and PaiNN's phi*fcut form with d) on the SchNet run's layout
with B = 20; random tables, edge values and cotangents from ``--seed``.
The warm-up call builds the orders that the tree caches on the refs (in
the MD step K9 and K10 build them for K8, and SO3net's first fold for
the next).  Each line gives the kernel's bound as ``chip_smoke.py``
counts it and its largest difference from the plain twin, and for the
narrow row sums the distinct 32-byte sectors that their warps read (a
count of the tree's slot orders).  ``colblock.destination_order``, the
order K14 runs on (SO3net's step builds it once for its folds), is timed
too, on refs with an empty cache.  Prints ptxas's registers, stack frame
and spills of the kernels of ``colblock_geo.cu`` and
``colblock_select.cu`` (and a parent's ``cellblock_gather.cu``) where it
built them, then one line per kernel, and the card.  ``--set
NAME=VALUE`` times a copy of the tree with a constant of
``colblock_select.cu`` changed (``kRowLanes=8``: the narrow row sums'
group).  ``--md STEPS`` also runs ``chip_smoke.py``'s NVE phase
(``md_phase``: its gates and launch counts included) of SchNet and
SO3net, the paths K8 and K14 run on, with the tree's package, and prints
their ms/step.  Run from the repository root on a GPU:

    python3 scripts/time_fold_kernels.py [--root DIR] [--device-ms] \
        [--reps 20] [--seed 0] [--set kRowLanes=8] [--md STEPS]
"""
import dataclasses

from kernel_timing import md, open_tree, parser, times

#: template parameters of the kernels whose ptxas lines are printed
PTXAS = {"colblock_geo.cu": {},
         "colblock_select.cu": {"select_kernel": ("kMode", "V"),
                                "select_narrow_kernel": ("kMode", "kD"),
                                "row_sum_kernel": ("V",),
                                "row_sum_narrow_kernel": ("kD",)},
         "cellblock_gather.cu": {"cell_gather_kernel": ("V",),
                                 "cell_gather_bwd_kernel": ("V",)}}


def main():
    args = parser(set_source="colblock_select.cu",
                  md_help="also the SchNet and SO3net NVE runs, "
                  "ms/step").parse_args()
    torch, smoke, smi = open_tree(args, "time_fold_kernels", PTXAS,
                                  "colblock_select.cu")
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.atomistic.distances import (
        cell_refs, column_refs,
    )
    from schnetpack_tpu_torch.md import load_molecules
    from schnetpack_tpu_torch.ops import cellblock_gather as cg
    from schnetpack_tpu_torch.ops import colblock as cb
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op
    from schnetpack_tpu_torch.ops import colblock_select as sel
    from schnetpack_tpu_torch.ops.colblock_shard import (
        COLS_AXIS, COLS_AXIS_Y,
    )

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

    def warp_sectors(order_of, refs):
        """The 32-byte sectors of D = 3 values that the narrow row sums'
        warps read (32 / ``ROW_LANES`` rows a warp), each warp's distinct
        sectors counted once, from the order ``order_of(refs)``: a count
        of the tree's schedule, not a device measurement; empty for a tree
        without the narrow row sums."""
        lanes = getattr(sel, "ROW_LANES", None)
        if lanes is None:
            return ""
        order, cnt, _ = order_of(refs)
        rows = torch.arange(len(cnt), device=cnt.device)
        warp = torch.repeat_interleave(rows // (32 // lanes), cnt.long())
        sector = order[:len(warp)].long() * 3 * 4 // 32
        n = torch.unique(warp * (int(sector.max()) + 1) + sector).numel()
        return f", {n} sectors over warps of {32 // lanes} rows"

    def select_d3(tag, refs, table, edges, rows, note, copies=True):
        """K11 and K12 (and, with ``copies``, K13 and K14) at D = 3 on
        ``refs``: the copies' bytes are the table and the index whole and
        the output, the sums' the real slots' values and the index."""
        ne = smoke.real_edges(refs)
        report(f"gather_fwd D=3 {tag}",
               lambda: (sel.gather_fwd_kernel(table, refs),),
               lambda: (sel.gather_fwd_plain(table, refs),),
               (table, refs.qcol), 0, note)
        report(f"gather_bwd D=3 {tag}",
               lambda: (sel.gather_bwd_kernel(edges, refs),),
               lambda: (sel.gather_bwd_plain(edges, refs),),
               (4 * ne * 3, refs.qcol), ne * 3,
               note + warp_sectors(cb.source_order, refs))
        if copies:
            report(f"expand_fwd D=3 {tag}",
                   lambda: (sel.expand_fwd_kernel(rows, refs),),
                   lambda: (sel.expand_fwd_plain(rows, refs),),
                   (rows, refs.dcol), 0, note)
            report(f"fold_fwd D=3 {tag}",
                   lambda: (sel.fold_fwd_kernel(edges, refs),),
                   lambda: (sel.fold_fwd_plain(edges, refs),),
                   (4 * ne * 3, refs.dcol), ne * 3,
                   note + warp_sectors(cb.destination_order, refs))

    # K11-K14 at D = 3 on the column layout of PaiNN trbf's run
    calc = smoke.calculator(*smoke.potential("painn_trbf"))
    R, _, refs = smoke.run_inputs(calc, system)
    nx, ny, Ktot = refs.qcol.shape
    select_d3("trbf", refs, R, rnd(nx, ny, Ktot, 3), R,
              f"{smoke.real_edges(refs)} real slots of {nx * ny * Ktot}, "
              f"A' = {R.shape[0]}")

    # K11/K12 at D = 3 on the painn_slab layout's halo'd tables
    sim = smoke.slab_simulator(pos, cell, dev)
    _, inputs = smoke.slab_inputs(sim, pos, dev)
    refs0 = column_refs(inputs)
    nx, ny, Ktot = refs0.qcol.shape
    for mode, axis in (("halo_x", COLS_AXIS),
                       ("halo_xy", (COLS_AXIS, COLS_AXIS_Y))):
        refs = dataclasses.replace(refs0, shard_axis=axis, cache={})
        select_d3(f"slab {mode}", refs, rnd(refs.src_rows, 3),
                  rnd(nx, ny, Ktot, 3), None,
                  f"{smoke.real_edges(refs)} real slots of "
                  f"{nx * ny * Ktot}, {refs.src_rows} halo'd rows",
                  copies=False)
    del sim

    # K16/K17 at D = 3 on the painn_cell run's 27-cell layout
    calc = smoke.calculator(*smoke.potential("painn_cell"), layout="atom")
    inputs = calc.model_inputs(system, calc.init_state(system))
    R = inputs[P.R].contiguous()
    refs = cell_refs(inputs)
    Ap, K = R.shape[0], refs.dims[4]
    ne = int((refs.qidx >= 0).sum())
    g3 = rnd(Ap, K, 3)
    note = f"{ne} real slots of {refs.qidx.numel()}, dims {refs.dims}"
    report("cell_gather_fwd D=3",
           lambda: (cg.cell_gather_fwd_kernel(R, refs),),
           lambda: (cg.cell_gather_plain(R, refs),), (R, refs.qidx), 0,
           note)
    report("cell_gather_bwd D=3",
           lambda: (cg.cell_gather_bwd_kernel(g3, refs),),
           lambda: (cg.cell_gather_bwd_plain(g3, refs),),
           (4 * ne * 3, refs.qidx), ne * 3,
           note + warp_sectors(cg.source_order, refs))

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
