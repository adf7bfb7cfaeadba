"""Time K18 and K19, the 27-cell PaiNN message and its VJP, of one source
tree on the GPU.

Builds the kernels of the tree at ``--root`` (the options and set-up that
the timing scripts share: ``kernel_timing.py``) and times K18, K19 and
K19's wgrad instance at the painn_cell run's shapes (``chip_smoke.py``
phase 3, ``cell_kernel_phase``: the 10,976-atom argon box in the 27-cell
layout the port's neighbor list builds, F = 128, B = 20, the basis and
directions of the box's own geometry, the trained PaiNN's first filter
weights, random features and cotangents from ``--seed``).  ``--tol``
prints the worst miss of the float64 twin, as a share of the tolerance, of
K18's dq and dmu and K19's dxmu, grbf and gdir (elementwise,
``chip_smoke.RTOL``/``ATOL``) and of the wgrad instance's gFW (normwise,
``chip_smoke.NORM_RTOL``), beside the f32 twin's own.  ``--md STEPS``
also runs ``chip_smoke.py``'s NVE phase of painn_cell (``md_phase``:
warm-up, retighten, STEPS timed steps, drift and launch checks) on the
tree, and of each ``--md-path`` given (another path of ``chip_smoke.
PATHS``, or painn_slab), and prints their ms/step.  Prints ptxas's
registers, stack frame and spills of the message kernels where it built
them, then one line per kernel, and the card.  Run from the repository
root on a GPU:

    python3 scripts/time_cell_message_kernels.py [--root DIR] \
        [--device-ms] [--tol] [--md STEPS [--md-path full ...]]
"""
from kernel_timing import md, open_tree, parser, times

#: the sources K18/K19 may live in, over the trees an A/B compares
SOURCES = {"colblock_message.cu": None, "colblock_message_bwd.cu": None,
           "painn_fused.cu": None}


def main():
    ap = parser(md_help="also the painn_cell NVE run of STEPS steps")
    ap.add_argument("--tol", action="store_true",
                    help="the worst miss of the float64 twin")
    ap.add_argument("--md-path", action="append", default=[],
                    help="another MD path of chip_smoke.py to run")
    args = ap.parse_args()
    torch, smoke, smi = open_tree(args, "time_cell_message_kernels",
                                  SOURCES)
    root = args.root
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.atomistic.distances import cell_refs
    from schnetpack_tpu_torch.md import load_molecules
    from schnetpack_tpu_torch.ops import painn_fused as pf

    dev = torch.device("cuda")
    pos, cell = smoke.fcc_box(10_000)
    system = load_molecules([smoke.molecule(pos, cell)], device=dev)
    calc = smoke.calculator(*smoke.potential("painn_cell"), layout="atom")
    inputs = calc.model_inputs(system, calc.init_state(system))
    refs = cell_refs(inputs)
    rep = calc.model.representation
    with torch.no_grad():
        rbf, dirs = rep._cell_geometry(calc.model.input_modules[0](inputs))
    F, Ap = rep.n_atom_basis, inputs[P.R].shape[0]
    g = torch.Generator().manual_seed(args.seed + 30)

    def rnd(*shape, scale=0.3):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    margs = (rnd(Ap, 6 * F), rbf.contiguous(), dirs.contiguous(),
             rep.FW_aug[0].contiguous(), refs)
    cots = (rnd(Ap, F, scale=1.0), rnd(Ap, 3 * F, scale=1.0))
    calls = {
        "cell_msg_fwd": (lambda: pf.cell_msg_fwd_kernel(*margs),
                         lambda: pf.cell_msg_fwd_plain(*margs)),
        "cell_msg_bwd": (lambda: pf.cell_msg_bwd_kernel(*margs, *cots),
                         lambda: pf.cell_msg_bwd_plain(*margs, *cots)[:3]),
        "cell_msg_bwd_wgrad": (
            lambda: pf.cell_msg_bwd_kernel(*margs, *cots, wgrad=True),
            lambda: pf.cell_msg_bwd_plain(*margs, *cots)),
    }
    slots = int((refs.qidx >= 0).sum())
    for name, (fn, plain) in calls.items():
        n_out = 2 if name == "cell_msg_fwd" else 3
        err = max(float((a - b).abs().max())
                  for a, b in zip(fn()[:n_out], plain()[:n_out]))
        print(f"{name}: {times(smoke, fn, args)}, max |kernel - twin| "
              f"{err:.3g} ({slots} real slots, A' = {Ap}, layout "
              f"{tuple(refs.dims)}, F = {F}, tree {root}) on {smi}",
              flush=True)
    if args.tol:
        tolerance_shares(pf, smoke, margs, cots, calls, root)
    if args.md:
        md(smoke, ["painn_cell", *args.md_path], pos, cell, args, dev, smi)


def tolerance_shares(pf, smoke, margs, cots, calls, root):
    """max |x - twin64| / (ATOL + RTOL |twin64|) of K18's and K19's
    outputs, and ||x - twin64|| / (NORM_RTOL ||twin64||) of gFW, for the
    kernels and the f32 twins."""
    want = {"fwd": smoke.in_f64(pf.cell_msg_fwd_plain, *margs),
            "bwd": smoke.in_f64(pf.cell_msg_bwd_plain, *margs, *cots)}
    have = {"kernels": (calls["cell_msg_fwd"][0](),
                        calls["cell_msg_bwd_wgrad"][0]()),
            "f32 twins": (pf.cell_msg_fwd_plain(*margs),
                          pf.cell_msg_bwd_plain(*margs, *cots))}
    names = {"fwd": ("dq", "dmu"), "bwd": ("dxmu", "grbf", "gdir", "gFW")}
    for who, outs in have.items():
        shares = []
        for part, out in zip(("fwd", "bwd"), outs):
            for i, (x, w) in enumerate(zip(out, want[part])):
                x, w = x.double(), w.double()
                if names[part][i] == "gFW":
                    s = (x - w).norm() / (smoke.NORM_RTOL * w.norm())
                else:
                    s = ((x - w).abs()
                         / (smoke.ATOL + smoke.RTOL * w.abs())).max()
                shares.append(f"{names[part][i]} {float(s):.3f}")
        print(f"tolerance share of the float64 twin, {who}: "
              f"{', '.join(shares)} (tree {root})", flush=True)


if __name__ == "__main__":
    main()
