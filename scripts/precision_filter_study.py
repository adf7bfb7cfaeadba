"""Where the bf16 feature mode's force error comes from.

The JAX package's bf16 mode runs the PaiNN message's filter products at
``Precision.DEFAULT``: the forward filter rbf_aug @ FW_aug and its two
cotangent products grbf = gW FW_aug^T and gFW = rbf_aug^T gW.  This script
evaluates the port's twins (``ops/colblock_message.py``, plain PyTorch on
the CPU) at ``precision="bf16"`` with bf16 operands in the forward filter,
in the backward products, in both and in neither, and prints each one's
force error against f32:

* the trained PaiNN-128x3 (``scripts/assets/bench_painn_argon.msgpack``)
  on the box of ``tests/data/port_ref_painn_argon.npz``, against that JAX
  f32 fixture;
* the JAX package's precision study's case (``scripts/precision_study.py``:
  random-init PaiNN-128x3 from ``PRNGKey(0)``, the bench box with a
  normal 0.15 A jitter from ``RandomState(7)``), against the port's f32.

The port keeps the forward filter in f32 (``ops/precision.py``).  Run from
the repository root (a few minutes on 8 CPU threads, ~10 GB):

    JAX_PLATFORMS=cpu python scripts/precision_filter_study.py
"""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {"neither": (False, False), "forward": (True, False),
            "backward": (False, True), "both": (True, True)}


def set_variant(fwd: bool, bwd: bool) -> None:
    """bf16 operands in the forward filter (``fwd``) and in its cotangent
    products (``bwd``) of the twins' bf16 mode."""
    from schnetpack_tpu_torch.ops import precision as prec

    def forward(ctx, rbf_aug, FW_aug):
        rb, fw = prec._bf16(rbf_aug), prec._bf16(FW_aug)
        ctx.save_for_backward(*((rb, fw) if bwd else (rbf_aug, FW_aug)))
        return rb @ fw if fwd else rbf_aug @ FW_aug

    def backward(ctx, g):
        rb, fw = ctx.saved_tensors
        g = prec._bf16(g) if bwd else g
        return g @ fw.transpose(-1, -2), None

    prec._FilterBf16.forward = staticmethod(forward)
    prec._FilterBf16.backward = staticmethod(backward)


def forces(params, R, cell, precision):
    import chip_smoke as cs
    from schnetpack_tpu_torch.md import load_molecules

    calc = cs.calculator(cs.potential("full")[0], params, precision=precision)
    system = load_molecules([cs.molecule(R, cell)], device="cpu")
    out = calc.calculate(system, calc.init_state(system))
    return (out.forces[0] / calc.force_conversion).numpy()


def report(name, F, F_ref):
    d = np.abs(F - F_ref)
    print(f"{name}: max |dF| / max |F| {d.max() / np.abs(F_ref).max():.3e}, "
          f"rms {np.sqrt((d ** 2).mean() / (F_ref ** 2).mean()):.3e}",
          flush=True)


def study_case():
    """The JAX precision study's positions and random-init parameters."""
    import jax

    from bench import fcc_box
    from schnetpack_tpu import properties as P
    from schnetpack_tpu.atomistic import Atomwise, Forces, PairwiseDistances
    from schnetpack_tpu.data.loader import PaddingSpec, collate
    from schnetpack_tpu.model import NeuralNetworkPotential
    from schnetpack_tpu.representation import PaiNN
    from schnetpack_tpu.transform.neighborlist import NeighborListTransform
    from schnetpack_tpu_torch.convert import params_from_jax

    jax.config.update("jax_platforms", "cpu")
    pos, cell = fcc_box(10_000)
    pos = pos + np.random.RandomState(7).normal(0.0, 0.15, pos.shape)
    pot = NeuralNetworkPotential(
        representation=PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
                             cutoff=5.0),
        input_modules=[PairwiseDistances()],
        output_modules=[Atomwise(output_key=P.energy), Forces()])
    probe = NeighborListTransform(5.0)(
        {P.Z: np.full(32, 18), P.R: pos[:32], P.cell: np.zeros((3, 3)),
         P.pbc: np.zeros(3, bool)})
    tree = pot.init(jax.random.PRNGKey(0),
                    collate([probe], PaddingSpec(48, 1024, 2)))
    return params_from_jax(jax.device_get(tree)), pos, cell


def main():
    import chip_smoke as cs

    torch.set_num_threads(8)
    ref = np.load(cs.REFERENCE["full"])
    R, cell = ref["R"].astype(np.float64), ref["cell"]
    _, params = cs.potential("full")
    for name, (fwd, bwd) in VARIANTS.items():
        set_variant(fwd, bwd)
        report(f"trained, fixture box, bf16 operands in {name}",
               forces(params, R, cell, "bf16"), ref["forces"])
    params, R, cell = study_case()
    F32 = forces(params, R, cell, None)
    for name, (fwd, bwd) in VARIANTS.items():
        set_variant(fwd, bwd)
        report(f"study's case, bf16 operands in {name}",
               forces(params, R, cell, "bf16"), F32)


if __name__ == "__main__":
    main()
