"""Write the JAX references of the port's widths that the card's tuned
kernels do not take (``chip_smoke.py`` phase 17).

Runs the JAX package on the CPU, in f32 with its XLA oracles (the flat
pair-list layout, ``IMPL="xla"``), on the jittered 10,976-atom bench box
of ``make_port_reference.py`` (5 A cosine cutoff), with parameters from the
JAX models' own init at PRNGKey(SEED), and saves positions, cell, energy,
forces and the parameter tree (flattened: ``param.<path>`` arrays, the
path's keys joined by dots) to ``tests/data/``:

* ``port_ref_painn_w30_argon.npz``: PaiNN-30x3, 20 Gaussians (SchNetPack 2's
  tutorials' width);
* ``port_ref_schnet_w30_argon.npz``: SchNet-30x3, 20 Gaussians;
* ``port_ref_schnet_b300_argon.npz``: SchNet-64x3 with 300 Gaussians (the
  SchNet paper's basis, on the bench box's 5 A cutoff).

Run from the repository root (a few minutes and a few GB of memory):

    JAX_PLATFORMS=cpu python scripts/make_port_reference_widths.py
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from make_port_reference import CUTOFF, SEED  # noqa: E402
from make_port_reference_schnet import write_reference  # noqa: E402

#: file name -> (model, n_atom_basis, n_rbf)
MODELS = {
    "port_ref_painn_w30_argon.npz": ("painn", 30, 20),
    "port_ref_schnet_w30_argon.npz": ("schnet", 30, 20),
    "port_ref_schnet_b300_argon.npz": ("schnet", 64, 300),
}


def flatten(tree, prefix="param"):
    """{"param.<k1>.<k2>...": array} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def representation(model: str, F: int, B: int):
    from schnetpack_tpu.representation import PaiNN, SchNet

    cls = PaiNN if model == "painn" else SchNet
    return cls(n_atom_basis=F, n_interactions=3, n_rbf=B, cutoff=CUTOFF)


def init_params(rep):
    """The potential's params from its own init at PRNGKey(SEED), on a
    small probe box (the shapes do not depend on the atoms)."""
    import jax

    from bench import fcc_box
    from schnetpack_tpu import properties as P
    from schnetpack_tpu.atomistic import Atomwise, Forces, PairwiseDistances
    from schnetpack_tpu.data.loader import collate, padding_for
    from schnetpack_tpu.model import NeuralNetworkPotential
    from schnetpack_tpu.transform.neighborlist import NeighborListTransform

    pos, cell = fcc_box(100)
    sample = NeighborListTransform(CUTOFF)({
        P.Z: np.full(len(pos), 18, np.int64), P.R: pos.astype(np.float64),
        P.cell: cell, P.pbc: np.ones(3, bool)})
    batch = collate([sample], padding_for([sample]))
    pot = NeuralNetworkPotential(
        representation=rep, input_modules=[PairwiseDistances()],
        output_modules=[Atomwise(output_key=P.energy), Forces()])
    tree = pot.init(jax.random.PRNGKey(SEED), batch)
    return jax.tree.map(np.asarray, dict(tree))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name, (model, F, B) in MODELS.items():
        params = init_params(representation(model, F, B))
        write_reference(representation(model, F, B), params,
                        os.path.join(ROOT, "tests", "data", name),
                        n_atom_basis=np.int64(F), n_rbf=np.int64(B),
                        **flatten(params))


if __name__ == "__main__":
    main()
