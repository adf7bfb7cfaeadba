"""Write the full-size JAX SchNet reference that the PyTorch port is held to.

Runs the JAX SchNet-128x3 potential with the trained asset
(``scripts/assets/bench_schnet_argon.msgpack``, from
``train_bench_schnet.py``) on the CPU, in f32 (the flat pair-list layout,
``IMPL="xla"``), on the 10,976-atom periodic FCC argon box of
``bench.py::fcc_box`` jittered as ``make_port_reference.py`` jitters it
(uniform +-JITTER Angstrom, numpy seed SEED), and saves positions, cell,
energy, forces and the pair count to ``tests/data/port_ref_schnet_argon.npz``.

``chip_smoke.py`` holds the port's SchNet forces on the card to this file
(force rms <= 1e-4 eV/Ang); ``tests/test_torch_port_schnet.py`` checks the
file itself.  Run from the repository root (a few minutes, a few GB):

    JAX_PLATFORMS=cpu python scripts/make_port_reference_schnet.py
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from make_port_reference import CUTOFF, JITTER, SEED  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "port_ref_schnet_argon.npz")


def write_reference(representation, asset: str, out_path: str) -> None:
    """Run ``NeuralNetworkPotential(representation)`` with the params in
    ``asset`` on the jittered bench box; save the reference to
    ``out_path``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from bench import fcc_box
    from schnetpack_tpu import properties as P
    from schnetpack_tpu.atomistic import Atomwise, Forces, PairwiseDistances
    from schnetpack_tpu.data.loader import collate, padding_for
    from schnetpack_tpu.model import NeuralNetworkPotential
    from schnetpack_tpu.ops import cellblock
    from schnetpack_tpu.train.callbacks import load_pytree
    from schnetpack_tpu.transform.neighborlist import NeighborListTransform

    cellblock.IMPL = "xla"
    pos, cell = fcc_box(10_000)
    rng = np.random.RandomState(SEED)
    R = (pos + rng.uniform(-JITTER, JITTER, pos.shape)).astype(np.float32)
    sample = NeighborListTransform(CUTOFF)({
        P.Z: np.full(len(R), 18, np.int64), P.R: R.astype(np.float64),
        P.cell: cell, P.pbc: np.ones(3, bool)})
    batch = collate([sample], padding_for([sample]))
    pot = NeuralNetworkPotential(
        representation=representation,
        input_modules=[PairwiseDistances()],
        output_modules=[Atomwise(output_key=P.energy), Forces()])
    params = load_pytree(asset)
    out = jax.jit(pot.apply)(params, batch)
    energy = np.float64(np.asarray(out[P.energy])[0])
    forces = np.asarray(out[P.forces], np.float32)[:len(R)]
    n_pairs = len(sample[P.idx_i])
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez_compressed(out_path, R=R, cell=cell, energy=energy,
                        forces=forces, jitter=np.float64(JITTER),
                        seed=np.int64(SEED), cutoff=np.float64(CUTOFF),
                        n_pairs=np.int64(n_pairs))
    print(f"wrote {out_path}: {len(R)} atoms, E={energy:.6f} eV, "
          f"|F|max={np.abs(forces).max():.4f} eV/Ang, {n_pairs} pairs")


def main():
    from schnetpack_tpu.representation import SchNet

    write_reference(
        SchNet(n_atom_basis=128, n_interactions=3, n_rbf=20, cutoff=CUTOFF),
        os.path.join(ROOT, "scripts", "assets", "bench_schnet_argon.msgpack"),
        OUT)


if __name__ == "__main__":
    main()
