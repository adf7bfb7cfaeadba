"""Write the JAX references of the port's energy parameter gradients.

Runs the JAX PaiNN-128x3 and SchNet-128x3 potentials with the trained
bench assets (``scripts/assets/bench_{painn,schnet}_argon.msgpack``) and
the energy output only on the CPU, in f32 (the flat pair-list layout,
``IMPL="xla"``, ``WGRAD=True``), on the box of ``make_port_reference.py``
(``bench.py::fcc_box`` of 10,976 atoms jittered by a uniform +-JITTER
Angstrom, numpy seed SEED), takes ``jax.value_and_grad`` of the energy with
respect to every parameter, and saves positions, cell, energy and the
gradient tree under the port's parameter names (``convert.params_from_
jax``, keys ``grad/<name>``) to ``tests/data/port_ref_{painn,schnet}_grad_
argon.npz``.

``chip_smoke.py`` holds the port's gradients on the card to these files;
``tests/test_torch_port_wgrad.py`` checks the files themselves.  Run from
the repository root (a few minutes and a few GB of memory):

    JAX_PLATFORMS=cpu python scripts/make_port_reference_grad.py

``--n-atoms`` and ``--out-dir`` write the same references of a smaller box
elsewhere (a rehearsal of the chip script at a small size).
"""
import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from make_port_reference import CUTOFF, JITTER, SEED  # noqa: E402

MODELS = {"painn": "bench_painn_argon.msgpack",
          "schnet": "bench_schnet_argon.msgpack"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-atoms", type=int, default=10_000)
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "tests", "data"))
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from bench import fcc_box
    from schnetpack_tpu import properties as P
    from schnetpack_tpu.atomistic import Atomwise, PairwiseDistances
    from schnetpack_tpu.data.loader import collate, padding_for
    from schnetpack_tpu.model import NeuralNetworkPotential
    from schnetpack_tpu.ops import cellblock
    from schnetpack_tpu.representation import PaiNN, SchNet
    from schnetpack_tpu.train.callbacks import load_pytree
    from schnetpack_tpu.transform.neighborlist import NeighborListTransform
    from schnetpack_tpu_torch.convert import params_from_jax

    cellblock.IMPL = "xla"
    cellblock.WGRAD = True
    pos, cell = fcc_box(args.n_atoms)
    rng = np.random.RandomState(SEED)
    R = (pos + rng.uniform(-JITTER, JITTER, pos.shape)).astype(np.float32)
    sample = NeighborListTransform(CUTOFF)({
        P.Z: np.full(len(R), 18, np.int64), P.R: R.astype(np.float64),
        P.cell: cell, P.pbc: np.ones(3, bool)})
    batch = collate([sample], padding_for([sample]))
    reps = {"painn": PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
                           cutoff=CUTOFF),
            "schnet": SchNet(n_atom_basis=128, n_interactions=3, n_rbf=20,
                             cutoff=CUTOFF)}
    os.makedirs(args.out_dir, exist_ok=True)
    for name, asset in MODELS.items():
        pot = NeuralNetworkPotential(
            representation=reps[name], input_modules=[PairwiseDistances()],
            output_modules=[Atomwise(output_key=P.energy)])
        params = load_pytree(os.path.join(ROOT, "scripts", "assets", asset))

        def energy(p):
            return pot.apply(p, batch)[P.energy][0]

        E, g = jax.jit(jax.value_and_grad(energy))(params)
        grads = params_from_jax(jax.device_get(g))
        out = os.path.join(args.out_dir, f"port_ref_{name}_grad_argon.npz")
        np.savez_compressed(
            out, R=R, cell=cell, energy=np.float64(E),
            jitter=np.float64(JITTER), seed=np.int64(SEED),
            cutoff=np.float64(CUTOFF),
            **{f"grad/{k}": v.numpy() for k, v in grads.items()})
        big = max(grads, key=lambda k: float(grads[k].norm()))
        print(f"wrote {out}: {len(R)} atoms, E={float(E):.6f} eV, "
              f"{len(grads)} leaves, largest |g| {big} "
              f"{float(grads[big].norm()):.4e}")


if __name__ == "__main__":
    main()
