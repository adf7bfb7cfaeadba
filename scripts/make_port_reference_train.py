"""Write the JAX reference of the port's training step.

The case of ``bench.py::train_bench`` (``bench.py:100-128``): 100
aspirin-sized molecules of 21 atoms (Z = C9H8O4, positions ``randn * 1.5``
from ``numpy.random.RandomState(0)``, energy sum(R^2), forces -2R), the
JAX ``NeighborListTransform`` at 5 A and ``collate`` with ``padding_for``
(the flat pair list); PaiNN-128x3 (20 Gaussian basis functions, 5 A cosine
cutoff) with the weights of ``scripts/assets/bench_painn_argon.msgpack``;
an energy (weight 0.01) and force (0.99) MSE loss; AdamW at lr 1e-4 (the
task's defaults otherwise).  Runs the JAX package on the CPU in float64
(``jax_enable_x64``; the asset's weights and the batch cast up,
``IMPL="xla"``): the f32 roundoff of the JAX package's own gradient sums
reaches the order of the port's tolerance on this batch, and a float64
reference holds the port to its own error alone.  Saves

* ``loss`` [4]: the loss before each of four ``train_step``s (the first is
  the loss at the asset's weights);
* ``grad/<flax path>``: the gradient of the first loss with respect to
  every parameter (stored as f32), ``jax.value_and_grad`` of
  ``loss_and_outputs``, under
  the flax tree's names (``params/representation/filter_net/linear/
  kernel``, ...), which ``convert.params_to_jax`` gives the port's;

to ``tests/data/port_ref_painn_train.npz``.  ``chip_smoke.py``'s phase 11
holds the port's step on the card, on the flat and the dense layout, to
this file; ``tests/test_torch_port_train.py`` holds the port's first loss
on the CPU to it.  Run from the repository root (about a minute and a few
GB of memory):

    JAX_PLATFORMS=cpu python scripts/make_port_reference_train.py
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CUTOFF = 5.0
N_MOLECULES, N_ATOMS = 100, 21
STEPS = 4


def bench_samples(neighbor_list):
    """``bench.py:100-112``'s molecules, neighbor-listed."""
    from schnetpack_tpu import properties as P

    rng = np.random.RandomState(0)
    Z = np.array([6] * 9 + [1] * 8 + [8] * 4)
    samples = []
    for _ in range(N_MOLECULES):
        R = rng.randn(N_ATOMS, 3) * 1.5
        samples.append(neighbor_list({
            P.Z: Z, P.R: R, P.cell: np.zeros((3, 3)),
            P.pbc: np.zeros(3, bool),
            P.energy: np.array([float((R ** 2).sum())]),
            P.forces: -2.0 * R}))
    return samples


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from schnetpack_tpu import properties as P
    from schnetpack_tpu.atomistic import Atomwise, Forces, PairwiseDistances
    from schnetpack_tpu.data.loader import collate, padding_for
    from schnetpack_tpu.model import NeuralNetworkPotential
    from schnetpack_tpu.ops import cellblock
    from schnetpack_tpu.representation import PaiNN
    from schnetpack_tpu.train import AtomisticTask, ModelOutput
    from schnetpack_tpu.train.callbacks import load_pytree
    from schnetpack_tpu.transform.neighborlist import NeighborListTransform

    cellblock.IMPL = "xla"
    cellblock.WGRAD = True
    samples = bench_samples(NeighborListTransform(CUTOFF))
    batch = collate(samples, padding_for(samples), float_dtype=np.float64)
    pot = NeuralNetworkPotential(
        representation=PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
                             cutoff=CUTOFF),
        input_modules=[PairwiseDistances()],
        output_modules=[Atomwise(output_key=P.energy), Forces()])
    task = AtomisticTask(pot, outputs=[
        ModelOutput(P.energy, loss_fn="mse", loss_weight=0.01),
        ModelOutput(P.forces, loss_fn="mse", loss_weight=0.99)],
        learning_rate=1e-4)
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), load_pytree(
        os.path.join(ROOT, "scripts", "assets", "bench_painn_argon.msgpack")))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        task.loss_and_outputs, has_aux=True))(params, batch)
    state = task.create_state(jax.random.PRNGKey(0), batch)
    state = state.replace(params=params,
                          opt_state=task.optimizer.init(params))
    losses = []
    for _ in range(STEPS):
        state, m = task.train_step(state, batch)
        losses.append(float(m["train_loss"][0]))
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{path}/{k}" if path else k)
            else:
                # float64 values rounded to f32 (6e-8 relative)
                flat[f"grad/{path}/{k}"] = np.asarray(v, np.float32)
    walk(jax.device_get(grads), "")
    out = os.path.join(ROOT, "tests", "data", "port_ref_painn_train.npz")
    np.savez_compressed(out, loss=np.asarray(losses, np.float64),
                        first_loss=np.float64(loss), cutoff=np.float64(CUTOFF),
                        n_pairs=np.int64(int(batch[P.pair_mask].sum())),
                        **flat)
    dtypes = {str(np.asarray(v).dtype) for v in jax.tree.leaves(grads)}
    print(f"wrote {out}: {int(batch[P.pair_mask].sum())} pairs, losses "
          f"{losses}, {len(flat)} gradient leaves of {dtypes}")


if __name__ == "__main__":
    main()
