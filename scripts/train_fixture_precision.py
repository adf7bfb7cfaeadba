"""How far the f32 train-step gradients sit from float64 ones, for the JAX
package and the port, on ``make_port_reference_train.py``'s case (the
reason that fixture is made in float64).

Computes, on the CPU, the gradient of the first loss of PaiNN-128x3 (the
bench asset) on ``bench.py::train_bench``'s batch with the JAX package in
f32 and in float64, and with the port (``chip_smoke.train_task_and_batch``,
flat layout) in f32 and in float64, and prints the three worst leaves of
each f32 gradient against its package's float64 one and against the
fixture, by ``chip_smoke.py``'s per-leaf rule (||g - w|| / ||w||, a leaf
under 1e-3 of the largest norm against 1e-3 of that norm).  Run from the
repository root (a few minutes, a few GB of memory):

    JAX_PLATFORMS=cpu python scripts/train_fixture_precision.py
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def _flat(tree, prefix="grad"):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float64)
    return out


def _worst(got, want, n=3):
    norms = {k: np.linalg.norm(want[k]) for k in want}
    floor = 1e-3 * max(norms.values())
    errs = {k: np.linalg.norm(got[k] - want[k]) / max(norms[k], floor)
            for k in want}
    return ", ".join(f"{k.split('/', 2)[-1]} {errs[k]:.3e}"
                     for k in sorted(errs, key=errs.get)[-n:])


def jax_grads(x64):
    import jax

    jax.config.update("jax_enable_x64", x64)
    from make_port_reference_train import CUTOFF, bench_samples
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
    dtype = np.float64 if x64 else np.float32
    samples = bench_samples(NeighborListTransform(CUTOFF))
    batch = collate(samples, padding_for(samples), float_dtype=dtype)
    pot = NeuralNetworkPotential(
        representation=PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
                             cutoff=CUTOFF),
        input_modules=[PairwiseDistances()],
        output_modules=[Atomwise(output_key=P.energy), Forces()])
    task = AtomisticTask(pot, outputs=[
        ModelOutput(P.energy, loss_weight=0.01),
        ModelOutput(P.forces, loss_weight=0.99)], learning_rate=1e-4)
    params = jax.tree.map(lambda a: np.asarray(a, dtype), load_pytree(
        os.path.join(ROOT, "scripts", "assets", "bench_painn_argon.msgpack")))
    _, grads = jax.jit(jax.value_and_grad(
        task.loss_and_outputs, has_aux=True))(params, batch)
    return _flat(jax.device_get(grads))


def port_grads(dtype):
    import torch

    import chip_smoke
    from schnetpack_tpu_torch.convert import params_to_jax
    from schnetpack_tpu_torch.train import as_tensors

    task, batch = chip_smoke.train_task_and_batch("flat", "cpu")
    task.model.to(dtype)
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in as_tensors(batch, "cpu").items()}
    _, _, grads = task.gradients(task.create_state(), batch)
    return _flat(params_to_jax(task.model, grads))


def main():
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    j32 = jax_grads(False)
    j64 = jax_grads(True)
    p32 = port_grads(torch.float32)
    p64 = port_grads(torch.float64)
    ref = np.load(os.path.join(ROOT, "tests", "data",
                               "port_ref_painn_train.npz"))
    fixture = {k: ref[k] for k in ref.files if k.startswith("grad/")}
    print(f"JAX f32 vs JAX float64: {_worst(j32, j64)}")
    print(f"port f32 vs port float64: {_worst(p32, p64)}")
    print(f"port f32 vs the fixture: {_worst(p32, fixture)}")
    print(f"JAX f32 vs the fixture: {_worst(j32, fixture)}")


if __name__ == "__main__":
    main()
