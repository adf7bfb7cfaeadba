"""Train the SchNet benchmark potential: SchNet-128x3 on Lennard-Jones argon.

The SchNet counterpart of ``train_bench_potential.py`` (which trains the
PaiNN): the same labels (smooth-cutoff LJ argon on jittered, strained
108-atom FCC supercells, made by that script's ``make_dataset``), the
same loss weights, learning rate, warm-up and batch pool.  A trained
SchNet keeps the 10,976-atom crystal bound in NVE at 30 K, which random
weights do not (see ``train_bench_potential.py``).

Configuration: ``schnetpack_tpu/configs/model/schnet.yaml`` (128 atom
basis, 3 interactions, 20 Gaussian RBF, cosine cutoff at 5 A).

Output: scripts/assets/bench_schnet_argon.msgpack (flax params pytree).
Run: python scripts/train_bench_schnet.py [--steps 4000]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

from train_bench_potential import CUTOFF, make_dataset  # noqa: E402

ASSET = os.path.join(os.path.dirname(__file__), "assets",
                     "bench_schnet_argon.msgpack")


def main(n_train: int = 512, n_val: int = 64, steps: int = 4000,
         batch: int = 32, representation=None, asset: str = ASSET):
    """Train ``representation`` (default: SchNet-128x3) with an
    ``Atomwise`` energy head and ``Forces``; save the params to ``asset``."""
    import jax
    import jax.numpy as jnp

    from schnetpack_tpu import properties as P
    from schnetpack_tpu.atomistic import Atomwise, Forces, PairwiseDistances
    from schnetpack_tpu.data.loader import PaddingSpec, collate, round_up
    from schnetpack_tpu.model import NeuralNetworkPotential
    from schnetpack_tpu.representation import SchNet
    from schnetpack_tpu.train import AtomisticTask, ModelOutput
    from schnetpack_tpu.train.callbacks import save_pytree

    t_all = time.time()
    data = make_dataset(n_train + n_val, seed=11)
    train, val = data[:n_train], data[n_train:]
    max_pairs = max(len(s[P.idx_i]) for s in data)
    n_at = len(data[0][P.Z])
    spec = PaddingSpec(
        n_atoms=round_up(batch * n_at + 1, 16),
        n_pairs=round_up(int(batch * max_pairs * 1.02), 128),
        n_molecules=batch + 1,
    )
    print(f"dataset in {time.time() - t_all:.0f}s; padding {spec}",
          flush=True)

    if representation is None:
        representation = SchNet(n_atom_basis=128, n_interactions=3, n_rbf=20,
                                cutoff=CUTOFF)
    pot = NeuralNetworkPotential(
        representation=representation,
        input_modules=[PairwiseDistances()],
        output_modules=[Atomwise(output_key=P.energy), Forces()],
    )
    task = AtomisticTask(
        pot,
        outputs=[
            ModelOutput(P.energy, loss_fn="mse", loss_weight=0.01),
            ModelOutput(P.forces, loss_fn="mse", loss_weight=0.99),
        ],
        learning_rate=5e-4,
        warmup_steps=200,
    )
    rng = np.random.RandomState(0)
    pool = []
    for _ in range(96):
        idx = rng.choice(n_train, batch, replace=False)
        pool.append({k: jnp.asarray(v) for k, v in
                     collate([train[i] for i in idx], spec).items()})
    state = task.create_state(jax.random.PRNGKey(0), pool[0])
    step_fn = jax.jit(task._train_step_impl, donate_argnums=0)

    t0 = time.time()
    for it in range(steps):
        state, metrics = step_fn(state, pool[it % len(pool)])
        if (it + 1) % 100 == 0:
            loss = float(jax.device_get(metrics["train_loss"][0]))
            print(f"step {it + 1}/{steps} loss {loss:.6f} "
                  f"({(time.time() - t0) / (it + 1) * 1e3:.0f} ms/step)",
                  flush=True)

    params = jax.device_get(state.ema_params
                            if state.ema_params is not None else state.params)
    apply = jax.jit(lambda p, b: pot.apply(p, b))
    maes, emaes = [], []
    for i in range(0, n_val, batch):
        chunk = val[i:i + batch]
        b = {k: jnp.asarray(v) for k, v in collate(chunk, spec).items()}
        out = apply(params, b)
        f_pred = np.asarray(jax.device_get(out[P.forces]))
        e_pred = np.asarray(jax.device_get(out[P.energy]))
        a0 = 0
        for m, s in enumerate(chunk):
            na = len(s[P.Z])
            maes.append(np.abs(f_pred[a0:a0 + na] - s[P.forces]).mean())
            emaes.append(abs(e_pred[m] - s[P.energy][0]) / na)
            a0 += na
    print(f"{steps} steps in {time.time() - t0:.0f}s "
          f"(total {time.time() - t_all:.0f}s)", flush=True)
    print(f"val force MAE {np.mean(maes) * 1e3:.2f} meV/A; "
          f"energy MAE {np.mean(emaes) * 1e3:.3f} meV/atom", flush=True)

    os.makedirs(os.path.dirname(asset), exist_ok=True)
    save_pytree(asset, params)
    print(f"saved {asset}", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4000)
    main(steps=ap.parse_args().steps)
