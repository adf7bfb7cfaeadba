"""Train the SO3net benchmark potential: SO3net-64x3 (lmax 2) on LJ argon.

The SO3net counterpart of ``train_bench_schnet.py``: the same labels
(``train_bench_potential.make_dataset``), loss weights, learning rate,
warm-up and batch pool, on the flat layout.  A trained SO3net keeps the
10,976-atom crystal bound in NVE at 30 K, which random weights do not.

Configuration: ``schnetpack_tpu/configs/model/so3net.yaml`` (64 atom
basis, 3 interactions, lmax 2, 20 Gaussian RBF, cosine cutoff at 5 A).

Output: scripts/assets/bench_so3net_argon.msgpack (flax params pytree).
Run: python scripts/train_bench_so3net.py [--steps 600] [--batch 32]
(the asset: 600 steps of batch 32, about 80 minutes on 8 CPU cores)
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

from train_bench_potential import CUTOFF  # noqa: E402
from train_bench_schnet import main as train  # noqa: E402

ASSET = os.path.join(os.path.dirname(__file__), "assets",
                     "bench_so3net_argon.msgpack")


def main(steps: int, batch: int, asset: str = ASSET):
    from schnetpack_tpu.representation import SO3net

    train(steps=steps, batch=batch, asset=asset,
          representation=SO3net(n_atom_basis=64, n_interactions=3, lmax=2,
                                n_rbf=20, cutoff=CUTOFF))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out", default=ASSET)
    a = ap.parse_args()
    main(a.steps, a.batch, a.out)
