"""Train the FieldSchNet benchmark potential: FieldSchNet-128x5 on LJ argon.

The FieldSchNet counterpart of ``train_bench_schnet.py``: the same labels
(``train_bench_potential.make_dataset``), loss weights, learning rate,
warm-up and batch pool, on the flat layout, with no external field in the
data (the electric field is zeros, as in MD).  A trained FieldSchNet keeps
the 10,976-atom crystal bound in NVE at 30 K, which random weights do not.

Configuration: ``schnetpack_tpu/configs/model/field_schnet.yaml`` (128
atom basis, 5 interactions, 20 Gaussian RBF, cosine cutoff at 5 A, the
electric field).

Output: scripts/assets/bench_field_schnet_argon.msgpack (flax params).
Run: python scripts/train_bench_field_schnet.py [--steps 1000] [--batch 32]
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
                     "bench_field_schnet_argon.msgpack")


def main(steps: int, batch: int, asset: str = ASSET):
    from schnetpack_tpu.representation import FieldSchNet

    train(steps=steps, batch=batch, asset=asset,
          representation=FieldSchNet(n_atom_basis=128, n_interactions=5,
                                     n_rbf=20, cutoff=CUTOFF))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out", default=ASSET)
    a = ap.parse_args()
    main(a.steps, a.batch, a.out)
