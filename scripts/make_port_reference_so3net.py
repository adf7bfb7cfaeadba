"""Write the full-size JAX SO3net reference that the PyTorch port is held to.

Runs the JAX SO3net-64x3 (lmax 2) potential with the trained asset
(``scripts/assets/bench_so3net_argon.msgpack``, from
``train_bench_so3net.py``) on the CPU, in f32 (the flat pair-list layout,
``IMPL="xla"``), on the same jittered 10,976-atom periodic FCC argon box as
``make_port_reference.py`` (uniform +-JITTER Angstrom, numpy seed SEED),
and saves positions, cell, energy, forces and the pair count to
``tests/data/port_ref_so3net_argon.npz``.

``chip_smoke.py`` holds the port's SO3net forces on the card to this file
(force rms <= 1e-4 eV/Ang); ``tests/test_torch_port_so3net.py`` checks the
file itself.  Run from the repository root (a few minutes, ~10 GB):

    JAX_PLATFORMS=cpu python scripts/make_port_reference_so3net.py
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from make_port_reference import CUTOFF  # noqa: E402
from make_port_reference_schnet import write_reference  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "port_ref_so3net_argon.npz")


def main():
    from schnetpack_tpu.representation import SO3net

    write_reference(
        SO3net(n_atom_basis=64, n_interactions=3, lmax=2, n_rbf=20,
               cutoff=CUTOFF),
        os.path.join(ROOT, "scripts", "assets", "bench_so3net_argon.msgpack"),
        OUT)


if __name__ == "__main__":
    main()
