"""Write the full-size JAX FieldSchNet reference that the PyTorch port is
held to.

Runs the JAX FieldSchNet-128x5 potential with the trained asset
(``scripts/assets/bench_field_schnet_argon.msgpack``, from
``train_bench_field_schnet.py``) on the CPU, in f32 (the flat pair-list
layout, ``IMPL="xla"``), with no external field (zeros, as in MD), on the
jittered 10,976-atom bench box of ``make_port_reference.py``, and saves
positions, cell, energy, forces and the pair count to
``tests/data/port_ref_field_schnet_argon.npz`` (``make_port_reference_
schnet.write_reference``).  It first evaluates the same box with every
``dipole_inter_t/filter_{field}_1`` kernel zeroed, which removes the
trained dipole-dipole term from the forces, and saves and prints the force
rms of both evaluations and the rms of their difference: how far that
term moves the forces.

``chip_smoke.py`` holds the port's FieldSchNet forces on the card to this
file (force rms <= 1e-4 eV/Ang); ``tests/test_torch_port_field_schnet.py``
checks the file itself.  Run from the repository root (a few minutes,
~10 GB):

    JAX_PLATFORMS=cpu python scripts/make_port_reference_field_schnet.py
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from make_port_reference import CUTOFF  # noqa: E402
from make_port_reference_schnet import write_reference  # noqa: E402

ASSET = os.path.join(ROOT, "scripts", "assets",
                     "bench_field_schnet_argon.msgpack")
OUT = os.path.join(ROOT, "tests", "data", "port_ref_field_schnet_argon.npz")


def without_dipole_filters(tree):
    """A copy of ``tree`` with every dipole interaction's second filter
    kernel (``dipole_inter_t/filter_{field}_1``) zero."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k.startswith("filter_") and k.endswith("_field_1"):
            v = {"linear": dict(v["linear"], kernel=np.zeros_like(
                v["linear"]["kernel"]))}
        out[k] = without_dipole_filters(v)
    return out


def main():
    from schnetpack_tpu.representation import FieldSchNet
    from schnetpack_tpu.train.callbacks import load_pytree

    def model():
        return FieldSchNet(n_atom_basis=128, n_interactions=5, n_rbf=20,
                           cutoff=CUTOFF)

    tree = load_pytree(ASSET)
    write_reference(model(), without_dipole_filters(tree), OUT)
    f0 = np.load(OUT)["forces"].astype(np.float64)
    write_reference(model(), tree, OUT)
    f = np.load(OUT)["forces"].astype(np.float64)
    rms = {"force_rms": np.sqrt(np.mean(f ** 2)),
           "force_rms_without_dipole_filters": np.sqrt(np.mean(f0 ** 2)),
           "force_rms_dipole_term": np.sqrt(np.mean((f - f0) ** 2))}
    with np.load(OUT) as ref:
        arrays = dict(ref)
    np.savez_compressed(OUT, **arrays, **rms)
    print("force rms {force_rms:.6e} eV/Ang; with the dipole filters zeroed "
          "{force_rms_without_dipole_filters:.6e}; rms of the difference "
          "{force_rms_dipole_term:.6e}".format(**rms))


if __name__ == "__main__":
    main()
