"""Write the full-size JAX references of PaiNN with another radial basis.

Runs the JAX PaiNN-128x3 with the trained bench asset
(``scripts/assets/bench_painn_argon.msgpack``) on the CPU, in f32 (the flat
pair-list layout, ``IMPL="xla"``), on the jittered 10,976-atom box of
``make_port_reference.py``, in two forms that take the port's row-9 path
(the message backward that returns the geometry cotangent):

* ``GaussianRBF(20, 5, trainable=True)`` whose centers and widths are the
  initial ones moved by a uniform +-0.05 Angstrom (centers) and scaled by
  a uniform factor in [0.95, 1.05] (widths), numpy seed RADIAL_SEED: a
  physical potential, since the asset was trained with the initial
  values.  Saved with the centers and widths to
  ``tests/data/port_ref_painn_trbf_argon.npz``; the port loads them with
  ``convert.load_jax_params(asset, radial_from=...)``.
* ``BesselRBF(20, 5)`` with the cosine cutoff, which has no parameters:
  the asset's weights in a model they were not trained for, deterministic,
  to ``tests/data/port_ref_painn_bessel_argon.npz``.

``chip_smoke.py`` holds the port's forces on the card to these files
(force rms <= 1e-4 eV/Ang); ``tests/test_torch_port_radial.py`` checks the
files themselves.  Run from the repository root (about a minute each and a
few GB):

    JAX_PLATFORMS=cpu python scripts/make_port_reference_painn_radial.py
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from make_port_reference import CUTOFF  # noqa: E402
from make_port_reference_schnet import write_reference  # noqa: E402

RADIAL_SEED = 1
N_RBF = 20
ASSET = os.path.join(ROOT, "scripts", "assets", "bench_painn_argon.msgpack")
OUT = {
    "trbf": os.path.join(ROOT, "tests", "data",
                         "port_ref_painn_trbf_argon.npz"),
    "bessel": os.path.join(ROOT, "tests", "data",
                           "port_ref_painn_bessel_argon.npz"),
}


def perturbed_radial(seed: int = RADIAL_SEED):
    """The initial Gaussian centers and widths, moved and scaled."""
    from schnetpack_tpu.ops.radial import gaussian_rbf_params

    centers, widths = gaussian_rbf_params(N_RBF, CUTOFF)
    rng = np.random.RandomState(seed)
    centers = centers + rng.uniform(-0.05, 0.05, N_RBF)
    widths = widths * rng.uniform(0.95, 1.05, N_RBF)
    return centers.astype(np.float32), widths.astype(np.float32)


def main():
    from schnetpack_tpu.nn.radial import BesselRBF, GaussianRBF
    from schnetpack_tpu.representation import PaiNN
    from schnetpack_tpu.train.callbacks import load_pytree

    def painn(radial):
        return PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=N_RBF,
                     cutoff=CUTOFF, radial_basis=radial)

    tree = load_pytree(ASSET)
    centers, widths = perturbed_radial()
    rep = dict(tree["params"]["representation"],
               radial_basis={"centers": centers, "widths": widths})
    trbf = {"params": dict(tree["params"], representation=rep)}
    write_reference(painn(GaussianRBF(N_RBF, CUTOFF, trainable=True)), trbf,
                    OUT["trbf"], centers=centers, widths=widths,
                    radial_seed=np.int64(RADIAL_SEED))
    write_reference(painn(BesselRBF(N_RBF, CUTOFF)), tree, OUT["bessel"])


if __name__ == "__main__":
    main()
