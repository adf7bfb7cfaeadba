"""PyTorch port, MD level: a short NVE trajectory of the 256-atom argon box
with the trained bench asset against the JAX ``Simulator``, plus the
package's isolation from jax.

Both packages start from the same numpy positions and momenta; a small
skin makes both neighbor lists rebuild mid-run, on the device (the JAX
package inside its scan, the port in ``maybe_rebuild``).  The port runs
in both ``fuse`` modes against one JAX run.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.atomistic import Atomwise as JAtomwise
from schnetpack_tpu.atomistic import Forces as JForces
from schnetpack_tpu.atomistic import PairwiseDistances
from schnetpack_tpu.md import Simulator as JSimulator
from schnetpack_tpu.md import VelocityVerlet as JVelocityVerlet
from schnetpack_tpu.md import load_molecules as jload_molecules
from schnetpack_tpu.md.calculators import SchNetPackCalculator as JCalculator
from schnetpack_tpu.md.neighborlist_md import (
    CellBlockNeighborListMD as JCellBlockNBL,
)
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.representation import PaiNN as JPaiNN
from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
from schnetpack_tpu_torch.md import (
    CellBlockNeighborListMD, Simulator, VelocityVerlet, load_molecules,
)
from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
from schnetpack_tpu_torch.units import _parse_unit, md_units

from test_torch_port_model import ASSET, CUTOFF, ROOT, fcc_box, port_potential

N_STEPS = 20
SKIN = 0.04          # Angstrom: small, so the skin criterion fires
TEMPERATURE = 100.0  # K, initial momenta
# positions after 20 steps: the f32 force differences (<1e-5 eV/Ang)
# integrate to far below this; momenta carry the same relative error
POS_ATOL = 1e-5      # nm
MOM_RTOL, MOM_ATOL = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _start():
    rng = np.random.RandomState(3)
    R, cell = fcc_box(4)
    R = R + rng.uniform(-0.1, 0.1, R.shape)
    mol = {P.Z: np.full(len(R), 18, np.int64), P.R: R, P.cell: cell,
           P.pbc: np.ones(3, bool)}
    masses = 39.948 * md_units().mass
    sigma = np.sqrt(masses * md_units().kB * TEMPERATURE)
    p0 = (sigma * rng.randn(1, len(R), 3)).astype(np.float32)
    p0 -= p0.mean(axis=1, keepdims=True)
    return mol, p0


def _jax_run(mol, p0, params):
    conv = _parse_unit("Ang") * md_units().length
    system = jload_molecules([mol]).replace(momenta=jnp.asarray(p0))
    pot = JNNP(representation=JPaiNN(n_atom_basis=128, n_interactions=3,
                                     n_rbf=20, cutoff=CUTOFF),
               input_modules=[PairwiseDistances()],
               output_modules=[JAtomwise(output_key=P.energy), JForces()])
    nbl = JCellBlockNBL(CUTOFF * conv, skin=SKIN * conv, layout="column")
    calc = JCalculator(pot, params, cutoff=CUTOFF, cutoff_shell=SKIN,
                       neighbor_list=nbl)
    sim = JSimulator(system, JVelocityVerlet(0.5), calc, progress=False,
                     log_keys=("energy", "temperature"))
    sim.simulate(N_STEPS, chunk_size=N_STEPS)
    s = sim.state.system
    return np.asarray(s.positions), np.asarray(s.momenta), np.asarray(
        s.energy)


@pytest.fixture(scope="module")
def jax_trajectory():
    mol, p0 = _start()
    return _jax_run(mol, p0, load_jax_params(ASSET))


@pytest.mark.parametrize("fuse", ["full", "hybrid"])
def test_nve_trajectory_matches_jax(jax_trajectory, fuse):
    mol, p0 = _start()
    R_j, p_j, E_j = jax_trajectory

    conv = _parse_unit("Ang") * md_units().length
    system = load_molecules([mol], device="cpu").replace(
        momenta=torch.tensor(p0))
    nbl = CellBlockNeighborListMD(CUTOFF * conv, skin=SKIN * conv)
    calc = SchNetPackCalculator(
        port_potential(fuse=fuse), params_from_jax(load_jax_params(ASSET)),
        cutoff=CUTOFF, cutoff_shell=SKIN, neighbor_list=nbl)
    sim = Simulator(system, VelocityVerlet(0.5), calc)
    sim.simulate(N_STEPS, chunk_size=10)

    assert nbl.n_device_builds >= 1, "no rebuild went through the device"
    assert nbl.n_builds == 1 and nbl.n_device_overflows == 0
    assert len(sim.logs) == 2 and sim.logs[0]["energy"].shape == (10, 1, 1)
    np.testing.assert_allclose(sim.system.positions.numpy(), R_j, rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(sim.system.momenta.numpy(), p_j,
                               rtol=MOM_RTOL, atol=MOM_ATOL)
    np.testing.assert_allclose(sim.system.energy.numpy(), E_j, rtol=1e-5)


def test_import_leaves_jax_out():
    code = ("import sys, schnetpack_tpu_torch.md.calculators, "
            "schnetpack_tpu_torch.convert, "
            "schnetpack_tpu_torch.representation, "
            "schnetpack_tpu_torch.atomistic, schnetpack_tpu_torch.nn.so3, "
            "schnetpack_tpu_torch.ops.so3, "
            "schnetpack_tpu_torch.ops.colblock_select, "
            "schnetpack_tpu_torch.ops.cellblock_gather, "
            "schnetpack_tpu_torch.ops.painn_fused, "
            "schnetpack_tpu_torch.representation.field_schnet, "
            "schnetpack_tpu_torch.nn.embedding, "
            "schnetpack_tpu_torch.md.simulation_hooks, "
            "schnetpack_tpu_torch.md.utils, "
            "schnetpack_tpu_torch.md.calculators.lj, "
            "schnetpack_tpu_torch.md.cli, schnetpack_tpu_torch.md.data, "
            "schnetpack_tpu_torch.config, schnetpack_tpu_torch.cli, "
            "schnetpack_tpu_torch.datasets; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'flax' "
            "or m.startswith(('jax.', 'flax.', 'schnetpack_tpu.')) "
            "or m == 'schnetpack_tpu']; print(bad); sys.exit(bool(bad))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
