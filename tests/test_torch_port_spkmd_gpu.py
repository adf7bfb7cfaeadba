"""PyTorch port, ``spkmd`` on a card only (skipped without CUDA):
PaiNN-128x3 from a run directory on a 2,048-atom argon box through
``schnetpack_tpu_torch.md.cli.main`` with K1-K4's launches and the
trajectory file, and the ensemble calculator's members over one
``ColRefs`` a step against single calculators.  No jax import: on a
machine without jax run
``python -m pytest --noconftest -m gpu tests/test_torch_port_spkmd_gpu.py``.
"""
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from schnetpack_tpu_torch.datasets import write_extxyz
from schnetpack_tpu_torch.ops import colblock_message as msg
from schnetpack_tpu_torch.ops import painn_mixing as mix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "scripts", "assets", "bench_painn_argon.msgpack")
RUN_CONFIG = {
    "_target_": "schnetpack_tpu.model.NeuralNetworkPotential",
    "representation": {"_target_": "schnetpack_tpu.representation.PaiNN",
                       "n_atom_basis": 128, "n_interactions": 3,
                       "n_rbf": 20, "cutoff": 5.0},
    "input_modules": [{"_target_":
                       "schnetpack_tpu.atomistic.PairwiseDistances"}],
    "output_modules": [{"_target_": "schnetpack_tpu.atomistic.Atomwise",
                        "output_key": "energy"},
                       {"_target_": "schnetpack_tpu.atomistic.Forces"}],
}
STEPS = 20
KERNELS = ("msg_fwd", "msg_bwd", "mix_fwd", "mix_bwd")
ENSEMBLE_ATOL = 1e-6          # eV/A, the members' mean vs single calculators


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def fcc_box(n_cells, a=5.26, jitter=0.05, seed=0):
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                    -1).reshape(-1, 1, 3)
    R = ((base[None] + grid) * a).reshape(-1, 3)
    R = R + jitter * np.random.RandomState(seed).randn(*R.shape)
    return R, np.eye(3) * a * n_cells


def run_dir(path, tree=None):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model_config.pkl"), "wb") as f:
        pickle.dump(RUN_CONFIG, f)
    if tree is None:
        shutil.copy(ASSET, os.path.join(path, "best_model"))
    else:
        with open(os.path.join(path, "best_model"), "wb") as f:
            pickle.dump(tree, f)
    return str(path)


def counts():
    c = {**msg.LAUNCHES, **mix.LAUNCHES}
    return {k: c[k] for k in KERNELS}


def reset():
    for d in (msg.LAUNCHES, mix.LAUNCHES):
        for k in d:
            d[k] = 0


@pytest.mark.gpu
def test_spkmd_painn_on_the_card(cuda_device, tmp_path):
    from schnetpack_tpu_torch.md import cli
    from schnetpack_tpu_torch.md.data import HDF5Loader

    R, cell = fcc_box(8)
    xyz = str(tmp_path / "box.xyz")
    write_extxyz(xyz, [{"numbers": np.full(len(R), 18), "positions": R,
                        "cell": cell}])
    reset()
    sim = cli.main([
        f"system.molecule_file={xyz}",
        f"calculator.model_dir={run_dir(tmp_path / 'run')}",
        "calculator.neighbor_list=cellblock", "dynamics=nvt",
        "thermostat=langevin", "thermostat.temperature_bath=30",
        "thermostat.time_constant=20", "system.initializer.temperature=30",
        f"dynamics.n_steps={STEPS}", "dynamics.chunk_size=10",
        "callbacks=hdf5", f"simulation_dir={tmp_path / 'sim'}"])
    assert sim.system.positions.is_cuda
    # one evaluation before the first step, then one a step
    assert counts() == {k: 3 * (STEPS + 1) for k in KERNELS}
    data = HDF5Loader(str(tmp_path / "sim" / "simulation.hdf5"))
    assert data.entries == STEPS
    for k in ("positions", "momenta"):
        np.testing.assert_array_equal(data.get(k, replica_idx=0)[-1],
                                      getattr(sim.system, k)[0].cpu().numpy())
    T = data.get_temperature()
    assert np.isfinite(T).all() and 0 < T.max() < 300


@pytest.mark.gpu
def test_ensemble_members_share_one_colrefs(cuda_device, tmp_path,
                                            monkeypatch):
    from schnetpack_tpu_torch.convert import load_jax_params
    from schnetpack_tpu_torch.md import cli, load_molecules
    from schnetpack_tpu_torch.representation import painn

    rng = np.random.RandomState(1)
    tree = load_jax_params(ASSET)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        node = np.asarray(node, np.float32)
        return node * (1 + 0.01 * rng.uniform(-1, 1, node.shape)).astype(
            np.float32)
    dirs = [run_dir(tmp_path / "a"), run_dir(tmp_path / "b", walk(tree))]
    common = {"_target_": "schnetpack_tpu_torch.md.calculators."
                          "SchNetPackCalculator",
              "cutoff": 5.0, "cutoff_shell": 0.6, "neighbor_list": "cellblock"}
    ens = cli.build_calculator(dict(
        common, _target_="schnetpack_tpu_torch.md.calculators."
                         "EnsembleCalculator", model_dirs=dirs))
    singles = [cli.build_calculator(dict(common, model_dir=d)) for d in dirs]
    R, cell = fcc_box(8)
    from schnetpack_tpu_torch import properties as TP

    system = load_molecules([{TP.Z: np.full(len(R), 18), TP.R: R,
                              TP.cell: cell, TP.pbc: np.ones(3, bool)}],
                            device=cuda_device)
    seen = []
    real = painn.column_refs

    def spy(inputs):
        refs = real(inputs)
        seen.append(id(refs))
        return refs
    monkeypatch.setattr(painn, "column_refs", spy)
    state = ens.init_state(system)
    reset()
    out = ens.calculate(system, state)
    assert counts() == {k: 6 for k in KERNELS}
    assert len(seen) == 2 and seen[0] == seen[1]
    F = torch.stack([c.calculate(system, c.init_state(system)).forces
                     for c in singles])
    to_ev = 1.0 / ens.force_conversion
    err = float((out.forces - F.mean(0)).abs().max()) * to_ev
    assert err <= ENSEMBLE_ATOL, err
    unc = out.properties["forces_uncertainty"]
    err = float((unc - F.std(0, correction=0)).abs().max()) * to_ev
    assert err <= ENSEMBLE_ATOL, err
    assert float(unc.max()) * to_ev > 100 * ENSEMBLE_ATOL
