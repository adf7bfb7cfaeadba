"""PyTorch port, trajectory files and spectra on the CPU against the JAX
package:

* the JAX ``HDF5Loader`` reads the port's HDF5 file, and the port's
  loader reads the JAX ``spkmd``'s file and the port's ``.npy`` store (the
  format written without ``h5py``), with equal ``get`` (replica mean,
  ``mol_idx``, ``velocities``), ``get_temperature``, ``convert_to_atoms``,
  ``properties`` and ``skip_initial``;
* ``PowerSpectrum``, ``IRSpectrum`` and ``RamanSpectrum`` against the JAX
  ones on the same file, rtol 1e-10: no port model logs dipoles yet, so
  the file is synthetic (two replicas of a 3-atom molecule with damped
  oscillating dipole and polarizability streams);
* ``FileLogger``: the stride of ``every_n_steps`` restarts at each chunk
  (``callback_hooks.py:113``), an existing file raises, f64 on request;
* ``TensorBoardLoggerMD`` writes where ``tensorboardX`` is importable and
  nothing where it is not.
"""
import os
import sys

import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.md.cli import main as jspkmd
from schnetpack_tpu.md.data import HDF5Loader as JHDF5Loader
from schnetpack_tpu.md.data import IRSpectrum as JIRSpectrum
from schnetpack_tpu.md.data import PowerSpectrum as JPowerSpectrum
from schnetpack_tpu.md.data import RamanSpectrum as JRamanSpectrum
from schnetpack_tpu_torch.md import Simulator, VelocityVerlet, load_molecules
from schnetpack_tpu_torch.md.calculators import LJCalculator
from schnetpack_tpu_torch.md.data import (
    HDF5Loader, IRSpectrum, PowerSpectrum, RamanSpectrum, open_store, store,
)
from schnetpack_tpu_torch.md.simulation_hooks import (
    FileLogger, LangevinThermostat, TensorBoardLoggerMD,
)
from schnetpack_tpu_torch.units import _parse_unit, md_units

SPECTRUM_RTOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def argon_cluster():
    rng = np.random.RandomState(0)
    grid = np.array([[i, j, k] for i in range(2) for j in range(2)
                     for k in range(2)], float)
    return {P.Z: np.full(8, 18), P.R: grid * 3.9 + rng.rand(8, 3) * 0.05,
            P.cell: np.zeros((3, 3)), P.pbc: np.zeros(3, bool)}


def port_run(path, steps=30, chunk_size=10, n_replicas=2, every=1,
             precision=32):
    """A Langevin run of two replicas of the argon cluster (so that the
    replica mean is exercised) logged to ``path``; returns the simulator."""
    system = load_molecules([argon_cluster()] * 2, n_replicas=n_replicas,
                            device="cpu")
    sim = Simulator(system, VelocityVerlet(0.5),
                    LJCalculator(3.82, 0.0103, 8.0),
                    simulator_hooks=[
                        LangevinThermostat(40.0, 20.0),
                        FileLogger(path, every_n_steps=every,
                                   precision=precision)], seed=3)
    sim.simulate(steps, chunk_size=chunk_size)
    return sim


def assert_loaders_match(got, want, skip=0):
    assert got.entries == want.entries
    for k in ("time_step", "n_replicas", "n_molecules", "total_atoms"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("masses", "atomic_numbers", "idx_m", "pbc"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert sorted(got.properties) == sorted(want.properties)
    last = want.n_molecules - 1
    for name in want.properties:
        for kw in ({}, {"replica_idx": 1}, {"mol_idx": last},
                   {"mol_idx": 0, "replica_idx": 0}):
            np.testing.assert_array_equal(got.get(name, **kw),
                                          want.get(name, **kw),
                                          err_msg=f"{name} {kw}")
    np.testing.assert_array_equal(got.get_temperature(),
                                  want.get_temperature())
    for frame in (0, -1):
        a, b = got.convert_to_atoms(frame), want.convert_to_atoms(frame)
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("skip", [0, 7])
def test_jax_loader_reads_the_port_file(tmp_path, skip):
    path = str(tmp_path / "simulation.hdf5")
    sim = port_run(path)
    got, want = HDF5Loader(path, skip), JHDF5Loader(path, skip)
    assert want.entries == 30 - skip and want.n_replicas == 2
    assert_loaders_match(got, want)
    # the last frame is the simulator's state
    np.testing.assert_array_equal(want.get("positions", replica_idx=1)[-1],
                                  sim.system.positions[1].numpy())
    got.close()
    want.close()


def test_port_loader_reads_the_jax_file(tmp_path):
    xyz = str(tmp_path / "argon.xyz")
    mol = argon_cluster()
    with open(xyz, "w") as f:
        f.write("8\nargon\n" + "".join(f"Ar {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n"
                                       for p in mol[P.R]))
    sim_dir = str(tmp_path / "jax")
    jspkmd([f"system.molecule_file={xyz}", f"simulation_dir={sim_dir}",
            "calculator=lj", "dynamics=nvt", "thermostat=langevin",
            "thermostat.temperature_bath=40", "dynamics.n_steps=20",
            "dynamics.chunk_size=10", "system.initializer.temperature=40",
            "system.n_replicas=2"])
    path = os.path.join(sim_dir, "simulation.hdf5")
    got, want = HDF5Loader(path, 3), JHDF5Loader(path, 3)
    assert got.entries == 17 and got.n_replicas == 2
    assert_loaders_match(got, want)


def test_port_loader_reads_the_npy_store(tmp_path, monkeypatch):
    """The same deterministic run written as HDF5 and, without h5py, as
    the ``.npy`` store: the port's loader reads both alike."""
    h5 = str(tmp_path / "a.hdf5")
    npy = str(tmp_path / "b.hdf5")
    port_run(h5, steps=25, chunk_size=10)
    monkeypatch.setattr(store, "h5py_available", lambda: False)
    port_run(npy, steps=25, chunk_size=10)
    assert os.path.isdir(npy) and os.path.isfile(h5)
    assert open_store(npy, "r").kind == "npy"
    # a .npy dataset is a plain numpy file
    pos = np.load(os.path.join(npy, "molecules", "positions.npy"))
    assert pos.shape == (25, 2, 16, 3) and pos.dtype == np.float32
    for skip in (0, 4):
        assert_loaders_match(HDF5Loader(npy, skip), HDF5Loader(h5, skip))


def synthetic_file(path, T=400, dt_fs=0.5):
    """A trajectory file of two replicas of one 3-atom molecule whose
    dipole and polarizability oscillate at 1,600 and 3,700 cm^-1 under
    noise, written through the port's store."""
    rng = np.random.RandomState(9)
    fs = _parse_unit("fs") * md_units().time      # MD time units per fs
    dt = dt_fs * fs
    t = np.arange(T)[:, None, None] * dt
    c_cm = 2.99792458e10 * 1e-15 / fs             # cm per MD time unit
    w1, w2 = (2 * np.pi * c_cm * nu for nu in (1600.0, 3700.0))
    st = open_store(path, "w")
    st.create_group("molecules", {
        "time_step": dt, "n_replicas": 2, "n_molecules": 1,
        "total_atoms": 3, "masses": np.array([16.0, 1.0, 1.0], np.float32),
        "atomic_numbers": np.array([8, 1, 1]), "idx_m": np.zeros(3, int),
        "pbc": np.zeros((1, 3), bool)})
    st.create_group("properties", {})
    damp = np.exp(-t / (T * dt))
    mu = (np.sin(w1 * t) + 0.5 * np.cos(w2 * t)) * damp * [1.0, 0.3, -0.2]
    mu = mu[:, :, None] + 0.01 * rng.randn(T, 2, 1, 3)
    alpha = (np.sin(w2 * t)[..., None] * damp[..., None]
             * np.array([[1, 0.2, 0], [0.2, 0.5, 0.1], [0, 0.1, 0.3]]))
    alpha = alpha[:, :, None] + 0.01 * rng.randn(T, 2, 1, 3, 3)
    for name, data in (("positions", rng.randn(T, 2, 3, 3)),
                       ("momenta", rng.randn(T, 2, 3, 3))):
        st.append("molecules", name, data.astype(np.float32))
    st.append("properties", "dipole_moment", mu.astype(np.float32))
    st.append("properties", "polarizability", alpha.astype(np.float32))
    st.close()


SPECTRA = {
    "power": (PowerSpectrum, JPowerSpectrum, {}),
    "ir": (IRSpectrum, JIRSpectrum, {}),
    "raman": (RamanSpectrum, JRamanSpectrum, {"incident_frequency": 19455.0}),
    "raman_averaged": (RamanSpectrum, JRamanSpectrum,
                       {"incident_frequency": 19455.0, "averaged": True}),
}


@pytest.mark.parametrize("name", list(SPECTRA))
def test_spectra_match_jax(tmp_path, name):
    path = str(tmp_path / "synthetic.hdf5")
    synthetic_file(path)
    cls, jcls, kw = SPECTRA[name]
    got, want = cls(HDF5Loader(path), resolution=256, **kw), jcls(
        JHDF5Loader(path), resolution=256, **kw)
    got.compute_spectrum(0)
    want.compute_spectrum(0)
    a, b = got.get_spectrum(), want.get_spectrum()
    assert len(a) == len(b) == {"raman": 2}.get(name, 1)
    for (fa, ia), (fb, ib) in zip(a, b):
        np.testing.assert_allclose(fa, fb, rtol=SPECTRUM_RTOL)
        np.testing.assert_allclose(ia, ib, rtol=SPECTRUM_RTOL, atol=0)
        assert np.isfinite(ia).all() and ia.max() > 0


def test_file_logger_stride_restarts_each_chunk(tmp_path):
    path = str(tmp_path / "simulation.hdf5")
    sim = port_run(path, steps=25, chunk_size=10, every=3, precision=64)
    data = HDF5Loader(path)
    # steps 0, 3, 6, 9 of each chunk of 10, then 0, 3 of the last 5
    assert data.entries == 4 + 4 + 2
    want = np.concatenate([lg["positions"][::3] for lg in sim.logs])
    np.testing.assert_array_equal(data.get("positions", replica_idx=0),
                                  want[:, 0])
    assert data.get("positions").dtype == np.float64
    assert data.time_step == pytest.approx(3 * sim.integrator.dt)
    with pytest.raises(FileExistsError):
        port_run(path)


@pytest.mark.parametrize("installed", [True, False])
def test_tensorboard_logger(tmp_path, monkeypatch, installed):
    if installed:
        pytest.importorskip("tensorboardX")
    else:
        monkeypatch.setitem(sys.modules, "tensorboardX", None)
    log_dir = str(tmp_path / "tb")
    system = load_molecules([argon_cluster()], device="cpu")
    sim = Simulator(system, VelocityVerlet(0.5),
                    LJCalculator(3.82, 0.0103, 8.0),
                    simulator_hooks=[TensorBoardLoggerMD(log_dir, 5)])
    sim.simulate(20, chunk_size=10)
    written = os.path.isdir(log_dir) and any(
        f.startswith("events") for f in os.listdir(log_dir))
    assert written == installed
