"""Host hooks that write files (parity: ``schnetpack_tpu/md/
simulation_hooks/callback_hooks.py``): ``Checkpoint``, a pickle of
``simulator.state_dict()``, whose tensors are numpy arrays;
``FileLogger``, the trajectory file (``data/store.py``: HDF5 where
``h5py`` is importable, else a directory of ``.npy`` files); and
``TensorBoardLoggerMD``.  The simulator hands them each chunk's logs as
numpy arrays, so all file work happens between chunks.
"""
from __future__ import annotations

import os
import pickle
import numpy as np

from ..data.hdf5 import MOLECULE_KEYS
from ..data.store import open_store
from .basic_hooks import SimulationHook


class Checkpoint(SimulationHook):
    """Writes the state every ``every_n_steps`` steps (at the end of the
    chunk that crosses a multiple) and at the end of each ``simulate``."""

    def __init__(self, checkpoint_file: str, every_n_steps: int = 1000):
        self.checkpoint_file = checkpoint_file
        self.every_n_steps = every_n_steps
        self._last_saved = -1

    def _write(self, simulator):
        os.makedirs(os.path.dirname(os.path.abspath(self.checkpoint_file)),
                    exist_ok=True)
        with open(self.checkpoint_file, "wb") as f:
            pickle.dump(simulator.state_dict(), f)

    def process_chunk(self, simulator, logs, start_step):
        end_step = start_step + next(iter(logs.values())).shape[0]
        if end_step // self.every_n_steps > self._last_saved:
            self._last_saved = end_step // self.every_n_steps
            self._write(simulator)

    def on_simulation_end(self, simulator):
        self._write(simulator)


class FileLogger(SimulationHook):
    """The trajectory file (``callback_hooks.py:42-130``): group
    ``molecules`` with positions, momenta, forces and cells per logged step
    and the attrs ``time_step`` (dt x ``every_n_steps``, MD units),
    ``n_replicas``, ``n_molecules``, ``total_atoms``, ``masses``,
    ``atomic_numbers``, ``idx_m`` and ``pbc``; group ``properties`` with
    every other logged key.  Data are cast to float32 (``precision=32``)
    or float64.  An existing file raises ``FileExistsError`` unless
    ``restart``, which appends to it.  Each chunk writes every
    ``every_n_steps``-th of its steps from its own first, so the stride
    restarts at each chunk where ``chunk_size % every_n_steps != 0``
    (``callback_hooks.py:113``).  The JAX signature's ``buffer_size`` and
    ``data_streams`` are not taken: the simulator's chunks are the buffer,
    and both groups are always written."""

    def __init__(self, filename: str, every_n_steps: int = 1,
                 precision: int = 32, restart: bool = False):
        self.filename = filename
        self.every_n_steps = every_n_steps
        self.dtype = np.float32 if precision == 32 else np.float64
        self.restart = restart
        self.store = None

    def on_simulation_start(self, simulator):
        exists = os.path.exists(self.filename)
        if exists and not self.restart and simulator.n_simulated == 0:
            raise FileExistsError(
                f"{self.filename} exists; set restart=True to append")
        os.makedirs(os.path.dirname(os.path.abspath(self.filename)),
                    exist_ok=True)
        self.store = open_store(self.filename,
                                "a" if self.restart and exists else "w")
        s = simulator.system
        if not self.store.has_group("molecules"):
            self.store.create_group("molecules", {
                "time_step": simulator.integrator.dt * self.every_n_steps,
                "n_replicas": s.n_replicas,
                "n_molecules": s.n_molecules,
                "total_atoms": s.total_atoms,
                "masses": s.masses.cpu().numpy(),
                "atomic_numbers": s.atomic_numbers.cpu().numpy(),
                "idx_m": s.idx_m.cpu().numpy(),
                "pbc": s.pbc.cpu().numpy(),
            })
            self.store.create_group("properties", {})
        self.store.start_swmr()

    def process_chunk(self, simulator, logs, start_step):
        if self.store is None:
            return
        sel = slice(None, None, self.every_n_steps)
        for k, v in logs.items():
            group = "molecules" if k in MOLECULE_KEYS else "properties"
            self.store.append(group, k, np.asarray(v[sel], self.dtype))
        self.store.flush()

    def on_simulation_end(self, simulator):
        if self.store is not None:
            self.store.close()
            self.store = None


class TensorBoardLoggerMD(SimulationHook):
    """Temperature and energy curves to TensorBoard
    (``callback_hooks.py:133-167``); writes nothing where ``tensorboardX``
    is not importable."""

    def __init__(self, log_file: str, every_n_steps: int = 10):
        self.log_file = log_file
        self.every_n_steps = every_n_steps
        self._writer = None

    def on_simulation_start(self, simulator):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._writer = None
            return
        self._writer = SummaryWriter(self.log_file)

    def process_chunk(self, simulator, logs, start_step):
        if self._writer is None:
            return
        n = next(iter(logs.values())).shape[0]
        for i in range(0, n, self.every_n_steps):
            step = start_step + i
            if "temperature" in logs:
                self._writer.add_scalar(
                    "temperature", float(np.mean(logs["temperature"][i])),
                    step)
            if "energy" in logs:
                self._writer.add_scalar(
                    "potential_energy", float(np.sum(logs["energy"][i])),
                    step)
            if "kinetic_energy" in logs:
                self._writer.add_scalar(
                    "kinetic_energy",
                    float(np.sum(logs["kinetic_energy"][i])), step)

    def on_simulation_end(self, simulator):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
