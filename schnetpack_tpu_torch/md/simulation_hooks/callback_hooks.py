"""Host hooks that write files (parity: ``schnetpack_tpu/md/
simulation_hooks/callback_hooks.py:21-40``): ``Checkpoint``, a pickle of
``simulator.state_dict()``, whose tensors are numpy arrays."""
from __future__ import annotations

import os
import pickle

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
