"""MD simulator: a Python step loop (parity of semantics with
``schnetpack_tpu/md/simulator.py:108-142``, without hooks).

Each step: half step, main step, skin check (and host neighbor-list
rebuild when it fires), force calculation, half step.  The logged
quantities of a chunk are stacked on the device and fetched once per
chunk into ``self.logs``.  Capturing the step in a CUDA graph is later
work.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from .system import System


class Simulator:
    def __init__(self, system: System, integrator, calculator,
                 log_keys: Sequence[str] = ("energy", "temperature"),
                 progress: bool = False):
        self.system = system
        self.integrator = integrator
        self.calculator = calculator
        self.log_keys = tuple(log_keys)
        self.progress = progress
        self.n_simulated = 0
        self.calc_state = None
        #: one dict of stacked per-step arrays per chunk
        self.logs: List[Dict[str, np.ndarray]] = []

    def _ensure_state(self) -> None:
        if self.calc_state is None:
            self.calc_state = self.calculator.init_state(self.system)
            self.system = self.calculator.calculate(self.system,
                                                    self.calc_state)

    def step(self, system: System) -> System:
        system = self.integrator.half_step(system)
        system = self.integrator.main_step(system)
        self.calc_state = self.calculator.update_state(system, self.calc_state)
        system = self.calculator.calculate(system, self.calc_state)
        return self.integrator.half_step(system)

    @torch.no_grad()
    def simulate(self, n_steps: int, chunk_size: int = 100) -> System:
        self._ensure_state()
        system = self.system
        remaining = n_steps
        t0 = time.perf_counter()
        while remaining > 0:
            n = min(chunk_size, remaining)
            rec: Dict[str, list] = {k: [] for k in self.log_keys}
            for _ in range(n):
                system = self.step(system)
                for k in self.log_keys:
                    rec[k].append(getattr(system, k))
            self.logs.append({k: torch.stack(v).cpu().numpy()
                              for k, v in rec.items()})
            self.n_simulated += n
            remaining -= n
            if self.progress:
                T = float(self.logs[-1].get("temperature",
                                            np.zeros(1))[-1].mean())
                rate = self.n_simulated / max(time.perf_counter() - t0, 1e-9)
                print(f"step {self.n_simulated}  T={T:8.2f} K  "
                      f"{rate:8.1f} steps/s", flush=True)
        self.system = system
        return system
