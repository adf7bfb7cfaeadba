"""MD simulator: a Python step loop with device hooks (parity of
semantics with ``schnetpack_tpu/md/simulator.py``).

Each step: the device hooks in order (thermostats and the like), half
step, main step, the calculator's skin check (``update_state``, which
rebuilds the neighbor state when it fires), force calculation, half step,
then the device hooks in reverse order (propagator symmetry).  A device
hook has ``apply(state, system, generator, dt)``; every other hook is a
host hook, which sees the simulator between chunks.  ``seed`` makes one
``torch.Generator`` on the system's device, which every ``apply`` draws
from.  The logged quantities of a chunk are stacked on the device and
fetched once per chunk into ``self.logs``, which host hooks receive as
numpy arrays (``process_chunk``).  ``state_dict`` and ``load_state_dict``
(``restart_simulation``) keep the system, the hook states, the
generator's state and the step count; a restored simulator rebuilds its
neighbor state from the restored positions.  Capturing the step in a
CUDA graph is later work.

The default ``log_keys`` are the JAX package's eight
(``simulator.py:48-51``), each read from ``system.properties`` first, then
from the system's attribute or derived property; a key the system does not
have is not logged.  Logging adds no host sync inside a chunk: each step
appends references to its tensors.

An NPT integrator (``pressure_control``) delegates its half and main
steps to its barostat, which is also one of the device hooks: the
simulator hands the integrator that hook's current state (the one it
owns, so a restored state after ``load_state_dict``), where the JAX
package passes it through the barostat's ``_live_state``
(``barostats.py:111-112, 131-152``).  A calculator with ``fixed_cell``
(a ``SchNetPackCalculator`` without a ``stress_key``) refuses an NPT
integrator at construction, and so does one on a skin neighbor list
(``dense``, ``cellblock``, ``cellblock_atom``): those keep the periodic
offsets of their last build while the cell moves, where ``all_pairs``
takes them from the current cell at every step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from .system import System


def _is_device_hook(hook) -> bool:
    return callable(getattr(hook, "apply", None))


def _to_numpy(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x


def _to_device(x, device):
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=device)
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    return x


LOG_KEYS = ("positions", "momenta", "forces", "energy", "cells", "stress",
            "temperature", "kinetic_energy")


class Simulator:
    def __init__(self, system: System, integrator, calculator,
                 simulator_hooks: Sequence = (), seed: int = 42,
                 log_keys: Sequence[str] = LOG_KEYS,
                 progress: bool = False):
        if getattr(integrator, "pressure_control", False):
            name = (f"{type(calculator).__name__} cannot run under the NPT "
                    f"integrator {type(integrator).__name__}")
            if getattr(calculator, "fixed_cell", False):
                raise ValueError(
                    f"{name}: it computes no stress; give it a stress_key "
                    "and a model with Forces(calc_stress=True)")
            if getattr(calculator, "nbl", None) is not None:
                raise ValueError(
                    f"{name} on a skin neighbor list, which keeps the "
                    "offsets of its build while the cell moves: use "
                    "neighbor_list='all_pairs'")
        self.system = system
        self.integrator = integrator
        self.calculator = calculator
        self.device_hooks = [h for h in simulator_hooks if _is_device_hook(h)]
        self.host_hooks = [h for h in simulator_hooks
                           if not _is_device_hook(h)]
        self._barostat = None
        if getattr(integrator, "pressure_control", False):
            if integrator.barostat not in self.device_hooks:
                raise ValueError(
                    "an NPT integrator's barostat must be among the "
                    "simulator's hooks")
            self._barostat = self.device_hooks.index(integrator.barostat)
        self.generator = torch.Generator(
            device=system.positions.device).manual_seed(seed)
        self.log_keys = tuple(log_keys)
        self.progress = progress
        self.n_simulated = 0
        #: wall seconds of ``simulate``'s steps and host hooks, from a
        #: synchronize with the device to the last chunk's hooks (each
        #: chunk ends in its logs' copy to the host)
        self.wall_seconds = 0.0
        self.calc_state = None
        self.hook_states: List[Any] = []
        self._ready = False
        #: one dict of stacked per-step arrays per chunk
        self.logs: List[Dict[str, np.ndarray]] = []

    def _ensure_state(self) -> None:
        """Neighbor state, forces and hook states of the first step."""
        if self._ready:
            return
        self.calc_state = self.calculator.init_state(self.system)
        self.system = self.calculator.calculate(self.system, self.calc_state)
        self.hook_states = [h.init_state(self.system, self.integrator.dt)
                            for h in self.device_hooks]
        self._ready = True

    def _hooks(self, system: System, order) -> System:
        for i in order:
            self.hook_states[i], system = self.device_hooks[i].apply(
                self.hook_states[i], system, self.generator,
                self.integrator.dt)
        return system

    def step(self, system: System) -> System:
        n_hooks = len(self.device_hooks)
        system = self._hooks(system, range(n_hooks))
        baro = (() if self._barostat is None
                else (self.hook_states[self._barostat],))
        system = self.integrator.half_step(system, *baro)
        system = self.integrator.main_step(system, *baro)
        self.calc_state = self.calculator.update_state(system, self.calc_state)
        system = self.calculator.calculate(system, self.calc_state)
        system = self.integrator.half_step(system, *baro)
        return self._hooks(system, range(n_hooks - 1, -1, -1))

    def _log_record(self, system: System) -> Dict[str, torch.Tensor]:
        """The logged tensors of one step (``simulator.py:92-101``)."""
        rec = {}
        for k in self.log_keys:
            v = (system.properties[k] if k in system.properties
                 else getattr(system, k, None))
            if v is not None:
                rec[k] = v
        return rec

    @torch.no_grad()
    def simulate(self, n_steps: int, chunk_size: int = 100) -> System:
        self._ensure_state()
        for h in self.host_hooks:
            h.on_simulation_start(self)
        system = self.system
        remaining = n_steps
        if system.positions.is_cuda:
            torch.cuda.synchronize(system.positions.device)
        t0 = time.perf_counter()
        while remaining > 0:
            n = min(chunk_size, remaining)
            rec: Dict[str, list] = {}
            for _ in range(n):
                system = self.step(system)
                for k, v in self._log_record(system).items():
                    rec.setdefault(k, []).append(v)
            self.system = system
            logs = {k: torch.stack(v).cpu().numpy() for k, v in rec.items()}
            self.logs.append(logs)
            start = self.n_simulated
            self.n_simulated += n
            remaining -= n
            for h in self.host_hooks:
                h.process_chunk(self, logs, start)
            if self.progress:
                T = float(logs.get("temperature", np.zeros(1))[-1].mean())
                rate = self.n_simulated / max(time.perf_counter() - t0, 1e-9)
                print(f"step {self.n_simulated}  T={T:8.2f} K  "
                      f"{rate:8.1f} steps/s", flush=True)
        self.wall_seconds += time.perf_counter() - t0
        for h in self.host_hooks:
            h.on_simulation_end(self)
        return system

    def state_dict(self) -> Dict[str, Any]:
        """The system, hook states and generator state as numpy arrays,
        and the step count."""
        self._ensure_state()
        return {
            "system": {f.name: _to_numpy(getattr(self.system, f.name))
                       for f in dataclasses.fields(System)},
            "hook_states": [_to_numpy(s) for s in self.hook_states],
            "generator": self.generator.get_state().numpy(),
            "n_simulated": self.n_simulated,
        }

    def load_state_dict(self, d: Dict[str, Any], soft: bool = False) -> None:
        """Restore a ``state_dict``; ``soft`` keeps this simulator's hook
        states where it has them (the reference's soft thermostat
        restore).  The neighbor state is derived: it is rebuilt from the
        restored positions, as a fresh start would build it."""
        dev = self.system.positions.device
        self.system = System(**{k: _to_device(v, dev)
                                for k, v in d["system"].items()})
        if not (soft and self._ready):
            self.hook_states = [_to_device(s, dev) for s in d["hook_states"]]
        self.generator.set_state(torch.as_tensor(d["generator"]))
        self.n_simulated = d.get("n_simulated", 0)
        self.calc_state = self.calculator.init_state(self.system)
        self._ready = True

    def restart_simulation(self, d: Dict[str, Any], soft: bool = False):
        self.load_state_dict(d, soft=soft)
