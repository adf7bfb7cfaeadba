"""Simulation hooks (parity: ``schnetpack_tpu/md/simulation_hooks/
basic_hooks.py``).

A device hook is a state transformer ``apply(state, system, generator,
dt) -> (state, system)`` on the system's device, which the simulator
calls before each step's first half step and, in reverse order, after
its last; ``init_state(system, dt)`` makes its state.  A host hook
(``SimulationHook``) sees the simulator between chunks.
"""
from __future__ import annotations

import torch

from ..system import System


class DeviceHook:
    """Base of device hooks; its state is a call counter."""

    def init_state(self, system: System, dt: float):
        return 0

    def apply(self, state, system: System, generator: torch.Generator,
              dt: float):
        raise NotImplementedError


class _EveryNSteps(DeviceHook):
    """Applies ``_do`` on every ``2 * every_n_steps``-th call (hooks run
    twice a step), the first call included."""

    def __init__(self, every_n_steps: int):
        self.every_n_calls = max(2 * every_n_steps, 1)

    def _do(self, system: System) -> System:
        raise NotImplementedError

    def apply(self, state, system, generator, dt):
        if state % self.every_n_calls == 0:
            system = self._do(system)
        return state + 1, system


class RemoveCOMMotion(_EveryNSteps):
    """Zero every molecule's total momentum every ``every_n_steps`` steps."""

    def __init__(self, every_n_steps: int = 100):
        super().__init__(every_n_steps)

    def _do(self, system):
        return system.remove_com_motion()


class WrapPositions(_EveryNSteps):
    def __init__(self, every_n_steps: int = 1):
        super().__init__(every_n_steps)

    def _do(self, system):
        return system.wrap_positions()


class SimulationHook:
    """Host hook interface (parity: ``basic_hooks.py:14-38``)."""

    def on_simulation_start(self, simulator):
        pass

    def process_chunk(self, simulator, logs, start_step: int):
        pass

    def on_simulation_end(self, simulator):
        pass
