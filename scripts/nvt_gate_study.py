"""Where the NVT gates of ``chip_smoke.py`` phase 7 fall, on the CPU.

Runs the port's thermostats on the Lennard-Jones argon crystal (the
potential whose labels trained ``bench_painn_argon.msgpack``: r_min
3.82 A, well 0.0103 eV, 8 A cutoff) in float64: a 500-atom FCC box,
Maxwell-Boltzmann momenta at 30 K, 0.5 fs, bath 30 K, time constant 20
fs, and prints the mean temperature of every 100-step window of

* ``LangevinThermostat`` for 300 steps from the cold lattice,
* ``NHCThermostat`` for 1000 steps from the cold lattice,
* ``NHCThermostat`` for 300 steps from the Langevin run's last state,
  with the drift of its conserved extended energy (``ExtendedEnergy``
  at every 25-step chunk's end, eV per atom),
* NVE (no thermostat) for 300 steps from that same state, the control
  that the NHC gate holds the chain against,

for two seeds.  Run from the repository root (a few minutes on 4 cores):

    python3 scripts/nvt_gate_study.py
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import ExtendedEnergy, fcc_box, molecule  # noqa: E402
from schnetpack_tpu_torch.md import (  # noqa: E402
    MaxwellBoltzmannInit, Simulator, VelocityVerlet, load_molecules,
)
from schnetpack_tpu_torch.md.calculators import LJCalculator  # noqa: E402
from schnetpack_tpu_torch.md.simulation_hooks import (  # noqa: E402
    LangevinThermostat, NHCThermostat,
)


def run(system, hook, steps, seed):
    """(final system, mean T per 100 steps, extended-energy drift in eV
    per atom or None); ``hook`` None runs NVE."""
    calc = LJCalculator(3.82, 0.0103, 8.0)
    hooks = [] if hook is None else [hook(30.0, time_constant=20.0)]
    ext = ExtendedEnergy(hooks[0]) if hook is NHCThermostat else None
    sim = Simulator(system, VelocityVerlet(0.5), calc,
                    simulator_hooks=hooks + ([ext] if ext else []),
                    seed=seed)
    sim.simulate(steps, chunk_size=25)
    T = np.concatenate([lg["temperature"][:, 0, 0] for lg in sim.logs])
    drift = None
    if ext is not None:
        H = np.asarray(ext.values) / calc.energy_conversion
        drift = float(np.abs(H - H[0]).max()) / system.total_atoms
    return sim.system, [round(float(T[i:i + 100].mean()), 2)
                        for i in range(0, steps, 100)], drift


def main():
    torch.set_num_threads(4)
    pos, cell = fcc_box(500)
    for seed in (0, 1):
        cold = MaxwellBoltzmannInit(30.0).initialize_system(
            load_molecules([molecule(pos, cell)], dtype=torch.float64,
                           device="cpu"),
            torch.Generator().manual_seed(seed + 1))
        warm, T, _ = run(cold, LangevinThermostat, 300, seed)
        print(f"seed {seed}: Langevin from the lattice, mean T per 100 "
              f"steps {T}")
        _, T, drift = run(cold, NHCThermostat, 1000, seed)
        print(f"seed {seed}: NHC from the lattice {T}, extended-energy "
              f"drift {drift:.3e} eV/atom")
        _, T, drift = run(warm, NHCThermostat, 300, seed)
        print(f"seed {seed}: NHC after the Langevin run {T}, "
              f"extended-energy drift {drift:.3e} eV/atom")
        _, T, _ = run(warm, None, 300, seed)
        print(f"seed {seed}: NVE after the Langevin run {T}", flush=True)


if __name__ == "__main__":
    main()
