"""ORCA ab-initio calculator for (QM/ML) MD (parity:
``schnetpack_tpu/md/calculators/orca.py``).

Writes one ORCA input file per molecule and replica (the JAX package's
``.inp`` files, byte for byte), runs the orca executable on each in
``working_dir``, parses the energy (Hartree) and the gradient
(Hartree/Bohr) back and returns them in MD units on the system's device.
Host-side by construction (the QM code is an outside program): the
port's step loop calls it eagerly, every step.  The JAX ``Simulator``
runs its steps as one jitted scan, through which ``calculate``'s
``np.asarray`` of the positions cannot pass (ROADMAP Queue 3).
"""
from __future__ import annotations

import os
import subprocess
from typing import Dict

import numpy as np
import torch

from ...datasets.xyz import _SYMBOLS
from ...units import _parse_unit, md_units
from ..parsers.orca_parser import OrcaParser
from ..system import System
from .base import MDCalculator


class OrcaCalculator(MDCalculator):
    is_host_calculator = True

    def __init__(
        self,
        orca_path: str = "orca",
        basis_set: str = "def2-SVP",
        functional: str = "PBE",
        additional_keywords: str = "ENGRAD",
        working_dir: str = "orca_scratch",
        n_procs: int = 1,
        **kwargs,
    ):
        kwargs.setdefault("energy_unit", "Ha")
        kwargs.setdefault("position_unit", "Ang")
        super().__init__(**kwargs)
        # ORCA gradients come back in Hartree/Bohr
        self.force_conversion = (
            _parse_unit("Ha") * md_units().energy
        ) / (_parse_unit("Bohr") * md_units().length)
        self.orca_path = orca_path
        self.basis_set = basis_set
        self.functional = functional
        self.additional_keywords = additional_keywords
        self.working_dir = working_dir
        self.n_procs = n_procs
        self.parser = OrcaParser()
        os.makedirs(working_dir, exist_ok=True)

    def _write_input(self, Z: np.ndarray, R: np.ndarray, tag: str) -> str:
        path = os.path.join(self.working_dir, f"{tag}.inp")
        with open(path, "w") as f:
            f.write(f"! {self.functional} {self.basis_set} {self.additional_keywords}\n")
            if self.n_procs > 1:
                f.write(f"%pal nprocs {self.n_procs} end\n")
            f.write("* xyz 0 1\n")
            for z, r in zip(Z, R):
                f.write(f"{_SYMBOLS[int(z)]} {r[0]:.10f} {r[1]:.10f} {r[2]:.10f}\n")
            f.write("*\n")
        return path

    def _run_orca(self, input_file: str) -> Dict[str, np.ndarray]:
        out_file = os.path.splitext(input_file)[0] + ".out"
        with open(out_file, "w") as f:
            subprocess.run(
                [self.orca_path, input_file], stdout=f,
                stderr=subprocess.STDOUT, check=True, timeout=86400,
            )
        return self.parser.parse(out_file)

    def calculate(self, system: System, calc_state=None) -> System:
        """Evaluate every molecule x replica with ORCA (host side)."""
        R_, A, M = system.n_replicas, system.total_atoms, system.n_molecules
        # -> Ang, in the positions' own precision, as the JAX calculator
        # divides them (its .inp files are these numbers' digits)
        pos = system.positions.detach().cpu().numpy() / self.position_conversion
        Z = system.atomic_numbers.cpu().numpy()
        idx_m = system.idx_m.cpu().numpy()

        energies = np.zeros((R_, M))
        forces = np.zeros((R_, A, 3))
        for r in range(R_):
            for m in range(M):
                sel = idx_m == m
                results = self._run_orca(
                    self._write_input(Z[sel], pos[r, sel], f"mol_{r}_{m}")
                )
                energies[r, m] = float(results["energy"])
                forces[r, sel] = results["forces"]

        dev = system.positions.device
        return system.replace(
            energy=torch.as_tensor(energies * self.energy_conversion,
                                   dtype=system.energy.dtype, device=dev),
            forces=torch.as_tensor(forces * self.force_conversion,
                                   dtype=system.forces.dtype, device=dev),
        )
