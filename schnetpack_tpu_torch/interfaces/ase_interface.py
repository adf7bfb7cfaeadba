"""Inference interfaces: structure conversion, calculators, ASE bridge
(parity: ``schnetpack_tpu/interfaces/ase_interface.py``).

``AtomsConverter`` turns structures into padded model inputs on its
device, ``SpkCalculator`` is an ASE-protocol calculator with unit
conversion and result caching, ``SpkEnsembleCalculator`` the mean and
uncertainty of several models, and ``AseInterface`` drives single points,
relaxation, MD and normal modes.

Everything here works on plain sample dicts (``{_atomic_numbers,
_positions, _cell, _pbc}``); when ``ase`` is importable, ``ase.Atoms``
objects are accepted and ``SpkCalculator`` is a genuine
``ase.calculators.calculator.Calculator`` subclass, else the shim below
implements the same protocol.

The models are the port's ``NeuralNetworkPotential``s on the flat layout:
the converter's host neighbor list (``NeighborListTransform``) and the
bucketed padding of ``data/loader.py``, as in the JAX package, so no
kernel runs.  The calculators and the converter run on the card
(``device="cuda"``) unless the caller asks for the CPU; without a card
they raise.  An ensemble is a list of models (``md/calculators/
schnetpack_calculator.py::EnsembleCalculator``), where the JAX package
vmaps one model over stacked parameters; the results (mean, population
std, uncertainty keys) are the same.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import properties as structure
from ..data.loader import collate, padding_for
from ..transform.neighborlist import NeighborListTransform
from ..units import convert_units

# ASE calculator protocol base (a copy of the JAX package's shim,
# ``ase_interface.py:30-133``)
try:  # pragma: no cover - exercised only when ase is installed
    from ase.calculators.calculator import Calculator as CalculatorBase
    from ase.calculators.calculator import all_changes

    HAS_ASE = True
except ImportError:
    HAS_ASE = False
    all_changes = [
        "positions", "numbers", "cell", "pbc",
        "initial_charges", "initial_magmoms", "charges", "magmoms",
    ]

    def _copy_structure(atoms):
        if isinstance(atoms, dict):
            return {k: np.copy(v) if isinstance(v, np.ndarray) else v
                    for k, v in atoms.items()}
        return atoms.copy()

    def _structure_field(atoms, name):
        if isinstance(atoms, dict):
            keymap = {
                "positions": structure.R, "numbers": structure.Z,
                "cell": structure.cell, "pbc": structure.pbc,
            }
            return np.asarray(atoms.get(keymap[name], 0.0))
        getter = {
            "positions": "get_positions", "numbers": "get_atomic_numbers",
            "cell": "get_cell", "pbc": "get_pbc",
        }[name]
        return np.asarray(getattr(atoms, getter)())

    class CalculatorBase:
        """Stand-in for ``ase.calculators.calculator.Calculator`` matching
        its public protocol (``results``, the ``atoms`` snapshot,
        ``check_state``, ``calculation_required``, ``get_property``)."""

        implemented_properties: List[str] = []

        def __init__(self, restart=None, label=None, atoms=None, **kwargs):
            self.results: Dict[str, np.ndarray] = {}
            self.atoms = None
            self.parameters = dict(kwargs)
            if atoms is not None:
                self.atoms = _copy_structure(atoms)
                try:
                    atoms.calc = self
                except (AttributeError, TypeError):
                    pass

        def reset(self):
            self.results = {}

        def calculate(self, atoms=None, properties=("energy",),
                      system_changes=all_changes):
            if atoms is not None:
                self.atoms = _copy_structure(atoms)

        def check_state(self, atoms, tol: float = 1e-15) -> List[str]:
            if self.atoms is None:
                return list(all_changes)
            changes = []
            for name in ("positions", "numbers", "cell", "pbc"):
                a = _structure_field(self.atoms, name)
                b = _structure_field(atoms, name)
                if a.shape != b.shape or not np.allclose(
                    a.astype(np.float64), b.astype(np.float64), atol=tol
                ):
                    changes.append(name)
            return changes

        def calculation_required(self, atoms, properties) -> bool:
            if self.check_state(atoms):
                return True
            return any(p not in self.results for p in properties)

        def get_property(self, name, atoms=None, allow_calculation=True):
            if atoms is None:
                atoms = self.atoms
            if self.calculation_required(atoms, [name]):
                if not allow_calculation:
                    return None
                self.calculate(atoms, [name], self.check_state(atoms))
            if name not in self.results:
                raise KeyError(
                    f"{name!r} not present in this calculation"
                )
            result = self.results[name]
            if isinstance(result, np.ndarray):
                result = result.copy()
            return result

        def get_potential_energy(self, atoms=None, **kwargs):
            return self.get_property("energy", atoms)

        def get_forces(self, atoms=None, **kwargs):
            return self.get_property("forces", atoms)

        def get_stress(self, atoms=None, **kwargs):
            return self.get_property("stress", atoms)


def _to_sample(atoms) -> Dict[str, np.ndarray]:
    """Accept ase.Atoms or a sample dict."""
    if isinstance(atoms, dict):
        return dict(atoms)
    return {
        structure.Z: np.asarray(atoms.get_atomic_numbers(), np.int64),
        structure.R: np.asarray(atoms.get_positions(), np.float64),
        structure.cell: np.asarray(atoms.get_cell()),
        structure.pbc: np.asarray(atoms.get_pbc(), bool),
    }


def _host_outputs(model, batch) -> Dict[str, np.ndarray]:
    """The model's outputs of ``batch`` as host arrays."""
    with torch.no_grad():
        out = model(batch)
    return {k: v.cpu().numpy() for k, v in out.items() if torch.is_tensor(v)}


def _ready(model, params, device: torch.device):
    """``model`` with ``params`` loaded (where given), frozen, on
    ``device``."""
    if params is not None:
        model.load_state_dict(params)
    return model.requires_grad_(False).to(device)


class AtomsConverter:
    """Structures -> padded batched model inputs on ``device`` (parity:
    ``ase_interface.py:148-187``).  Padding is bucketed (rounded up), as
    in the JAX package, where it keeps jit's cache warm."""

    def __init__(
        self,
        neighbor_list: Optional[NeighborListTransform] = None,
        cutoff: Optional[float] = None,
        transforms: Sequence = (),
        dtype=np.float32,
        atom_bucket: int = 16,
        pair_bucket: int = 256,
        device="cuda",
    ):
        from ..cli import _device

        if neighbor_list is None:
            if cutoff is None:
                raise ValueError("need neighbor_list or cutoff")
            neighbor_list = NeighborListTransform(cutoff)
        self.neighbor_list = neighbor_list
        self.transforms = list(transforms)
        self.dtype = dtype
        self.atom_bucket = atom_bucket
        self.pair_bucket = pair_bucket
        self.device = _device(device)

    def __call__(self, atoms) -> Dict[str, torch.Tensor]:
        if not isinstance(atoms, (list, tuple)):
            atoms = [atoms]
        samples = []
        for a in atoms:
            s = self.neighbor_list(_to_sample(a))
            for t in self.transforms:
                s = t(s)
            samples.append(s)
        spec = padding_for(
            samples, atom_multiple=self.atom_bucket, pair_multiple=self.pair_bucket
        )
        batch = collate(samples, spec, float_dtype=self.dtype)
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}


class AbsoluteUncertainty:
    """std across ensemble members (parity: :340-420)."""

    def __call__(self, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
        return std


class RelativeUncertainty:
    def __call__(self, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
        return std / (np.abs(mean) + 1e-12)


class SpkCalculator(CalculatorBase):
    """Model calculator over single structures (parity:
    ``ase_interface.py:202-300``): a genuine ASE ``Calculator`` subclass
    when ase is importable, else the shim base.

    ``model`` is a port ``NeuralNetworkPotential`` (``params``, a state
    dict, is loaded into it where given); it is frozen and moved to
    ``device``, the card unless the caller asks for the CPU.
    ``energy_unit``/``position_unit`` describe the model's units; results
    are converted to ASE's eV/Ang frame.  An unchanged structure (the same
    positions, numbers and cell) returns the last results without an
    evaluation; ``n_evaluations`` counts the model's calls.
    """

    implemented_properties = ["energy", "forces", "stress"]

    def __init__(
        self,
        model,
        params=None,
        neighbor_list: Optional[NeighborListTransform] = None,
        cutoff: Optional[float] = None,
        energy_key: str = structure.energy,
        force_key: str = structure.forces,
        stress_key: Optional[str] = structure.stress,
        energy_unit: str = "eV",
        position_unit: str = "Ang",
        dtype=np.float32,
        transforms: Sequence = (),
        device="cuda",
        **kwargs,
    ):
        CalculatorBase.__init__(self, **kwargs)
        self.converter = AtomsConverter(
            neighbor_list=neighbor_list, cutoff=cutoff, transforms=transforms,
            dtype=dtype, device=device)
        self.model = _ready(model, params, self.converter.device)
        self.energy_key = energy_key
        self.force_key = force_key
        self.stress_key = stress_key
        self.energy_conversion = convert_units(energy_unit, "eV")
        self.position_conversion = convert_units(position_unit, "Ang")
        self._last_sample_fingerprint = None
        self.n_evaluations = 0

    def _fingerprint(self, sample: Dict[str, np.ndarray]):
        return (
            sample[structure.R].tobytes(),
            sample[structure.Z].tobytes(),
            np.asarray(sample.get(structure.cell, 0)).tobytes(),
        )

    def _apply(self, model, batch) -> Dict[str, np.ndarray]:
        self.n_evaluations += 1
        return _host_outputs(model, batch)

    def calculate(
        self,
        atoms=None,
        properties: Sequence[str] = ("energy",),
        system_changes: Sequence[str] = all_changes,
    ) -> Dict[str, np.ndarray]:
        """ASE-protocol calculate: stores the standard keys in
        ``self.results`` (every model property is computed whatever
        ``properties`` asks for) and returns that dict."""
        if atoms is None:
            atoms = self.atoms
        sample = _to_sample(atoms)
        fp = self._fingerprint(sample)
        if fp == self._last_sample_fingerprint and self.results:
            return self.results
        CalculatorBase.calculate(self, atoms)
        n = len(sample[structure.Z])
        batch = self.converter(sample)
        out = self._apply(self.model, batch)

        results = {}
        e_conv = self.energy_conversion
        f_conv = e_conv / self.position_conversion
        if self.energy_key in out:
            results["energy"] = float(out[self.energy_key][0]) * e_conv
        if self.force_key in out:
            results["forces"] = out[self.force_key][:n] * f_conv
        if self.stress_key and self.stress_key in out:
            results["stress"] = (
                out[self.stress_key][0] * e_conv / self.position_conversion**3
            )
        for extra in (structure.dipole_moment, structure.partial_charges,
                      structure.polarizability):
            if extra in out and extra in getattr(self.model, "model_outputs", []):
                v = out[extra]
                results[extra] = v[:n] if v.shape[:1] == batch[structure.Z].shape[:1] else v[0]
        self.results = results
        self._last_sample_fingerprint = fp
        return results

    # ASE Calculator duck-type surface ----------------------------------
    def get_potential_energy(self, atoms=None, **kwargs) -> float:
        return self.calculate(atoms)["energy"]

    def get_forces(self, atoms=None, **kwargs) -> np.ndarray:
        return self.calculate(atoms)["forces"]

    def get_stress(self, atoms=None, **kwargs) -> np.ndarray:
        return self.calculate(atoms)["stress"]


class SpkEnsembleCalculator(SpkCalculator):
    """Ensemble mean and uncertainty (parity: ``ase_interface.py:
    303-348``): ``models``, one loaded potential per member, each evaluated
    on the same batch; the mean, the population std and each uncertainty
    function's value are those of the JAX package's vmap."""

    def __init__(self, models: Sequence, uncertainty=None, **kwargs):
        super().__init__(models[0], None, **kwargs)
        self.models = [_ready(m, None, self.converter.device)
                       for m in models]
        self.uncertainty_fns = (
            uncertainty if isinstance(uncertainty, (list, tuple))
            else [uncertainty or AbsoluteUncertainty()]
        )

    def calculate(
        self,
        atoms=None,
        properties: Sequence[str] = ("energy",),
        system_changes: Sequence[str] = all_changes,
    ) -> Dict[str, np.ndarray]:
        if atoms is None:
            atoms = self.atoms
        sample = _to_sample(atoms)
        CalculatorBase.calculate(self, atoms)
        n = len(sample[structure.Z])
        batch = self.converter(sample)
        runs = [self._apply(m, batch) for m in self.models]
        results = {}
        e_conv = self.energy_conversion
        f_conv = e_conv / self.position_conversion
        for key, name, conv, idx in (
            (self.energy_key, "energy", e_conv, (slice(None), 0)),
            (self.force_key, "forces", f_conv, (slice(None), slice(0, n))),
        ):
            if key in runs[0]:
                v = np.stack([run[key] for run in runs])[idx] * conv
                mean, std = v.mean(axis=0), v.std(axis=0)
                results[name] = mean if name != "energy" else float(mean)
                for ufn in self.uncertainty_fns:
                    results[f"{name}_uncertainty"] = ufn(mean, std)
        self.results = results
        return results


class AseInterface:
    """High-level driver: single points, optimization, MD, normal modes
    (parity: ``ase_interface.py:351-455``), on the port's batchwise
    optimizer and MD engine, on the calculator's device."""

    def __init__(self, atoms, calculator: SpkCalculator, working_dir: str = "."):
        self.atoms = _to_sample(atoms)
        self.calculator = calculator
        self.working_dir = working_dir

    def calculate_single_point(self) -> Dict[str, np.ndarray]:
        return self.calculator.calculate(self.atoms)

    def optimize(self, fmax: float = 1e-2, steps: int = 200,
                 name: str = "optimization"):
        """Relax the structure; writes into ``working_dir``
        ``<name>.extxyz`` (every iteration with energy and forces),
        ``<name>.log`` (the optimizer's lines) and ``<name>_final.extxyz``
        (the relaxed geometry)."""
        import os

        from ..datasets.xyz import write_extxyz
        from .batchwise import BatchwiseCalculator, batchwise_lbfgs

        bc = BatchwiseCalculator(
            self.calculator.model, None, converter=self.calculator.converter,
            energy_key=self.calculator.energy_key,
            force_key=self.calculator.force_key,
        )
        os.makedirs(self.working_dir, exist_ok=True)
        traj = os.path.join(self.working_dir, f"{name}.extxyz")
        log = os.path.join(self.working_dir, f"{name}.log")
        relaxed, info = batchwise_lbfgs(
            bc, [self.atoms], fmax=fmax, maxstep_total=steps,
            trajectory=traj, logfile=log,
        )
        self.atoms = relaxed[0]
        res = self.calculator.calculate(self.atoms)
        cell = np.asarray(self.atoms.get(structure.cell, np.zeros((3, 3))))
        write_extxyz(
            os.path.join(self.working_dir, f"{name}_final.extxyz"),
            [{
                "numbers": np.asarray(self.atoms[structure.Z]),
                "positions": np.asarray(self.atoms[structure.R]),
                "cell": cell if np.any(cell) else None,
                "energy": float(np.asarray(res["energy"]).ravel()[0]),
                "forces": np.asarray(res["forces"]),
            }],
        )
        return info

    def run_md(self, n_steps: int, temperature: float = 300.0,
               time_step: float = 0.5, thermostat_time: float = 100.0):
        """Langevin MD of the structure on the calculator's device (the
        all-pairs list); the momenta and the thermostat draw from
        ``torch.Generator``s seeded with 0, where the JAX package uses
        ``PRNGKey(0)``."""
        from ..md import (
            MaxwellBoltzmannInit, Simulator, VelocityVerlet, load_molecules,
        )
        from ..md.calculators import SchNetPackCalculator
        from ..md.simulation_hooks import LangevinThermostat
        from ..units import md_units

        device = self.calculator.converter.device
        system = load_molecules([self.atoms], device=device)
        system = MaxwellBoltzmannInit(temperature).initialize_system(
            system, torch.Generator().manual_seed(0))
        calc = SchNetPackCalculator(
            self.calculator.model,
            cutoff=self.calculator.converter.neighbor_list.cutoff,
        )
        sim = Simulator(
            system, VelocityVerlet(time_step), calc,
            simulator_hooks=[LangevinThermostat(temperature, thermostat_time)],
            seed=0, progress=False,
        )
        sim.simulate(n_steps)
        pos = sim.system.positions[0].double().cpu().numpy()
        self.atoms[structure.R] = pos / md_units().length
        return sim

    def compute_normal_modes(self, delta: float = 0.01):
        """Finite-difference Hessian -> harmonic frequencies (cm^-1)."""
        from ..transform.atomistic import ATOMIC_MASSES
        from ..units import hbar, invcm

        R0 = np.asarray(self.atoms[structure.R], np.float64)
        n = len(R0)
        H = np.zeros((3 * n, 3 * n))
        for a in range(n):
            for d in range(3):
                Rp, Rm = R0.copy(), R0.copy()
                Rp[a, d] += delta
                Rm[a, d] -= delta
                fp = self.calculator.calculate({**self.atoms, structure.R: Rp})["forces"]
                fm = self.calculator.calculate({**self.atoms, structure.R: Rm})["forces"]
                H[3 * a + d] = -(fp - fm).reshape(-1) / (2 * delta)
        H = 0.5 * (H + H.T)
        m = ATOMIC_MASSES[np.asarray(self.atoms[structure.Z])]
        minv = 1.0 / np.sqrt(np.repeat(m, 3))
        Hw = H * minv[:, None] * minv[None, :]
        w2 = np.linalg.eigvalsh(Hw)
        # omega in ASE units -> cm^-1
        freqs = np.sign(w2) * np.sqrt(np.abs(w2)) * hbar / invcm
        return freqs
