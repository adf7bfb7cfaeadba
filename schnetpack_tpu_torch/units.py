"""
Unit system.

The reference framework (schnetpack ``src/schnetpack/units.py``) derives its
units from ``ase.units`` and defines an internal MD unit frame based on
kJ/mol, nm, Dalton and elementary charge.  ``ase`` is not a runtime
dependency here, so this module re-derives the same unit algebra directly
from CODATA 2014 constants (the defaults used by ase), giving numerically
identical conversion factors.

Two frames exist:

* the **ASE frame** (eV, Angstrom, Dalton, e) used by datasets and models;
* the **MD frame** (kJ/mol, nm, Dalton, e) used by the MD engine.

``convert_units(src, tgt)`` converts between arbitrary unit strings or
floats, e.g. ``convert_units("kcal/mol/Angstrom", "eV/Ang")``.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Union

# ---------------------------------------------------------------------------
# CODATA 2014 fundamental constants (SI) — the ase.units defaults
# ---------------------------------------------------------------------------
_c = 299792458.0  # speed of light, m/s
_mu0 = 4.0e-7 * math.pi  # vacuum permeability
_Grav = 6.67408e-11
_hplanck = 6.626070040e-34  # Planck constant, J s
_e = 1.6021766208e-19  # elementary charge, C
_me = 9.10938356e-31  # electron mass, kg
_mp = 1.672621898e-27  # proton mass, kg
_Nav = 6.022140857e23  # Avogadro number
_k = 1.38064852e-23  # Boltzmann constant, J/K
_amu = 1.660539040e-27  # atomic mass unit, kg

_eps0 = 1.0 / _mu0 / _c**2
_hbar_si = _hplanck / (2.0 * math.pi)

# ---------------------------------------------------------------------------
# ASE-frame unit values: energies in eV, distances in Angstrom,
# masses in Dalton, charges in e, time in Angstrom*sqrt(Dalton/eV).
# ---------------------------------------------------------------------------
Ang = Angstrom = 1.0
nm = 10.0
Bohr = 4.0e10 * math.pi * _eps0 * _hbar_si**2 / _me / _e**2

eV = 1.0
Hartree = Ha = _me * _e**3 / 16.0 / math.pi**2 / _eps0**2 / _hbar_si**2
Rydberg = Ry = 0.5 * Hartree
kJ = 1000.0 / _e
kcal = 4.184 * kJ
mol = _Nav
mJ = kJ * 1e-6
J = 1.0 / _e

Dalton = u = 1.0
kg = 1.0 / _amu

second = s = 1.0e10 * math.sqrt(_e / _amu)
fs = 1e-15 * second
ps = 1e-12 * second
ns = 1e-9 * second
aut = _hbar_si / (Hartree * _e) * second  # atomic unit of time

Coulomb = C = 1.0 / _e
e = elementary_charge = 1.0

Kelvin = K = 1.0
kB = _k / _e  # eV / K

Pascal = Pa = (1.0 / _e) / 1e30  # eV / Ang^3
GPa = 1e9 * Pascal
bar = 1e5 * Pascal

Debye = D = 1.0 / 1e11 / _e / _c  # e*Ang

alpha = _e**2 / (4.0 * math.pi * _eps0) / _hbar_si / _c  # fine structure constant
invcm = 100.0 * _c * _hplanck / _e  # cm^-1 photon energy in eV

#: hbar in ASE units (eV * ASE-time)
hbar = _hbar_si * J * s
#: Coulomb constant ke = 1/(4 pi eps0) in eV * Ang / e^2
ke = _e / (4.0 * math.pi * _eps0) * 1e10


_UNIT_TABLE: Dict[str, float] = {
    "Ang": Ang, "Angstrom": Ang, "A": Ang, "angstrom": Ang,
    "nm": nm, "Bohr": Bohr, "a0": Bohr, "bohr": Bohr,
    "m": 1e10, "cm": 1e8, "meter": 1e10,
    "eV": eV, "meV": 1e-3 * eV, "Hartree": Hartree, "Ha": Hartree,
    "hartree": Hartree, "Rydberg": Rydberg, "Ry": Rydberg,
    "kJ": kJ, "kcal": kcal, "J": J, "mJ": mJ,
    "mol": mol, "fs": fs, "ps": ps, "ns": ns, "s": s, "second": s,
    "aut": aut,
    "Dalton": Dalton, "u": u, "amu": Dalton, "kg": kg, "g": 1e-3 * kg,
    "e": e, "C": Coulomb, "Coulomb": Coulomb,
    "Debye": Debye, "D": Debye,
    "K": Kelvin, "Kelvin": Kelvin,
    "Pa": Pascal, "Pascal": Pascal, "GPa": GPa, "MPa": 1e6 * Pascal,
    "bar": bar, "kbar": 1e3 * bar, "atm": 101325.0 * Pascal,
    "None": 1.0, "none": 1.0, "1": 1.0, "": 1.0, "dimensionless": 1.0,
}


def _parse_unit(unit: Union[str, float]) -> float:
    """Parse a unit string like ``kcal/mol/Angstrom`` or ``eV*Ang**2``."""
    if not isinstance(unit, str):
        return float(unit)
    unit = unit.strip()
    if not unit:
        return 1.0
    # tokenize into (op, name, power)
    value = 1.0
    # split keeping the operators; normalize ** to ^ first so it survives the split
    parts = re.split(r"([*/])", unit.replace(" ", "").replace("**", "^"))
    op = "*"
    for part in parts:
        if part in ("*", "/"):
            op = part
            continue
        if not part:
            continue
        m = re.fullmatch(r"([A-Za-z0-9_]+?)(?:\^|\*\*)?(-?\d+)?", part)
        if m is None:
            raise ValueError(f"Cannot parse unit token {part!r} in {unit!r}")
        name, power = m.group(1), m.group(2)
        if name not in _UNIT_TABLE:
            raise ValueError(f"Unknown unit {name!r} in {unit!r}")
        factor = _UNIT_TABLE[name] ** (int(power) if power else 1)
        value = value * factor if op == "*" else value / factor
    return value


def unit2internal(unit: Union[str, float]) -> float:
    """Value of ``unit`` expressed in the ASE frame (eV / Ang / Dalton / e)."""
    return _parse_unit(unit)


def convert_units(src: Union[str, float], tgt: Union[str, float]) -> float:
    """Conversion factor taking a quantity in ``src`` units to ``tgt`` units."""
    return _parse_unit(src) / _parse_unit(tgt)


# ---------------------------------------------------------------------------
# MD internal unit frame: kJ/mol, nm, Dalton, e (reference units.py:11-16).
# setup_md_units derives time/force/stress/pressure units plus physical
# constants expressed in that frame (reference units.py:19-91).
# ---------------------------------------------------------------------------
class MDUnits:
    """Container for the internal MD unit frame (module-level singleton)."""

    def __init__(
        self,
        energy_unit: Union[str, float] = "kJ/mol",
        length_unit: Union[str, float] = "nm",
        mass_unit: Union[str, float] = "Dalton",
        charge_unit: Union[str, float] = "e",
    ):
        # conversion factors: one ASE-frame unit expressed in MD-internal units
        self.energy = 1.0 / _parse_unit(energy_unit)   # eV -> internal
        self.length = 1.0 / _parse_unit(length_unit)   # Ang -> internal
        self.mass = 1.0 / _parse_unit(mass_unit)       # Dalton -> internal
        self.charge = 1.0 / _parse_unit(charge_unit)   # e -> internal

        # derived
        self.time = math.sqrt(self.mass * self.length**2 / self.energy)
        self.force = self.energy / self.length
        self.stress = self.energy / self.length**3
        self.pressure = self.stress

        # constants in internal units
        self.kB = kB * self.energy                  # per Kelvin
        self.hbar = hbar * self.energy * self.time
        self.ke = ke * self.energy * self.length / self.charge**2
        # conversion: internal angular frequency -> wavenumber cm^-1
        # (omega_int * hbar_int = E_int; E_int / (1 cm^-1 photon energy in
        # internal units) = wavenumber in cm^-1)
        self.hbar2icm = self.hbar / (self.energy * invcm)

    def unit2internal(self, unit: Union[str, float]) -> float:
        """Convert a unit (string or float, in the ASE frame) to internal units."""
        v = _parse_unit(unit)
        # determine dimension heuristically is impossible for floats; callers
        # pass strings for dimensioned quantities. We express the ASE-frame
        # value in internal units by dimension lookup below.
        return v

    def convert(self, value: float, src: str, dimension: str) -> float:
        """Convert ``value`` in ``src`` units to internal units of ``dimension``
        (one of energy/length/mass/charge/time/force/stress)."""
        ase_val = value * _parse_unit(src)
        return ase_val * getattr(self, dimension)


_md_units = MDUnits()


def setup_md_units(
    energy_unit: Union[str, float] = "kJ/mol",
    length_unit: Union[str, float] = "nm",
    mass_unit: Union[str, float] = "Dalton",
    charge_unit: Union[str, float] = "e",
) -> MDUnits:
    """(Re)initialize the global MD unit frame; returns the singleton."""
    global _md_units
    _md_units = MDUnits(energy_unit, length_unit, mass_unit, charge_unit)
    return _md_units


def md_units() -> MDUnits:
    return _md_units
