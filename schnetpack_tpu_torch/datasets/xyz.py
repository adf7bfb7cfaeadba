"""Minimal (ext)xyz reading and writing without ase (a copy of
``schnetpack_tpu/datasets/xyz.py``)."""
from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional

import numpy as np

_SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
    "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn",
    "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb",
    "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In",
    "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm",
    "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta",
    "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At",
    "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk",
    "Cf", "Es", "Fm", "Md", "No", "Lr",
]
_Z = {s: i for i, s in enumerate(_SYMBOLS)}


def symbol_to_z(symbol: str) -> int:
    return _Z[symbol]


def parse_extxyz_blocks(text: str) -> Iterator[Dict]:
    """Yield dicts with numbers/positions/comment (+cell if a Lattice=... is
    present) for every frame in a concatenated xyz file."""
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        n = int(line)
        comment = lines[i + 1] if i + 1 < len(lines) else ""
        Z, R = [], []
        for ln in lines[i + 2: i + 2 + n]:
            parts = ln.split()
            sym = parts[0]
            Z.append(_Z[sym] if not sym.isdigit() else int(sym))
            R.append([float(x.replace("*^", "e")) for x in parts[1:4]])
        block = {
            "numbers": np.asarray(Z, np.int64),
            "positions": np.asarray(R),
            "comment": comment,
        }
        m = re.search(r'Lattice="([^"]+)"', comment)
        if m:
            vals = [float(x) for x in m.group(1).split()]
            block["cell"] = np.asarray(vals).reshape(3, 3)
        yield block
        i += 2 + n


def read_extxyz_file(path: str) -> List[Dict]:
    with open(path) as f:
        return list(parse_extxyz_blocks(f.read()))


def z_to_symbol(z: int) -> str:
    return _SYMBOLS[int(z)]


def format_extxyz_frame(numbers, positions, cell=None, energy=None,
                        forces=None, comment_extra: str = "") -> str:
    """One ASE-compatible extxyz frame (text).  Energies/forces land in
    the standard ``energy=`` comment field and per-atom ``forces``
    columns so ``ase.io.read`` reconstructs them as a calculator."""
    numbers = np.asarray(numbers)
    positions = np.asarray(positions, np.float64)
    n = len(numbers)
    props = "species:S:1:pos:R:3"
    if forces is not None:
        forces = np.asarray(forces, np.float64)
        props += ":forces:R:3"
    fields = [f'Properties={props}']
    if cell is not None and np.any(np.asarray(cell)):
        flat = " ".join(f"{v:.10f}" for v in np.asarray(cell).ravel())
        fields.insert(0, f'Lattice="{flat}"')
        fields.append("pbc=\"T T T\"")
    if energy is not None:
        fields.append(f"energy={float(energy):.10f}")
    if comment_extra:
        fields.append(comment_extra)
    lines = [str(n), " ".join(fields)]
    for i in range(n):
        row = f"{_SYMBOLS[int(numbers[i])]:2s} " + " ".join(
            f"{v: .10f}" for v in positions[i]
        )
        if forces is not None:
            row += " " + " ".join(f"{v: .10f}" for v in forces[i])
        lines.append(row)
    return "\n".join(lines) + "\n"


def write_extxyz(path: str, frames: List[Dict], append: bool = False) -> None:
    """Write frames (dicts with numbers/positions and optional
    cell/energy/forces) as a concatenated extxyz trajectory."""
    mode = "a" if append else "w"
    with open(path, mode) as f:
        for fr in frames:
            f.write(format_extxyz_frame(
                fr["numbers"], fr["positions"], fr.get("cell"),
                fr.get("energy"), fr.get("forces"),
            ))
