"""Thermostat helpers (parity: ``schnetpack_tpu/md/utils/
thermostat_utils.py``): Yoshida-Suzuki weights and the i-PI/gle4md GLE
matrix files, plain numpy on the host."""
from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np

from ...units import _parse_unit, md_units


def ys_weights(order: int) -> np.ndarray:
    """Yoshida-Suzuki multi-timestep weights."""
    if order == 1:
        return np.array([1.0])
    if order == 3:
        w1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
        return np.array([w1, 1.0 - 2.0 * w1, w1])
    if order == 5:
        w1 = 1.0 / (4.0 - 4.0 ** (1.0 / 3.0))
        return np.array([w1, w1, 1.0 - 4.0 * w1, w1, w1])
    if order == 7:
        w = np.array([0.784513610477560, 0.235573213359357,
                      -1.17767998417887, 0.0, -1.17767998417887,
                      0.235573213359357, 0.784513610477560])
        w[3] = 1.0 - w.sum() + w[3]
        return w
    raise ValueError(f"Unsupported Yoshida-Suzuki order {order}")


class YSWeights:
    def __init__(self, order: int = 3):
        self.weights = ys_weights(order)


_UNIT_TIME = {"femtoseconds": "fs", "picoseconds": "ps", "seconds": "s",
              "atomic time units": "aut"}
_UNIT_ENERGY = {"ev": "eV", "atomic energy units": "Ha", "hartree": "Ha",
                "kelvin": None, "k": None}


def load_gle_matrices(
        filename: str) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Parse an i-PI/gle4md GLE input file into stacked (A, C) matrices
    [n_sections, s, s] in MD units: one section for a GLE file, one per
    normal mode for a PIGLET file (sections after ``# Matrix for normal
    mode <k>`` markers).  A is a drift (inverse time), C a covariance
    (energy or Kelvin).  Data rows may or may not start with '#'."""
    a_secs: list = []
    c_secs: list = []
    current: Optional[str] = None
    rows: list = []
    unit_factor = 1.0

    def finalize():
        nonlocal rows
        if rows:
            (a_secs if current == "A" else c_secs).append(
                np.asarray(rows) * unit_factor)
        rows = []

    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            header = re.match(r"#\s*([AC])\s+MATRIX:?\s*\(?([^)]*)\)?", line)
            if header:
                if current is not None:
                    finalize()
                current = header.group(1)
                unit = header.group(2).strip()
                unit_factor = 1.0
                if current == "A" and unit:
                    m = re.match(r"(.+)\^-1", unit)
                    name = m.group(1).strip() if m else unit
                    if name in _UNIT_TIME:
                        unit_factor = 1.0 / (_parse_unit(_UNIT_TIME[name])
                                             * md_units().time)
                elif current == "C" and unit:
                    low = unit.lower()
                    if low in ("k", "kelvin"):
                        unit_factor = md_units().kB
                    elif low in _UNIT_ENERGY and _UNIT_ENERGY[low]:
                        unit_factor = (_parse_unit(_UNIT_ENERGY[low])
                                       * md_units().energy)
                continue
            if current is not None and "matrix for normal mode" in line.lower():
                finalize()
                continue
            body = line.lstrip("#").strip()
            if current and body and not body.startswith("#"):
                try:
                    rows.append([float(x) for x in body.split()])
                except ValueError:
                    continue
    if current is not None:
        finalize()
    a_mat = np.stack(a_secs) if a_secs else None
    c_mat = np.stack(c_secs) if c_secs else None
    return a_mat, c_mat


class GLEMatrixParser:
    """The reference's class name for ``load_gle_matrices``."""

    def __init__(self, filename: str):
        self.a_matrix, self.c_matrix = load_gle_matrices(filename)
