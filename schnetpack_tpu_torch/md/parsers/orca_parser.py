"""Parsers for ORCA quantum-chemistry output files (a copy of
``schnetpack_tpu/md/parsers/orca_parser.py``, host numpy; parity:
``src/schnetpack/md/parsers/orca_parser.py:46-754``).

Two layers:

* a lightweight regex front-end (:class:`OrcaMainFileParser` /
  :class:`OrcaHessianFileParser` / :class:`OrcaParser`) extracting the
  numeric payloads the MD/ML pipeline needs (energy, gradient, dipole,
  charges, hessian, dipole/polarizability derivatives, normal modes);
* a generic line-wise block engine (:class:`OrcaPropertyParser` +
  :class:`OrcaFormatter` + :class:`OrcaBlockOutputParser`) with the full
  property breadth of the reference's ``OrcaPropertyParser`` machinery
  (reference ``orca_parser.py:346-605``): arbitrary start/stop flagged
  blocks, vector/matrix/shielding formatters, polarizability tensors and
  chemical shieldings from the main output, ``ppm2au`` conversion, and
  the derivative reshape helpers ``format_dipole_derivatives`` /
  ``format_polarizability_derivatives``.
"""
from __future__ import annotations

import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

_BOHR = 0.5291772105638411  # Angstrom
_ALPHA = 7.2973525693e-3    # fine-structure constant (CODATA 2018)

#: ppm -> atomic units for chemical shieldings
#: (reference orca_parser.py:35: 2 / (alpha^2 * 1e6))
ppm2au = 2.0 / (_ALPHA**2 * 1e6)


class OrcaParserException(Exception):
    """Raised on malformed ORCA output."""


class OrcaMainFileParser:
    """Extract energy / gradient / dipole / Mulliken charges from the main
    ORCA output file."""

    properties = ["energy", "forces", "dipole_moment", "charges", "positions", "atomic_numbers"]

    def parse_file(self, path: str) -> Dict[str, np.ndarray]:
        with open(path) as f:
            text = f.read()
        out: Dict[str, np.ndarray] = {}

        m = list(re.finditer(r"FINAL SINGLE POINT ENERGY\s+(-?\d+\.\d+)", text))
        if m:
            out["energy"] = np.array(float(m[-1].group(1)))  # Hartree

        # cartesian coordinates block (Angstrom)
        coord = list(
            re.finditer(
                r"CARTESIAN COORDINATES \(ANGSTROEM\)\n-+\n((?:\s*\w+\s+-?\d+\.\d+\s+-?\d+\.\d+\s+-?\d+\.\d+\n)+)",
                text,
            )
        )
        if coord:
            rows = coord[-1].group(1).strip().splitlines()
            from ...datasets.xyz import symbol_to_z

            Z, R = [], []
            for r in rows:
                parts = r.split()
                Z.append(symbol_to_z(parts[0]))
                R.append([float(x) for x in parts[1:4]])
            out["atomic_numbers"] = np.asarray(Z, np.int64)
            out["positions"] = np.asarray(R)

        # cartesian gradient block (Hartree/Bohr)
        grad = list(
            re.finditer(
                r"CARTESIAN GRADIENT\n-+\n\n((?:\s*\d+\s+\w+\s+:\s+-?\d+\.\d+\s+-?\d+\.\d+\s+-?\d+\.\d+\n)+)",
                text,
            )
        )
        if grad:
            rows = grad[-1].group(1).strip().splitlines()
            g = np.array([[float(x) for x in r.split()[3:6]] for r in rows])
            out["forces"] = -g  # Hartree/Bohr

        dip = list(
            re.finditer(
                r"Total Dipole Moment\s+:\s+(-?\d+\.\d+)\s+(-?\d+\.\d+)\s+(-?\d+\.\d+)",
                text,
            )
        )
        if dip:
            out["dipole_moment"] = np.array([float(x) for x in dip[-1].groups()])

        mull = list(
            re.finditer(
                r"MULLIKEN ATOMIC CHARGES\n-+\n((?:\s*\d+\s+\w+\s*:\s+-?\d+\.\d+\n)+)",
                text,
            )
        )
        if mull:
            rows = mull[-1].group(1).strip().splitlines()
            out["charges"] = np.array([float(r.split(":")[1]) for r in rows])
        return out


class OrcaHessianFileParser:
    """Parse ORCA ``.hess`` files: $hessian, $normal_modes,
    $vibrational_frequencies, $dipole_derivatives,
    $polarizability_derivatives."""

    properties = ["hessian", "dipole_derivatives",
                  "polarizability_derivatives", "normal_modes",
                  "vibrational_frequencies"]

    def _parse_matrix(self, lines: List[str], start: int):
        dim = int(lines[start].split()[0])
        # matrices are printed in column blocks of <=5
        mat = np.zeros((dim, dim))
        i = start + 1
        col0 = 0
        while col0 < dim:
            cols = [int(c) for c in lines[i].split()]
            i += 1
            for r in range(dim):
                vals = lines[i].split()
                mat[r, cols[0]: cols[-1] + 1] = [float(v) for v in vals[1:]]
                i += 1
            col0 = cols[-1] + 1
        return mat, i

    def parse_file(self, path: str) -> Dict[str, np.ndarray]:
        with open(path) as f:
            lines = f.read().splitlines()
        out: Dict[str, np.ndarray] = {}
        for i, ln in enumerate(lines):
            tag = ln.strip()
            if tag == "$hessian":
                out["hessian"], _ = self._parse_matrix(lines, i + 1)
            elif tag == "$normal_modes":
                # header is "<dim> <dim>"; the column-block body matches
                # the hessian layout
                out["normal_modes"], _ = self._parse_matrix(lines, i + 1)
            elif tag == "$vibrational_frequencies":
                n = int(lines[i + 1].split()[0])
                out["vibrational_frequencies"] = np.array(
                    [float(lines[i + 2 + r].split()[1]) for r in range(n)]
                )
            elif tag == "$dipole_derivatives":
                n = int(lines[i + 1].split()[0])
                out["dipole_derivatives"] = np.array(
                    [[float(x) for x in lines[i + 2 + r].split()] for r in range(n)]
                )
            elif tag == "$polarizability_derivatives":
                n = int(lines[i + 1].split()[0])
                out["polarizability_derivatives"] = np.array(
                    [[float(x) for x in lines[i + 2 + r].split()] for r in range(n)]
                )
        return out


class OrcaParser:
    """Front-end combining main-file and hessian-file parsing
    (parity: OrcaParser / OrcaOutputParser)."""

    def __init__(self, properties: Optional[List[str]] = None):
        self.main = OrcaMainFileParser()
        self.hess = OrcaHessianFileParser()
        self.properties = properties

    def parse(self, output_file: str) -> Dict[str, np.ndarray]:
        out = self.main.parse_file(output_file)
        hess_file = os.path.splitext(output_file)[0] + ".hess"
        if os.path.exists(hess_file):
            out.update(self.hess.parse_file(hess_file))
        if self.properties:
            out = {k: v for k, v in out.items() if k in self.properties or k in
                   ("positions", "atomic_numbers")}
        return out


# --------------------------------------------------------------------------
# Generic line-wise block engine (reference OrcaPropertyParser machinery,
# orca_parser.py:346-605): start/stop flagged blocks + pluggable formatters.
# --------------------------------------------------------------------------
class OrcaFormatter:
    """Format a raw block of parsed lines into a numpy array.

    Modes (``datatype``):

    * ``"vector"`` — per line, take column ``position`` (or the slice
      ``position:stop``), converted with ``converter``; optional
      ``skip_first`` lines dropped, optional ``unit`` scale, optional
      ``default`` returned when nothing was parsed.
    * ``"matrix"`` — reassemble ORCA's <=6-column block prints of square
      matrices (hessians, hamiltonians).
    * ``"shielding"`` — collect the 3x3 "Total shielding tensor" blocks
      of a CHEMICAL SHIFTS section into [n_atoms, 3, 3].
    """

    def __init__(self, position: int, stop: Optional[int] = None,
                 datatype: str = "vector", converter: type = np.double,
                 skip_first: Optional[int] = None,
                 unit: Optional[float] = None,
                 default: Optional[float] = None):
        self.position = position
        self.stop = stop
        self.datatype = datatype
        self.converter = converter
        self.skip_first = skip_first
        self.unit = unit
        self.default = default

    def format(self, parsed: Optional[List[str]]):
        if parsed is None:
            if self.default is not None:
                return np.array([self.default])
            return None
        if self.skip_first is not None:
            parsed = parsed[self.skip_first:]
        if not parsed:
            return None
        fmt = getattr(self, "_" + self.datatype, None)
        if fmt is None:
            raise NotImplementedError(
                f"unknown formatter datatype {self.datatype!r}")
        out = fmt(parsed)
        if self.unit is not None and out is not None:
            out = out * self.unit
        return out

    def _vector(self, parsed: List[str]):
        rows = []
        for line in parsed:
            cols = line.split()
            if self.stop is None:
                rows.append(self.converter(cols[self.position]))
            else:
                rows.append([self.converter(x)
                             for x in cols[self.position:self.stop]])
        arr = np.array(rows)
        if arr.shape[0] == 1 and arr.size != 1:
            arr = arr[0]
        return arr

    def _matrix(self, parsed: List[str]):
        # ORCA prints square matrices as column blocks: a header line of
        # column indices, then dim rows of "row_idx v v v ..."; blocks
        # repeat until all columns are covered.  Infer dim from the last
        # row index seen.
        dim = 0
        for line in parsed[1:]:
            cols = line.split()
            if len(cols) != len(parsed[1].split()):
                dim = max(dim, int(cols[0]) + 1)
        if dim == 0:
            dim = len(parsed) - 1  # single block
        rows: List[List[float]] = [[] for _ in range(dim)]
        for b0 in range(0, len(parsed), dim + 1):
            block = parsed[b0 + 1: b0 + 1 + dim]
            for r, line in enumerate(block):
                rows[r] += [self.converter(x) for x in line.split()[1:]]
        return np.array(rows)

    def _shielding(self, parsed: List[str]):
        tensors = []
        current: List[List[float]] = []
        reading = False
        for line in parsed:
            if line.startswith("Total shielding tensor (ppm):"):
                reading = True
            elif reading:
                if line.startswith("Diagonalized sT*s matrix:"):
                    tensors.append(current)
                    current = []
                    reading = False
                else:
                    current.append([self.converter(x) for x in line.split()])
        return np.array(tensors)


class OrcaPropertyParser:
    """Collect the lines between a ``start`` flag and any of the ``stop``
    flags, line-wise; ``get_parsed`` applies the formatter(s)."""

    def __init__(self, start: str, stop: Union[str, List[str], None],
                 formatters: Union[OrcaFormatter, Sequence[OrcaFormatter],
                                   None] = None):
        self.start = start
        self.stop = stop
        self.formatters = formatters
        self.read = False
        self.parsed: Optional[List[str]] = None

    def parse_line(self, line: str) -> None:
        line = line.strip()
        if line.startswith("---------") or not line:
            return
        if line.startswith(self.start):
            self.parsed = []
            self.read = True
            if self.stop is None:        # single-line payload
                self.parsed.append(line)
                self.read = False
            return
        if not self.read:
            return
        stops = self.stop if isinstance(self.stop, list) else [self.stop]
        for s in stops:
            if line.startswith(s):
                self.read = False
                return
        self.parsed.append(line)

    def get_parsed(self):
        if self.formatters is None:
            return self.parsed
        if isinstance(self.formatters, (list, tuple)):
            return [f.format(self.parsed) for f in self.formatters]
        return self.formatters.format(self.parsed)

    def reset(self) -> None:
        self.read = False
        self.parsed = None


class OrcaBlockOutputParser:
    """Run a dict of :class:`OrcaPropertyParser` over a file
    (reference ``OrcaOutputParser``)."""

    def __init__(self, parsers: Dict[str, OrcaPropertyParser]):
        self.parsers = parsers
        self.parsed: Optional[Dict[str, object]] = None

    def parse_file(self, path: str) -> None:
        for p in self.parsers.values():
            p.reset()
        with open(path) as f:
            for line in f:
                for p in self.parsers.values():
                    p.parse_line(line)
        self.parsed = {k: p.get_parsed() for k, p in self.parsers.items()}

    def get_parsed(self):
        return self.parsed


#: ORCA main-output block definitions with the reference's full property
#: breadth (reference orca_parser.py:673-700): atoms, energy, forces,
#: dipole, polarizability tensor, chemical shieldings.
MAIN_BLOCKS: Dict[str, dict] = {
    "atoms": dict(
        start="CARTESIAN COORDINATES (ANGSTROEM)",
        stop="CARTESIAN COORDINATES (A.U.)",
        formatters=(
            OrcaFormatter(0, converter=str),
            OrcaFormatter(1, stop=4, unit=1.0 / _BOHR),
        ),
    ),
    "energy": dict(
        start="FINAL SINGLE POINT ENERGY", stop=None,
        formatters=OrcaFormatter(4),
    ),
    "forces": dict(
        start="CARTESIAN GRADIENT",
        stop="Difference to translation invariance",
        formatters=OrcaFormatter(3, stop=6, unit=-1.0),
    ),
    "dipole_moment": dict(
        start="Total Dipole Moment", stop=None,
        formatters=OrcaFormatter(4, stop=7),
    ),
    "polarizability": dict(
        start="The raw cartesian tensor (atomic units):",
        stop="diagonalized tensor:",
        formatters=OrcaFormatter(0, stop=4),
    ),
    "shielding": dict(
        start="CHEMICAL SHIFTS",
        stop="CHEMICAL SHIELDING SUMMARY",
        formatters=OrcaFormatter(0, datatype="shielding", unit=ppm2au),
    ),
}


def make_main_block_parser(
    target_properties: Optional[List[str]] = None,
) -> OrcaBlockOutputParser:
    """Block parser over the main ORCA output with the reference's full
    property set (atoms, energy, forces, dipole_moment, polarizability,
    shielding)."""
    keys = target_properties or list(MAIN_BLOCKS)
    parsers = {}
    for k in keys:
        if k not in MAIN_BLOCKS:
            raise OrcaParserException(f"cannot parse property {k!r}")
        spec = MAIN_BLOCKS[k]
        parsers[k] = OrcaPropertyParser(spec["start"], spec["stop"],
                                        formatters=spec["formatters"])
    return OrcaBlockOutputParser(parsers)


def format_dipole_derivatives(arr: np.ndarray) -> np.ndarray:
    """[3N, 3] raw block -> [N, 3, 3] (atom, displacement, dipole dim)."""
    n = arr.shape[0] // 3
    return arr.reshape(n, 3, 3)


def format_polarizability_derivatives(arr: np.ndarray) -> np.ndarray:
    """[3N, 6] upper-triangle rows -> [N, 3, 3, 3] symmetric tensors."""
    n = arr.shape[0] // 3
    tri = arr.reshape(n, 3, 6)
    iu = np.triu_indices(3)
    out = np.zeros((n, 3, 3, 3))
    out[:, :, iu[0], iu[1]] = tri
    out[:, :, iu[1], iu[0]] = tri
    return out
