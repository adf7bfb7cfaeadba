"""Datasets over ASE-compatible SQLite databases, without ase (a copy of
``schnetpack_tpu/data/atoms.py``).

The on-disk format is ASE DB version 9, as the JAX package writes it: a
``systems`` table with little-endian array blobs and a binary-JSON
``data`` column, and the metadata JSON in the ``information`` table.  A
database that either package writes, the other reads; the rows carry the
same ``username`` (``schnetpack_tpu``), so that the two write the same
content.
"""
from __future__ import annotations

import json
import os
import sqlite3
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import properties as structure
from ..units import convert_units

# ---------------------------------------------------------------------------
# ASE binary-JSON object encoding (db version >= 9)
# ---------------------------------------------------------------------------


def _o2b(obj: Any, parts: List[bytes]):
    if isinstance(obj, (bool, int, float, str, type(None))):
        return obj
    if isinstance(obj, dict):
        return {k: _o2b(v, parts) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_o2b(v, parts) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        offset = sum(len(p) for p in parts)
        if not np.little_endian:
            obj = obj.byteswap()
        parts.append(obj.tobytes())
        return {"__ndarray__": [list(obj.shape), obj.dtype.name, offset]}
    if isinstance(obj, complex):
        return {"__complex__": [obj.real, obj.imag]}
    raise ValueError(f"Cannot encode {type(obj)}")


def object_to_bytes(obj: Any) -> bytes:
    parts = [b"12345678"]
    encoded = _o2b(obj, parts)
    offset = sum(len(p) for p in parts)
    parts[0] = np.array(offset, np.int64).tobytes()
    parts.append(json.dumps(encoded).encode())
    return b"".join(parts)


def _b2o(obj: Any, buf: bytes):
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            shape, dtype, offset = obj["__ndarray__"]
            count = int(np.prod(shape)) if shape else 1
            a = np.frombuffer(buf, dtype=dtype, count=count, offset=offset)
            a = a.reshape(shape)
            if not np.little_endian:
                a = a.byteswap()
            return a
        if "__complex__" in obj:
            re, im = obj["__complex__"]
            return complex(re, im)
        return {k: _b2o(v, buf) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_b2o(v, buf) for v in obj]
    return obj


def bytes_to_object(buf: bytes) -> Any:
    offset = int(np.frombuffer(buf[:8], np.int64)[0])
    obj = json.loads(buf[offset:].decode())
    return _b2o(obj, buf)


def _blob(a: Optional[np.ndarray]) -> Optional[bytes]:
    if a is None:
        return None
    a = np.ascontiguousarray(a)
    if not np.little_endian:
        a = a.byteswap()
    return a.tobytes()


def _deblob(buf: Optional[bytes], dtype, shape) -> Optional[np.ndarray]:
    if buf is None:
        return None
    a = np.frombuffer(buf, dtype).copy()
    if not np.little_endian:
        a = a.byteswap()
    return a.reshape(shape)


_INIT_SQL = [
    """CREATE TABLE IF NOT EXISTS systems (
    id INTEGER PRIMARY KEY AUTOINCREMENT, unique_id TEXT UNIQUE,
    ctime REAL, mtime REAL, username TEXT,
    numbers BLOB, positions BLOB, cell BLOB, pbc INTEGER,
    initial_magmoms BLOB, initial_charges BLOB, masses BLOB, tags BLOB,
    momenta BLOB, constraints TEXT, calculator TEXT, calculator_parameters TEXT,
    energy REAL, free_energy REAL, forces BLOB, stress BLOB, dipole BLOB,
    magmoms BLOB, magmom REAL, charges BLOB,
    key_value_pairs TEXT, data BLOB, natoms INTEGER,
    fmax REAL, smax REAL, volume REAL, mass REAL, charge REAL)""",
    "CREATE TABLE IF NOT EXISTS species (Z INTEGER, n INTEGER, id INTEGER, FOREIGN KEY (id) REFERENCES systems(id))",
    "CREATE TABLE IF NOT EXISTS keys (key TEXT, id INTEGER, FOREIGN KEY (id) REFERENCES systems(id))",
    "CREATE TABLE IF NOT EXISTS text_key_values (key TEXT, value TEXT, id INTEGER, FOREIGN KEY (id) REFERENCES systems(id))",
    "CREATE TABLE IF NOT EXISTS number_key_values (key TEXT, value REAL, id INTEGER, FOREIGN KEY (id) REFERENCES systems(id))",
    "CREATE TABLE IF NOT EXISTS information (name TEXT, value TEXT)",
]


class ASEAtomsData:
    """Dataset of molecules/materials stored in an ASE SQLite DB.

    ``__getitem__`` returns the flat sample dict (numpy) after applying the
    per-sample ``transforms`` pipeline — identical contract to the
    reference (``data/atoms.py:266-280``).
    """

    def __init__(
        self,
        datapath: str,
        transforms: Sequence = (),
        load_properties: Optional[Sequence[str]] = None,
        distance_unit: Optional[str] = None,
        property_units: Optional[Dict[str, str]] = None,
        subset_idx: Optional[Sequence[int]] = None,
    ):
        self.datapath = datapath
        self.transforms = list(transforms)
        self.load_properties = list(load_properties) if load_properties else None
        self._conn: Optional[sqlite3.Connection] = None
        self.subset_idx = list(subset_idx) if subset_idx is not None else None

        md = self.metadata
        self._property_units_src: Dict[str, str] = md.get("_property_unit_dict", {})
        self._distance_unit_src: Optional[str] = md.get("_distance_unit")
        self.atomrefs: Dict[str, np.ndarray] = {
            k: np.asarray(v) for k, v in md.get("atomrefs", {}).items()
        }

        # conversion factors requested -> applied at load
        self._dist_conv = 1.0
        if distance_unit and self._distance_unit_src:
            self._dist_conv = convert_units(self._distance_unit_src, distance_unit)
        self._prop_conv: Dict[str, float] = {}
        if property_units:
            for p, u in property_units.items():
                src = self._property_units_src.get(p)
                if src is not None:
                    self._prop_conv[p] = convert_units(src, u)
        # atomrefs must live in the same units as the (converted) property
        for p, conv in self._prop_conv.items():
            if p in self.atomrefs:
                self.atomrefs[p] = self.atomrefs[p] * conv

    # -- connection handling (lazy, fork-safe) --------------------------
    @property
    def conn(self) -> sqlite3.Connection:
        if self._conn is None:
            self._conn = sqlite3.connect(self.datapath, timeout=60.0)
        return self._conn

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_conn"] = None
        return d

    # -- metadata --------------------------------------------------------
    @property
    def metadata(self) -> Dict:
        if not os.path.exists(self.datapath):
            return {}
        cur = self.conn.execute(
            "SELECT value FROM information WHERE name='metadata'"
        )
        row = cur.fetchone()
        return json.loads(row[0]) if row else {}

    def update_metadata(self, **kwargs):
        md = self.metadata
        md.update(kwargs)
        with self.conn:
            self.conn.execute("DELETE FROM information WHERE name='metadata'")
            self.conn.execute(
                "INSERT INTO information (name, value) VALUES ('metadata', ?)",
                (json.dumps(md),),
            )

    @property
    def available_properties(self) -> List[str]:
        return list(self._property_units_src)

    @property
    def units(self) -> Dict[str, str]:
        return dict(self._property_units_src)

    # -- reading ---------------------------------------------------------
    def __len__(self) -> int:
        if self.subset_idx is not None:
            return len(self.subset_idx)
        return self.conn.execute("SELECT COUNT(*) FROM systems").fetchone()[0]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        real = self.subset_idx[idx] if self.subset_idx is not None else idx
        props = self._get_properties(real)
        for t in self.transforms:
            props = t(props)
        return props

    def _get_properties(self, idx: int) -> Dict[str, np.ndarray]:
        row = self.conn.execute(
            "SELECT numbers, positions, cell, pbc, natoms, data FROM systems "
            "WHERE id=?",
            (idx + 1,),
        ).fetchone()
        if row is None:
            raise IndexError(idx)
        numbers, positions, cell, pbc, natoms, data = row
        Z = _deblob(numbers, np.int32, (-1,)).astype(np.int64)
        R = _deblob(positions, np.float64, (-1, 3)) * self._dist_conv
        C = _deblob(cell, np.float64, (3, 3))
        if C is not None:
            C = C * self._dist_conv
        else:
            C = np.zeros((3, 3))
        pbc_arr = np.array([bool(pbc & (1 << i)) for i in range(3)])

        out: Dict[str, np.ndarray] = {
            structure.idx: np.array([idx]),
            structure.Z: Z,
            structure.R: R,
            structure.cell: C,
            structure.pbc: pbc_arr,
        }
        if data:
            decoded = bytes_to_object(data)
            keys = self.load_properties or list(decoded)
            for k in keys:
                if k not in decoded:
                    raise KeyError(f"property {k!r} not in sample {idx}")
                v = np.asarray(decoded[k])
                conv = self._prop_conv.get(k, 1.0)
                if v.shape == (1,):
                    v = v.reshape(())
                out[k] = v * conv
        return out

    def iter_properties(self, properties_only: bool = False):
        for i in range(len(self)):
            real = self.subset_idx[i] if self.subset_idx is not None else i
            yield self._get_properties(real)

    def subset(self, indices: Sequence[int]) -> "ASEAtomsData":
        base = self.subset_idx if self.subset_idx is not None else None
        real = [base[i] for i in indices] if base is not None else list(indices)
        ds = ASEAtomsData.__new__(ASEAtomsData)
        ds.__dict__ = dict(self.__dict__)
        ds._conn = None
        ds.subset_idx = real
        ds.transforms = list(self.transforms)
        return ds

    # -- writing ---------------------------------------------------------
    @classmethod
    def create(
        cls,
        datapath: str,
        distance_unit: str = "Ang",
        property_unit_dict: Optional[Dict[str, str]] = None,
        atomrefs: Optional[Dict[str, Sequence[float]]] = None,
        **kwargs,
    ) -> "ASEAtomsData":
        if os.path.exists(datapath):
            raise FileExistsError(datapath)
        os.makedirs(os.path.dirname(os.path.abspath(datapath)), exist_ok=True)
        conn = sqlite3.connect(datapath)
        with conn:
            for sql in _INIT_SQL:
                conn.execute(sql)
            md = {
                "_distance_unit": distance_unit,
                "_property_unit_dict": property_unit_dict or {},
                "atomrefs": {
                    k: np.asarray(v).tolist() for k, v in (atomrefs or {}).items()
                },
                "version": 1,
            }
            conn.execute(
                "INSERT INTO information (name, value) VALUES ('version', '9')"
            )
            conn.execute(
                "INSERT INTO information (name, value) VALUES ('metadata', ?)",
                (json.dumps(md),),
            )
        conn.close()
        return cls(datapath, **kwargs)

    def add_system(
        self,
        numbers: np.ndarray,
        positions: np.ndarray,
        cell: Optional[np.ndarray] = None,
        pbc: Optional[np.ndarray] = None,
        **data,
    ) -> None:
        self.add_systems(
            [dict(numbers=numbers, positions=positions, cell=cell, pbc=pbc, **data)]
        )

    def add_systems(self, systems: Sequence[Dict]) -> None:
        now = time.time()
        rows = []
        for s in systems:
            Z = np.asarray(s["numbers"], np.int32)
            R = np.asarray(s["positions"], np.float64)
            C = s.get("cell")
            C = np.asarray(C, np.float64) if C is not None else np.zeros((3, 3))
            p = s.get("pbc")
            p = np.asarray(p, bool) if p is not None else np.zeros(3, bool)
            pbc_int = int(p[0]) | (int(p[1]) << 1) | (int(p[2]) << 2)
            payload = {
                k: np.atleast_1d(np.asarray(v, np.float64))
                for k, v in s.items()
                if k not in ("numbers", "positions", "cell", "pbc")
            }
            rows.append(
                (
                    os.urandom(16).hex(), now, now, "schnetpack_tpu",
                    _blob(Z), _blob(R), _blob(C), pbc_int,
                    "{}", object_to_bytes(payload), len(Z),
                )
            )
        with self.conn:
            self.conn.executemany(
                "INSERT INTO systems (unique_id, ctime, mtime, username, numbers,"
                " positions, cell, pbc, key_value_pairs, data, natoms)"
                " VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                rows,
            )


def create_dataset(datapath: str, format: str = "ase", **kwargs) -> ASEAtomsData:
    return ASEAtomsData.create(datapath, **kwargs)


def load_dataset(datapath: str, format: str = "ase", **kwargs) -> ASEAtomsData:
    return ASEAtomsData(datapath, **kwargs)
