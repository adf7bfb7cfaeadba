"""PyTorch port, ``datasets/misc.py``: ISO17, ANI-1, QM7-X, the Materials
Project, OMDB and tmQM, each converter run by the JAX package and by the
port on the synthetic raw files of ``tests/test_datasets_offline.py``
(the real distributions' on-disk formats), the two databases equal row
for row (every property array, bit for bit) with their metadata; the
port's ``configs/data`` files name the port's classes; a missing raw file
raises, naming the URL (the port does not download)."""
import gzip
import os
import sys
import tarfile
import types

import numpy as np
import pytest

from schnetpack_tpu.data.atoms import ASEAtomsData as JAtomsData
from schnetpack_tpu.datasets import misc as jmisc
from schnetpack_tpu_torch.config import miniyaml
from schnetpack_tpu_torch.data.atoms import ASEAtomsData
from schnetpack_tpu_torch.datasets import misc

h5py = pytest.importorskip("h5py")
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "schnetpack_tpu_torch", "configs", "data")


def _iso17(tmp_path, raw):
    src_dir = tmp_path / "build" / "iso17"
    src_dir.mkdir(parents=True)
    src = JAtomsData.create(
        str(src_dir / "reference.db"), distance_unit="Ang",
        property_unit_dict={"total_energy": "eV", "atomic_forces": "eV/Ang"})
    rng = np.random.RandomState(0)
    for _ in range(3):
        src.add_system(numbers=np.array([6, 6, 8, 1, 1]),
                       positions=rng.rand(5, 3) * 3,
                       total_energy=rng.randn(1),
                       atomic_forces=rng.randn(5, 3))
    with tarfile.open(os.path.join(raw, "iso17.tar.gz"), "w:gz") as tar:
        tar.add(str(src_dir / "reference.db"), arcname="iso17/reference.db")
    return dict(fold="reference")


def _ani1(tmp_path, raw):
    h5dir = tmp_path / "build" / "ANI-1_release"
    h5dir.mkdir(parents=True)
    rng = np.random.RandomState(1)
    with h5py.File(str(h5dir / "ani_gdb_s01.h5"), "w") as f:
        mol = f.create_group("gdb11_s01").create_group("gdb11_s01-0")
        mol["species"] = np.array([b"C", b"H", b"H", b"H", b"H"])
        mol["coordinates"] = rng.rand(4, 5, 3).astype(np.float32)
        mol["energies"] = np.array([-40.1, -40.2, -40.3, -40.4])
    with tarfile.open(os.path.join(raw, "ANI1_release.tar.gz"),
                      "w:gz") as tar:
        tar.add(str(h5dir), arcname="ANI-1_release")
    return dict(num_heavy_atoms=1)


def _qm7x(tmp_path, raw):
    rng = np.random.RandomState(2)

    def conf(grp, name, n=4):
        c = grp.create_group(name)
        c["atNUM"] = np.array([6, 1, 1, 8][:n])
        c["atXYZ"] = rng.rand(n, 3)
        c["ePBE0+MBD"] = np.array(-1000.0 + rng.randn())
        for key in ("totFOR", "pbe0FOR", "vdwFOR"):
            c[key] = rng.randn(n, 3)
        c["eAT"] = np.array(-50.0)
        c["ePBE0"] = np.array(-999.0)
        c["eMBD"] = np.array(-1.0)
        c["sRMSD"] = np.array(0.1)
        c["vDIP"] = rng.randn(3)
        c["mPOL"] = np.array(9.9)

    with h5py.File(os.path.join(raw, "1000.hdf5"), "w") as f:
        for m in ("Geom-m1", "Geom-m2", "Geom-m3"):
            g = f.create_group(m)
            conf(g, f"{m}-i1-c1-opt")
            conf(g, f"{m}-i1-c1-d1")
    with open(os.path.join(raw, "DupMols.dat"), "w") as f:
        f.write("Geom-m2-i1-c1.xyz\n")
    return {}


def _omdb(tmp_path, raw):
    from schnetpack_tpu_torch.datasets.xyz import format_extxyz_frame

    build = tmp_path / "build"
    build.mkdir()
    rng = np.random.RandomState(3)
    frames = [format_extxyz_frame(numbers=np.array([6, 8, 1]),
                                  positions=rng.rand(3, 3) * 4,
                                  cell=np.eye(3) * (5.0 + i))
              for i in range(3)]
    (build / "structures.xyz").write_text("".join(frames))
    (build / "bandgaps.csv").write_text("\n".join(str(0.5 + i)
                                                  for i in range(3)))
    with tarfile.open(os.path.join(raw, "OMDB-GAP1_v1.1.tar.gz"),
                      "w:gz") as tar:
        tar.add(str(build / "structures.xyz"), arcname="structures.xyz")
        tar.add(str(build / "bandgaps.csv"), arcname="bandgaps.csv")
    return {}


def _tmqm(tmp_path, raw):
    xyz = ("3\nCSD_code = ABC123 | q = 0 | S = 0\n"
           "Fe 0.0 0.0 0.0\nO 1.8 0.0 0.0\nO -1.8 0.0 0.0\n"
           "2\nCSD_code = XYZ999 | q = 1 | S = 0\n"
           "Cu 0.0 0.0 0.0\nCl 2.1 0.0 0.0\n")
    with gzip.open(os.path.join(raw, "tmQM_X1.xyz.gz"), "wt") as f:
        f.write(xyz)
    with gzip.open(os.path.join(raw, "tmQM_X2.xyz.gz"), "wt") as f:
        f.write("")
    with open(os.path.join(raw, "tmQM_y.csv"), "w") as f:
        f.write("CSD_code;Electronic_E;Dispersion_E;Dipole_M;"
                "Metal_q;HL_Gap;HOMO_Energy;LUMO_Energy;Polarizability\n")
        f.write("ABC123;-1500.5;-0.05;2.5;0.8;0.11;-0.30;-0.19;120.0\n")
        f.write("XYZ999;-2100.25;-0.02;4.5;0.6;0.21;-0.28;-0.07;80.5\n")
    return {}


def _materials_project(tmp_path, raw, monkeypatch):
    """A stub ``MPRester`` (the real one needs the network and
    pymatgen)."""
    class _Sp:
        def __init__(self, Z):
            self.Z = Z

    class _Lattice:
        matrix = np.eye(3) * 4.0

    class _Structure:
        species = [_Sp(14), _Sp(8), _Sp(8)]
        cart_coords = np.array([[0.0, 0, 0], [1.2, 0, 0], [0, 1.2, 0]])
        lattice = _Lattice()

    class _MPRester:
        def __init__(self, apikey):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def query(self, criteria, properties):
            return [{"structure": _Structure(),
                     "formation_energy_per_atom": -1.1 - i,
                     "energy_per_atom": -5.5, "band_gap": 0.9 + i,
                     "total_magnetization": 0.0} for i in range(2)]

    mod = types.ModuleType("pymatgen.ext.matproj")
    mod.MPRester = _MPRester
    monkeypatch.setitem(sys.modules, "pymatgen", types.ModuleType("pymatgen"))
    monkeypatch.setitem(sys.modules, "pymatgen.ext",
                        types.ModuleType("pymatgen.ext"))
    monkeypatch.setitem(sys.modules, "pymatgen.ext.matproj", mod)
    return dict(apikey="test")


CASES = {
    "iso17": ("ISO17", _iso17),
    "ani1": ("ANI1", _ani1),
    "qm7x": ("QM7X", _qm7x),
    "omdb": ("OrganicMaterialsDatabase", _omdb),
    "tmqm": ("TMQM", _tmqm),
    "materials_project": ("MaterialsProject", _materials_project),
}


@pytest.mark.parametrize("name", list(CASES))
def test_converter_matches_jax_row_for_row(tmp_path, monkeypatch, name):
    cls, make = CASES[name]
    raw = str(tmp_path / "raw")
    os.makedirs(raw)
    args = (tmp_path, raw, monkeypatch) if name == "materials_project" \
        else (tmp_path, raw)
    kw = make(*args)
    dbs = {}
    for tag, module in (("jax", jmisc), ("port", misc)):
        path = str(tmp_path / f"{name}_{tag}.db")
        dm = getattr(module, cls)(path, batch_size=2, raw_dir=raw, **kw)
        if name == "qm7x":
            dm.sets = ["1000"]
        dm.prepare_data()
        dbs[tag] = ASEAtomsData(path)
    want, got = dbs["jax"], dbs["port"]
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g.keys() == w.keys(), i
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=f"row {i} {k}")
    assert got.metadata == want.metadata
    # the port's config names the port's class, with JAX's other keys
    cfg = miniyaml.load(os.path.join(CONFIGS, f"{name}.yaml"))
    assert cfg["_target_"] == f"schnetpack_tpu_torch.datasets.{cls}"
    jcfg = miniyaml.load(os.path.join(os.path.dirname(CONFIGS).replace(
        "schnetpack_tpu_torch", "schnetpack_tpu"), "data", f"{name}.yaml"))
    assert {k: v for k, v in cfg.items() if k != "_target_"} == {
        k: v for k, v in jcfg.items() if k != "_target_"}


def test_missing_raw_file_raises_with_the_url(tmp_path):
    dm = misc.OrganicMaterialsDatabase(str(tmp_path / "omdb.db"),
                                       batch_size=2, raw_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="omdb.mathub.io"):
        dm.prepare_data()
    assert not os.path.exists(tmp_path / "omdb.db")
