"""PyTorch port, the data pipeline: ``data/``, ``transform/`` and the
MD17 data modules of ``datasets/`` against the JAX package.

Databases cross both ways (every property and the metadata, and the rows'
blobs byte for byte); ``collate`` on the flat and dense layouts gives
every key, dtype and padded value of the JAX collate, on the molecules of
``test_torch_port_layouts.py`` and a periodic argon box; the splits,
statistics and sampler give the same indices and numbers for the same
seed; every transform gives the JAX transform's outputs; and
``AtomsDataModule`` gives the same batches.
"""
import os
import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import schnetpack_tpu.data as jdata
import schnetpack_tpu.transform as jtf
from schnetpack_tpu import properties as P
import schnetpack_tpu_torch.data as tdata
import schnetpack_tpu_torch.transform as ttf
from schnetpack_tpu_torch.datasets import MD17
from schnetpack_tpu.datasets import MD17 as JMD17
import test_torch_port_layouts as layouts

CUTOFF = 5.0


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


def _systems(n=12, seed=0):
    """Molecules of 3-9 atoms with energy, forces, a (1, 3) dipole and a
    group id; every fourth one in a periodic 6 A box."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n):
        a = rng.randint(3, 10)
        s = dict(numbers=rng.randint(1, 9, a), positions=rng.rand(a, 3) * 4,
                 energy=np.array([rng.randn() * 10]),
                 forces=rng.randn(a, 3), dipole_moment=rng.randn(1, 3),
                 group=np.array([k // 3]))
        if k % 4 == 3:
            s.update(cell=np.eye(3) * 6.0, pbc=np.ones(3, bool))
        out.append(s)
    return out


def _create(module, path, systems):
    ds = module.ASEAtomsData.create(
        path, distance_unit="Ang",
        property_unit_dict={"energy": "eV", "forces": "eV/Ang",
                            "dipole_moment": "e*Ang", "group": ""},
        atomrefs={"energy": np.linspace(-1, 0, 10)})
    ds.add_systems(systems)
    ds.update_metadata(splits={"train": [0, 2, 4, 6, 8, 10],
                               "test": [1, 3, 5]})
    return ds


def _same_samples(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert x.keys() == y.keys()
        for k in x:
            assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _rows(path):
    with sqlite3.connect(path) as c:
        return c.execute(
            "SELECT numbers, positions, cell, pbc, key_value_pairs, data, "
            "natoms, username FROM systems ORDER BY id").fetchall()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_databases_cross(tmp_path, writer):
    """A database one package writes, the other reads: every property and
    the metadata; the rows' content is byte for byte what the other
    package writes."""
    systems = _systems()
    mods = {"jax": jdata, "port": tdata}
    other = "port" if writer == "jax" else "jax"
    path = str(tmp_path / f"{writer}.db")
    _create(mods[writer], path, systems)
    _create(mods[other], str(tmp_path / "other.db"), systems)
    assert _rows(path) == _rows(str(tmp_path / "other.db"))
    got = mods[other].load_dataset(path, distance_unit="Bohr",
                                   property_units={"energy": "kcal/mol"})
    want = mods[writer].load_dataset(path, distance_unit="Bohr",
                                     property_units={"energy": "kcal/mol"})
    assert got.metadata == want.metadata
    assert got.available_properties == want.available_properties
    for k in want.atomrefs:
        np.testing.assert_array_equal(got.atomrefs[k], want.atomrefs[k])
    _same_samples(got, want)
    _same_samples(got.subset([5, 1, 3]), want.subset([5, 1, 3]))


def _layout_samples():
    """The molecules of ``test_torch_port_layouts.py`` and its argon box,
    neighbor-listed, with seeded energies and forces."""
    rng = np.random.RandomState(4)
    out = []
    for s in layouts._samples():
        s = dict(s)
        s[P.energy] = np.array([rng.randn()])
        s[P.forces] = rng.randn(len(s[P.Z]), 3)
        s[P.idx] = np.array([len(out)])
        out.append(s)
    return out


def _same_batches(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_collate_matches_jax(layout):
    """``padding_for``, ``static_padding_for_dataset`` and ``collate`` on
    the flat and dense layouts: the same spec, and every key, dtype and
    padded value of the JAX collate."""
    samples = _layout_samples()
    spec_j = jdata.padding_for(samples)
    spec = tdata.padding_for(samples)
    assert tuple(vars(spec).values()) == tuple(vars(spec_j).values())
    dense = layout == "dense"
    spec_j = jdata.static_padding_for_dataset(samples, 4, dense_layout=dense)
    spec = tdata.static_padding_for_dataset(samples, 4, dense_layout=dense)
    assert tuple(vars(spec).values()) == tuple(vars(spec_j).values())
    assert bool(spec.n_neighbors) == dense
    _same_batches(tdata.collate(samples, spec), jdata.collate(samples, spec_j))
    with pytest.raises(ValueError, match="too small"):
        tdata.collate(samples, tdata.PaddingSpec(8, 8, 2))


def test_splits_stats_and_sampler_match_jax(tmp_path):
    """``random_split``, ``RandomSplit``, ``GroupSplit``,
    ``SubsamplePartitions``, ``calculate_stats``, ``estimate_atomrefs`` and
    ``StratifiedSampler`` (both criteria) for the same seeds."""
    path = str(tmp_path / "d.db")
    _create(jdata, path, _systems(24, seed=1))
    ds, jds = tdata.ASEAtomsData(path), jdata.ASEAtomsData(path)
    for sizes in ((10, 5, None), (0.5, 0.25, None), (12, None, 4)):
        for a, b in zip(tdata.random_split(24, *sizes, seed=3),
                        jdata.random_split(24, *sizes, seed=3)):
            np.testing.assert_array_equal(a, b)
    strategies = [
        (tdata.RandomSplit(seed=2), jdata.RandomSplit(seed=2), (8, 8, 8)),
        (tdata.GroupSplit("group", seed=2), jdata.GroupSplit("group", seed=2),
         (4, 2, None)),
        (tdata.SubsamplePartitions(["train", "test"], seed=2),
         jdata.SubsamplePartitions(["train", "test"], seed=2), (4, 2))]
    for ours, ref, sizes in strategies:
        for a, b in zip(ours.split(ds, *sizes), ref.split(jds, *sizes)):
            np.testing.assert_array_equal(a, b)
    refs = {"energy": ds.atomrefs["energy"]}
    for per_atom in (True, False):
        assert (tdata.calculate_stats(ds, {"energy": per_atom}, refs)
                == jdata.calculate_stats(jds, {"energy": per_atom}, refs))
    np.testing.assert_array_equal(tdata.estimate_atomrefs(ds, "energy"),
                                  jdata.estimate_atomrefs(jds, "energy"))
    for crit, jcrit in ((tdata.NumberOfAtomsCriterion(),
                         jdata.NumberOfAtomsCriterion()),
                        (tdata.PropertyCriterion("energy"),
                         jdata.PropertyCriterion("energy"))):
        ours = tdata.StratifiedSampler(ds, crit, num_bins=4, seed=5)
        ref = jdata.StratifiedSampler(jds, jcrit, num_bins=4, seed=5)
        np.testing.assert_array_equal(ours.weights, ref.weights)
        assert list(ours) == list(ref) and list(ours) == list(ref)


def _edges(s, i="_idx_i", j="_idx_j", off="_offsets"):
    """A pair list as a sorted array of (i, j, offset) rows."""
    rows = np.column_stack([s[i], s[j], np.round(s[off], 6)])
    return rows[np.lexsort(rows.T[::-1])]


def _periodic(seed=0):
    R, cell = layouts.fcc_argon(2, jitter=0.3, seed=seed)
    return {P.Z: np.full(len(R), 18), P.R: R + 1.0, P.cell: cell,
            P.pbc: np.ones(3, bool), P.idx: np.array([3])}


def _molecule(seed=0):
    return dict(layouts._molecule(np.random.RandomState(seed), 9),
                **{P.idx: np.array([4]), P.energy: np.array([2.5])})


@pytest.mark.parametrize("name", [
    "NeighborListTransform", "ASENeighborList", "MatScipyNeighborList",
    "VesinNeighborList", "TorchNeighborList"])
def test_neighbor_lists_match_jax(name):
    """Each backend (ase, matscipy and vesin are not installed: the
    fallbacks) on a molecule and a periodic box, and with a long-range
    cutoff: the same pairs and offsets."""
    for s in (_molecule(), _periodic()):
        for kw in ({}, {"long_range_cutoff": 7.0}):
            got = getattr(ttf, name)(CUTOFF, **kw)(dict(s))
            want = getattr(jtf, name)(CUTOFF, **kw)(dict(s))
            np.testing.assert_allclose(_edges(got), _edges(want), atol=1e-6)
            if kw:
                np.testing.assert_allclose(
                    _edges(got, P.idx_i_lr, P.idx_j_lr, P.offsets_lr),
                    _edges(want, P.idx_i_lr, P.idx_j_lr, P.offsets_lr),
                    atol=1e-6)


def _same_sample(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-12, atol=1e-12, err_msg=k)


def test_transforms_match_jax(tmp_path):
    """The atomistic transforms, casting, the skin, cached and filtered
    lists, wrapping, triples and neighbor counts on one sample each."""
    mol, box = _molecule(), _periodic()
    refs = np.linspace(-2.0, 1.0, 10)
    cases = [
        ("SubtractCenterOfMass", (), mol),
        ("SubtractCenterOfGeometry", (), mol),
        ("RemoveOffsets", ("energy",), dict(
            mol, **{"_kw": dict(remove_mean=True, remove_atomrefs=True,
                                atomrefs=refs, property_mean=0.3)})),
        ("ScaleProperty", ("energy",), dict(
            mol, **{"_kw": dict(target_key="scaled", scale=2.5)})),
        ("CastTo32", (), mol), ("CastTo64", (), dict(mol, **{
            P.R: mol[P.R].astype(np.float32)})),
        ("WrapPositions", (), box),
    ]
    for name, args, s in cases:
        s = dict(s)
        kw = s.pop("_kw", {})
        _same_sample(getattr(ttf, name)(*args, **kw)(dict(s)),
                     getattr(jtf, name)(*args, **kw)(dict(s)))
    for s in (mol, box):
        s = jtf.NeighborListTransform(CUTOFF)(dict(s))
        for name, args in (("CollectAtomTriples", ()), ("CountNeighbors", ()),
                           ("FilterNeighbors", ([0, 2, 3, 5, 8],))):
            _same_sample(getattr(ttf, name)(*args)(dict(s)),
                         getattr(jtf, name)(*args)(dict(s)))
    skin = ttf.SkinNeighborList(ttf.NeighborListTransform(CUTOFF), skin=0.4)
    jskin = jtf.SkinNeighborList(jtf.NeighborListTransform(CUTOFF), skin=0.4)
    rng = np.random.RandomState(9)
    s = dict(box)
    for step in (0.05, 0.05, 0.5):        # kept, kept, rebuilt
        s = dict(s, **{P.R: s[P.R] + rng.uniform(-step, step, s[P.R].shape)})
        np.testing.assert_allclose(_edges(skin(dict(s))),
                                   _edges(jskin(dict(s))), atol=1e-6)
    cached = ttf.CachedNeighborList(str(tmp_path / "c"),
                                    ttf.NeighborListTransform(CUTOFF))
    jcached = jtf.CachedNeighborList(str(tmp_path / "j"),
                                     jtf.NeighborListTransform(CUTOFF))
    for _ in range(2):                     # written, then read back
        np.testing.assert_allclose(_edges(cached(dict(box))),
                                   _edges(jcached(dict(box))), atol=1e-6)
    assert "nbl_3.npz" in os.listdir(tmp_path / "c")
    cached.teardown()
    assert not os.path.exists(tmp_path / "c")


def test_add_offsets_postprocessor_matches_jax():
    """``AddOffsets`` (mean and atomrefs) on a collated batch's energies:
    the port on tensors, the JAX package on jax arrays."""
    samples = _layout_samples()[:3]
    batch = jdata.collate(samples, jdata.padding_for(samples))
    refs = np.linspace(-2.0, 1.0, 10)
    kw = dict(add_mean=True, add_atomrefs=True, atomrefs=refs,
              property_mean=0.7)
    got = ttf.AddOffsets("energy", **kw)(
        {k: torch.as_tensor(v) for k, v in batch.items()})
    want = jtf.AddOffsets("energy", **kw)(
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(got["energy"].numpy(),
                               np.asarray(want["energy"]), rtol=1e-6)
    cast = ttf.CastTo64()({"energy": got["energy"]})
    assert cast["energy"].dtype == torch.float64


def _write_npz(path, n_frames=24, n_atoms=6, seed=0):
    rng = np.random.RandomState(seed)
    np.savez(path, z=rng.randint(1, 9, n_atoms),
             R=rng.rand(n_frames, n_atoms, 3) * 3, E=rng.randn(n_frames),
             F=rng.randn(n_frames, n_atoms, 3) * 0.1)


@pytest.mark.parametrize("dense", [False, True])
def test_data_module_matches_jax(tmp_path, dense):
    """``MD17`` from a raw npz (the database built by each package), split,
    statistics for the offsets, transforms and the shuffled train, val and
    test loaders: equal batches; a missing raw file raises without a
    download."""
    _write_npz(tmp_path / "md17_aspirin.npz")
    mods = {}
    for name, cls, tf in (("port", MD17, ttf), ("jax", JMD17, jtf)):
        dm = cls(datapath=str(tmp_path / name / "md17.db"), batch_size=5,
                 num_train=12, num_val=6, num_test=None, seed=1,
                 raw_dir=str(tmp_path), dense_layout=dense,
                 split_file=str(tmp_path / name / "split.npz"),
                 transforms=[tf.SubtractCenterOfMass(),
                             tf.RemoveOffsets("energy", remove_mean=True),
                             tf.MatScipyNeighborList(CUTOFF)])
        dm.setup()
        mods[name] = dm
    port, ref = mods["port"], mods["jax"]
    assert (port.train_idx, port.val_idx, port.test_idx) == (
        ref.train_idx, ref.val_idx, ref.test_idx)
    assert port.get_stats("energy", True, False) == ref.get_stats(
        "energy", True, False)
    assert tuple(vars(port.padding).values()) == tuple(vars(
        ref.padding).values())
    for loader in ("train_dataloader", "val_dataloader", "test_dataloader"):
        got, want = list(getattr(port, loader)()), list(getattr(ref, loader)())
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            _same_batches(a, b)
    with pytest.raises(RuntimeError, match="does not download"):
        MD17(datapath=str(tmp_path / "none" / "x.db"), batch_size=2,
             molecule="ethanol", raw_dir=str(tmp_path)).setup()
