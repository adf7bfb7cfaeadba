"""PyTorch port: the on-device rebuild of the column neighbor state
(``ops/colblock_rebuild.py``) against the JAX package's
``colblock_rebuild`` on the same inputs, and the MD neighbor list's device
path (``CellBlockNeighborListMD.maybe_rebuild``) against a host build.

Both rebuilds compact each (column, bucket) with a sort on unique keys,
so their slot order is the same and qcol/dcol compare exactly; the host
builder emits edges in another order, so against it edge sets are
compared (original atom ids, offsets rounded to 1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu.ops import colblock_rebuild as jrb
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.md import CellBlockNeighborListMD, load_molecules
from schnetpack_tpu_torch.ops import colblock_rebuild as trb
from schnetpack_tpu_torch.ops.cellblock import build_column_layout
from schnetpack_tpu_torch.ops.colblock import ColRefs, decode_i, decode_j
from schnetpack_tpu_torch.units import _parse_unit, md_units

COFF_ATOL = 1e-5   # offsets are integer combinations of the f32 cell


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _edge_set(qcol, dcol, coff_fm, order, P, ksizes):
    """{(original i, original j, rounded offset)} of a column state."""
    refs = ColRefs(torch.as_tensor(qcol), torch.as_tensor(dcol), P,
                   tuple(ksizes))
    j, valid = decode_j(refs)
    i, _ = decode_i(refs)
    order = np.asarray(order)
    m = valid.numpy()
    off = np.round(np.moveaxis(np.asarray(coff_fm), 2, 3)[m], 4)
    return set((int(a), int(b), *o) for a, b, o in
               zip(order[i.numpy()[m]], order[j.numpy()[m]], off))


def _host_edge_set(lay):
    m = lay.emask > 0
    return set((int(lay.order[a]), int(lay.order[b]), *np.round(o, 4))
               for a, b, o in zip(lay.icol[m], lay.jcol[m], lay.offcol[m]))


def _single_bead(ks_extra):
    """The inputs of ``tests/test_device_rebuild.py::
    test_device_rebuild_matches_host`` (with the alias-free 3x3 grid)."""
    rng = np.random.RandomState(0)
    L, rc = 14.0, 3.5
    R0 = rng.uniform(0, L, size=(220, 3))
    cell = np.eye(3) * L
    lay = build_column_layout(R0, rc, cell, np.ones(3, bool),
                              capacity_headroom=4, min_grid=3)
    R1 = R0 + rng.uniform(-0.15, 0.15, R0.shape)
    return lay, R1[None], cell, rc, ks_extra


def _four_beads():
    """``test_device_rebuild_union_over_beads``: four beads."""
    rng = np.random.RandomState(1)
    L, rc = 12.0, 3.2
    R0 = rng.uniform(0, L, size=(150, 3))
    cell = np.eye(3) * L
    lay = build_column_layout(R0, rc, cell, np.ones(3, bool),
                              capacity_headroom=4, dims=(3, 3, 1))
    beads = np.stack([R0 + rng.normal(0, 0.05, R0.shape) for _ in range(4)])
    return lay, beads, cell, rc, 64


CASES = {
    "one_bead": lambda: _single_bead(64),
    "four_beads": _four_beads,
    "overflow": lambda: _single_bead(-16),   # buckets too small
}


@pytest.mark.parametrize("case", list(CASES))
def test_rebuild_column_state_matches_jax(case):
    lay, beads, cell, rc, extra = CASES[case]()
    nx, ny, P, ks = lay.dims
    assert nx >= 3 and ny >= 3
    ks2 = tuple(max(8, k + extra) for k in ks)
    Rb = (beads[:, lay.order] * lay.slot_mask[None, :, None]).astype(
        np.float32)
    cell32 = cell.astype(np.float32)
    js, jovf = jrb.rebuild_column_state(
        jnp.asarray(Rb), jnp.asarray(lay.slot_mask), jnp.asarray(cell32),
        nx=nx, ny=ny, P=P, ksizes=ks2, rc=rc)
    ts, tovf = trb.rebuild_column_state(
        torch.tensor(Rb), torch.tensor(lay.slot_mask), torch.tensor(cell32),
        nx, ny, P, ks2, rc)
    assert bool(tovf) == bool(jovf) == (case == "overflow")
    np.testing.assert_array_equal(ts["qcol"].numpy(), np.asarray(js["qcol"]))
    np.testing.assert_array_equal(ts["dcol"].numpy(), np.asarray(js["dcol"]))
    np.testing.assert_allclose(ts["coff_fm"].numpy(),
                               np.asarray(js["coff_fm"]), 0, COFF_ATOL)
    np.testing.assert_array_equal(ts["emask"].numpy(),
                                  np.asarray(js["emask"]))
    if case == "one_bead":   # the edge set of a host build on the new R
        host = build_column_layout(beads[0], rc, cell, np.ones(3, bool),
                                   dims=(nx, ny, 1))
        assert _edge_set(ts["qcol"], ts["dcol"], ts["coff_fm"], lay.order,
                         P, ks2) == _host_edge_set(host)


def _rebin_inputs(ks_extra):
    rng = np.random.RandomState(2)
    L, rc = 13.0, 3.2
    R0 = rng.uniform(0, L, size=(200, 3))
    cell = np.eye(3) * L
    lay = build_column_layout(R0, rc, cell, np.ones(3, bool),
                              capacity_headroom=8, min_grid=3)
    nx, ny, P, ks = lay.dims
    # move atoms across column walls (re-binning) but within the skin
    R1 = R0 + rng.uniform(-0.3, 0.3, R0.shape)
    ks2 = tuple(max(8, k + ks_extra) for k in ks)
    Z = (np.where(lay.slot_mask > 0, 18, 0)).astype(np.int64)
    return lay, R1, cell, rc, ks2, Z


@pytest.mark.parametrize("ks_extra,overflow", [(64, False), (-24, True)])
def test_rebin_and_rebuild_matches_jax(ks_extra, overflow):
    lay, R1, cell, rc, ks2, Z = _rebin_inputs(ks_extra)
    nx, ny, P, _ = lay.dims
    pos = R1.astype(np.float32)[None]
    cell32 = cell.astype(np.float32)
    idx_m = np.zeros(len(lay.order), np.int64)
    js, jovf = jrb.rebin_and_rebuild(
        jnp.asarray(pos), jnp.asarray(lay.order), jnp.asarray(lay.slot_mask),
        jnp.asarray(Z), jnp.asarray(idx_m), jnp.asarray(cell32),
        nx=nx, ny=ny, P=P, ksizes=ks2, rc=rc)
    ts, tovf = trb.rebin_and_rebuild(
        torch.tensor(pos), torch.tensor(lay.order.astype(np.int64)),
        torch.tensor(lay.slot_mask), torch.tensor(Z), torch.tensor(idx_m),
        torch.tensor(cell32), nx, ny, P, ks2, rc)
    assert bool(tovf) == bool(jovf) == overflow
    for k in ("order", "rank", "Z", "atom_mask", "qcol", "dcol"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)
    assert not np.array_equal(ts["order"].numpy(), lay.order), \
        "no atom changed its column"
    if not overflow:
        host = build_column_layout(R1, rc, cell, np.ones(3, bool),
                                   dims=(nx, ny, 1))
        assert _edge_set(ts["qcol"], ts["dcol"], ts["coff_fm"],
                         ts["order"].numpy(), P, ks2) == _host_edge_set(host)


def _nbl_system(seed=4):
    """A 150-atom periodic box in MD units and a column neighbor list."""
    rng = np.random.RandomState(seed)
    L = 12.0
    R = rng.uniform(0, L, size=(150, 3))
    mol = {TP.Z: np.full(150, 18, np.int64), TP.R: R,
           TP.cell: np.eye(3) * L, TP.pbc: np.ones(3, bool)}
    conv = _parse_unit("Ang") * md_units().length
    nbl = CellBlockNeighborListMD(3.0 * conv, skin=0.4 * conv)
    return load_molecules([mol], device="cpu"), nbl, conv, rng


def _state_edges(nbl):
    st = nbl.state()
    nx, ny = st[TP.cell_qcol].shape[:2]
    P = st["cell_order"].shape[0] // (nx * ny)
    return _edge_set(st[TP.cell_qcol], st[TP.cell_dcol],
                     st[TP.cell_coff_fm], st["cell_order"].numpy(), P,
                     st[TP.cell_ksz])


def test_maybe_rebuild_goes_through_the_device():
    system, nbl, conv, rng = _nbl_system()
    nbl.build(system)
    assert nbl._dev_rebuild is not None, "the box should be eligible"
    moved = system.positions + torch.tensor(
        rng.uniform(-0.25, 0.25, system.positions.shape) * conv,
        dtype=system.positions.dtype)
    system = system.replace(positions=moved)
    assert nbl.maybe_rebuild(system)
    assert (nbl.n_builds, nbl.n_device_builds) == (1, 1)
    assert not nbl.maybe_rebuild(system)      # skin reset to the new R
    dev_edges = _state_edges(nbl)
    st = nbl.state()
    # the sorted-space tables follow the new order
    np.testing.assert_array_equal(
        st["cell_rank"][st["cell_order"][st["cell_atom_mask"] > 0]].numpy(),
        np.flatnonzero(st["cell_atom_mask"].numpy() > 0))
    nbl.build(system)                         # host build, same positions
    assert dev_edges == _state_edges(nbl)


def test_maybe_rebuild_falls_back_to_the_host_on_overflow():
    system, nbl, conv, rng = _nbl_system(seed=5)
    nbl.build(system)
    K0 = nbl._K
    nbl._dev_rebuild["ks"] = tuple(8 for _ in K0)   # force a bucket overflow
    moved = system.positions + 0.3 * conv
    with pytest.warns(RuntimeWarning, match="overflow"):
        assert nbl.maybe_rebuild(system.replace(positions=moved))
    assert (nbl.n_builds, nbl.n_device_builds, nbl.n_device_overflows) == (
        2, 0, 1)
    assert nbl._dev_rebuild["ks"] == nbl._K == K0
