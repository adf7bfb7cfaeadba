"""PyTorch port: the launch arguments of the column kernels and the source
rows of the narrow K11, on the CPU.

The bucket offsets that every column kernel takes are made once per bucket
sizes (``ColRefs.koffs`` / ``koffs_arg``) and equal the JAX package's; the
source row of each slot, counted from the cached offsets (``decode_src``)
and by the branch-free arithmetic of the narrow K11
(``csrc/colblock_select.cu::select_narrow_kernel``, modelled here in
numpy), equals the JAX decode in the three source-index modes."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu.ops import colblock as jcb
from schnetpack_tpu.ops.colblock_shard import _decode_hx as jax_decode_hx
from schnetpack_tpu_torch.ops.colblock import ColRefs, decode_src
from schnetpack_tpu_torch.ops.colblock_shard import COLS_AXIS, COLS_AXIS_Y
from torch_port_cases import message_case, slab_case

MODES = {"wrap": None, "halo_x": COLS_AXIS,
         "halo_xy": (COLS_AXIS, COLS_AXIS_Y)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 3])
def test_bucket_offsets_are_the_cumulative_sizes(seed):
    lay = message_case(seed=seed)["lay"]
    refs = ColRefs.from_layout(lay)
    want = (0, *np.cumsum(refs.ksizes).tolist())
    assert refs.koffs == want == jcb.ColRefs.from_layout(lay).koffs
    assert len(refs.koffs_arg) == 10
    assert list(refs.koffs_arg) == list(want)
    assert refs.koffs[-1] == refs.qcol.shape[2]


def test_bucket_offsets_are_made_once():
    lay = message_case()["lay"]
    refs = ColRefs.from_layout(lay)
    arg = refs.koffs_arg
    assert refs.koffs_arg is arg and refs.koffs is refs.koffs
    # refs of the same layout (one per force evaluation) share them
    assert ColRefs.from_layout(lay).koffs_arg is arg


def test_replace_with_other_ksizes_gets_fresh_offsets():
    refs = ColRefs.from_layout(message_case()["lay"])
    old, arg = refs.koffs, refs.koffs_arg
    other = tuple(k + 8 * (c9 % 2) for c9, k in enumerate(refs.ksizes))
    moved = dataclasses.replace(refs, ksizes=other)
    assert moved.cache is refs.cache          # replace keeps the dict
    want = (0, *np.cumsum(other).tolist())
    assert moved.koffs == want and list(moved.koffs_arg) == list(want)
    assert moved.koffs_arg is not arg
    assert refs.koffs == old and list(refs.koffs_arg) == list(old)


def narrow_kernel_rows(refs):
    """The source row of every slot as the narrow K11 forms it: the bucket
    from 8 compares, dx from the row boundaries 3 and 6, the wrap by
    compare; -1 at padded slots."""
    q = refs.qcol.numpy()
    nx, ny, Ktot = q.shape
    hx, hy = refs.halo
    o = np.asarray(refs.koffs)
    k = np.arange(Ktot)
    b = [(k >= o[i]).astype(np.int64) for i in range(9)]
    dx = b[3] + b[6] - 1
    dy = b[1] + b[2] + b[4] + b[5] + b[7] + b[8] - 2 * (dx + 1) - 1
    x = np.arange(nx)[:, None, None]
    y = np.arange(ny)[None, :, None]
    xs, ys = x + dx + hx, y + dy + hy
    if not hx:
        xs = xs + np.where(xs < 0, nx, np.where(xs >= nx, -nx, 0))
    if not hy:
        ys = ys + np.where(ys < 0, ny, np.where(ys >= ny, -ny, 0))
    rows = (xs * (ny + 2 * hy) + ys) * refs.P + q
    return np.where(q >= 0, rows, -1)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("grid", [(3, 3), (2, 3), (2, 2)])
def test_source_rows_match_jax(mode, grid):
    """``decode_src`` (through the cached offsets) and the narrow K11's
    arithmetic against the JAX decode, on plain and aliased grids."""
    lay = slab_case(grid, seed=sum(grid))["lay"]
    refs = dataclasses.replace(ColRefs.from_layout(lay),
                               shard_axis=MODES[mode])
    jrefs = jcb.ColRefs.from_layout(lay)
    if mode == "wrap":
        jj, jvalid = jcb._decode_j(jrefs)
    else:
        jj, jvalid = jax_decode_hx(jnp.asarray(lay.qcol), jrefs.ksizes,
                                   grid[1], jrefs.P, mode == "halo_xy")
    want = np.where(np.asarray(jvalid), np.asarray(jj), -1)
    j, valid = decode_src(refs)
    np.testing.assert_array_equal(np.where(valid.numpy(), j.numpy(), -1),
                                  want)
    np.testing.assert_array_equal(narrow_kernel_rows(refs), want)
    assert (want >= 0).any() and (want < refs.src_rows).all()


def select_args(refs):
    from schnetpack_tpu_torch.ops import colblock_select as sel

    *dims, addr = sel._check_refs(refs)
    a = sel.SelectArgs.from_address(addr)
    return dims, (a.nx, a.ny, a.P, a.Ktot, tuple(a.koffs), a.hx, a.hy)


def test_select_wrappers_make_their_launch_arguments_once(monkeypatch):
    """K11/K13's launch arguments (``SelectArgs``: grid, capacity, slots,
    bucket offsets, source-index mode) are made, and the refs' index
    tensors checked, once per (qcol, dcol, P, ksizes, mode), also across
    ``dataclasses.replace``, and again when one of them changes."""
    from schnetpack_tpu_torch.ops import _build
    from schnetpack_tpu_torch.ops import colblock_select as sel

    checked = []
    monkeypatch.setattr(_build, "check",
                        lambda t, name, *a, **k: checked.append(name))
    refs = ColRefs.from_layout(message_case()["lay"])
    nx, ny, Ktot = refs.qcol.shape
    Ap = nx * ny * refs.P
    args = (nx, ny, refs.P, Ktot, refs.koffs, 0, 0)
    assert select_args(refs) == ([nx, ny, Ktot, Ap, Ap], args)
    assert checked == ["qcol", "dcol"]
    assert sel._check_refs(refs) is sel._check_refs(refs)
    assert len(checked) == 2
    halo = dataclasses.replace(refs, shard_axis=(COLS_AXIS, COLS_AXIS_Y))
    assert select_args(halo) == ([nx, ny, Ktot, Ap, halo.src_rows],
                                 args[:5] + (1, 1))
    assert halo.src_rows == (nx + 2) * (ny + 2) * refs.P
    wider = dataclasses.replace(refs, P=refs.P + 8)
    assert select_args(wider)[1][2] == refs.P + 8
    other = tuple(k + 8 * (c9 % 2) for c9, k in enumerate(refs.ksizes))
    assert select_args(dataclasses.replace(refs, ksizes=other))[1][4] == (
        0, *np.cumsum(other).tolist())
    moved = dataclasses.replace(refs, qcol=refs.qcol.clone())
    assert select_args(moved) == ([nx, ny, Ktot, Ap, Ap], args)
    assert checked == ["qcol", "dcol"] * 5
