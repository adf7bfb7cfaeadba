"""PyTorch port, ops level: the layout builder, the fused message op and the
fused mixing op against the JAX package (XLA path on the CPU).  The CUDA
kernels are held against their twins in ``test_torch_port_kernels.py``.

Inputs are made with numpy from fixed seeds and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu.ops import colblock as jcb
from schnetpack_tpu.ops import colblock_geo as jgeo
from schnetpack_tpu.ops.cellblock import build_column_layout as jax_build
from schnetpack_tpu.ops.painn_mixing import painn_mixing_xla
from schnetpack_tpu.ops.radial import gaussian_rbf_params
from schnetpack_tpu.transform.neighborlist import neighbor_list as jax_brute
from schnetpack_tpu_torch.ops import colblock_message as msg
from schnetpack_tpu_torch.ops import painn_mixing as mix
from schnetpack_tpu_torch.ops.cellblock import build_column_layout
from schnetpack_tpu_torch.transform.neighborlist import (
    cell_list_neighbor_list,
)
from torch_port_cases import (
    MIX_ATOL, MIX_INPUTS, MIX_RTOL, MSG_ATOL, MSG_RTOL, message_case,
    mixing_case, random_box, torch_message_args,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


BOXES = [  # (n, L, cutoff, seed, min_grid)
    (120, 12.0, 3.5, 0, 1),
    (120, 12.0, 3.5, 0, 3),
    (80, 10.0, 3.2, 1, 1),
    (300, 14.0, 3.0, 2, 1),
    (200, 13.0, 3.2, 4, 3),
]


def _bucket_sets(lay):
    """Per (column, bucket): set of (dest row, source row, offset)."""
    nx, ny, P, ks = lay.dims
    koffs = np.concatenate([[0], np.cumsum(ks)])
    out = {}
    for x in range(nx):
        for y in range(ny):
            for c9 in range(9):
                sl = slice(koffs[c9], koffs[c9 + 1])
                q, d = lay.qcol[x, y, sl], lay.dcol[x, y, sl]
                off = np.round(lay.offcol[x, y, sl], 4)
                m = q >= 0
                out[(x, y, c9)] = sorted(
                    (int(a), int(b), *o) for a, b, o in
                    zip(d[m], q[m], off[m]))
    return out


@pytest.mark.parametrize("n,L,cutoff,seed,min_grid", BOXES)
def test_layout_matches_jax(n, L, cutoff, seed, min_grid):
    R, cell = random_box(n, L, seed)
    pbc = np.ones(3, bool)
    lj = jax_build(R, cutoff, cell, pbc, min_grid=min_grid)
    lt = build_column_layout(R, cutoff, cell, pbc, min_grid=min_grid)
    assert lt.dims == lj.dims
    np.testing.assert_array_equal(lt.order, lj.order)
    np.testing.assert_array_equal(lt.rank, lj.rank)
    np.testing.assert_array_equal(lt.slot_mask, lj.slot_mask)
    assert _bucket_sets(lt) == _bucket_sets(lj)


@pytest.mark.parametrize("n,L,cutoff,seed,min_grid", BOXES)
def test_layout_edges_match_brute_force(n, L, cutoff, seed, min_grid):
    R, cell = random_box(n, L, seed)
    lay = build_column_layout(R, cutoff, cell, np.ones(3, bool),
                              min_grid=min_grid)
    ii, jj, S = jax_brute(R, cutoff, cell, np.ones(3, bool))
    m = lay.emask > 0
    got = sorted((int(lay.order[a]), int(lay.order[b]), *np.round(o, 4))
                 for a, b, o in zip(lay.icol[m], lay.jcol[m], lay.offcol[m]))
    want = sorted((int(a), int(b), *np.round(o, 4))
                  for a, b, o in zip(ii, jj, S @ cell))
    assert got == want


@pytest.mark.parametrize("periodic", [True, False])
def test_cell_list_matches_brute_force(periodic):
    rng = np.random.RandomState(7)
    R = rng.uniform(0, 13.0, size=(150, 3))
    cell = np.eye(3) * 13.0 if periodic else None
    pbc = np.ones(3, bool) if periodic else None
    got = cell_list_neighbor_list(R, 4.0, cell, pbc)
    want = jax_brute(R, 4.0, cell, pbc)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _jax_message(c):
    lay = c["lay"]
    refs = jcb.ColRefs.from_layout(lay)
    centers, widths = gaussian_rbf_params(c["B"], c["cutoff"], 0.0)
    coff = jnp.asarray(c["coff_fm"])

    def f(x, mu, R, fw):
        geo = jgeo.column_geometry(R, coff, refs, centers, widths,
                                   c["cutoff"])
        return jcb.painn_message_columns_fm(x, mu, geo, fw, refs)

    args = [jnp.asarray(c[k]) for k in ("x", "mu", "Rs", "FW")]
    out, vjp = jax.vjp(f, *args)
    grads = vjp((jnp.asarray(c["g_dq"]), jnp.asarray(c["g_dmu"])))
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


def test_message_value_and_grads_match_jax():
    c = message_case()
    (jdq, jdmu), jgrads = _jax_message(c)
    t, refs, cw = torch_message_args(c)
    ins = [t[k].requires_grad_(True) for k in ("x", "mu", "Rs", "FW")]
    dq, dmu = msg.painn_message_columns_full_fused(
        ins[0], ins[1], ins[2], ins[3], t["coff_fm"], cw, refs, c["cutoff"])
    np.testing.assert_allclose(dq.detach(), jdq, MSG_RTOL, MSG_ATOL)
    np.testing.assert_allclose(dmu.detach(), jdmu, MSG_RTOL, MSG_ATOL)
    grads = torch.autograd.grad((dq, dmu), ins, (t["g_dq"], t["g_dmu"]))
    for name, g, jg in zip(("x", "mu", "R", "FW"), grads, jgrads):
        np.testing.assert_allclose(g, jg, MSG_RTOL, MSG_ATOL,
                                   err_msg=f"grad {name}")


def test_message_bwd_twin_matches_autograd():
    c = message_case(seed=1)
    _, jgrads = _jax_message(c)
    t, refs, cw = torch_message_args(c)
    grads = msg.msg_bwd_plain(t["x"], t["mu"], t["Rs"], t["FW"],
                              t["coff_fm"], cw, refs, c["cutoff"],
                              t["g_dq"], t["g_dmu"])
    assert len(grads) == 4
    for name, g, jg in zip(("x", "mu", "R", "FW"), grads, jgrads):
        np.testing.assert_allclose(g, jg, MSG_RTOL, MSG_ATOL,
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("A,act", [(37, "ssp"), (64, "ssp"), (21, "silu")])
def test_mixing_value_and_grads_match_jax(A, act):
    c = mixing_case(A=A)
    args = [jnp.asarray(c[k]) for k in MIX_INPUTS]
    (jq, jmu), vjp = jax.vjp(
        lambda *a: painn_mixing_xla(*a, 1e-8, act), *args)
    jgrads = vjp((jnp.asarray(c["gq"]), jnp.asarray(c["gmu"])))
    ins = [torch.tensor(c[k], requires_grad=True) for k in MIX_INPUTS]
    q_out, mu_out = mix.painn_mixing_fused(*ins, 1e-8, act)
    np.testing.assert_allclose(q_out.detach(), jq, MIX_RTOL, MIX_ATOL)
    np.testing.assert_allclose(mu_out.detach(), jmu, MIX_RTOL, MIX_ATOL)
    grads = torch.autograd.grad((q_out, mu_out), ins,
                                (torch.tensor(c["gq"]), torch.tensor(c["gmu"])))
    for name, g, jg in zip(MIX_INPUTS, grads, jgrads):
        jg = np.asarray(jg)
        # weight cotangents are sums over all rows of O(10) terms: their
        # absolute error scales with the largest entry, not with each one
        atol = MIX_ATOL if name in ("q", "mu", "dq", "dmu") else (
            MIX_ATOL * np.abs(jg).max())
        np.testing.assert_allclose(g, jg, MIX_RTOL, atol,
                                   err_msg=f"grad {name}")
    # the K4 twin returns the (shared) cotangents of q + dq and mu + dmu
    gq, gmu = mix.painn_mixing_bwd_plain(
        *[torch.tensor(c[k]) for k in MIX_INPUTS], 1e-8, act,
        torch.tensor(c["gq"]), torch.tensor(c["gmu"]))
    np.testing.assert_allclose(gq, np.asarray(jgrads[0]), MIX_RTOL, MIX_ATOL)
    np.testing.assert_allclose(gmu, np.asarray(jgrads[1]), MIX_RTOL,
                               MIX_ATOL)
