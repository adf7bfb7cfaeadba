"""PyTorch port, hybrid PaiNN message path: the packed geometry (K5's twin),
the geo-resident message op (K6/K7's twins inside one autograd Function)
and the whole PaiNN-128x3 in both ``fuse`` modes, against the JAX package
(XLA path on the CPU) and against each other.  The CUDA kernels are held
against their twins in ``test_torch_port_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu.ops import colblock as jcb
from schnetpack_tpu.ops import colblock_geo as jgeo
from schnetpack_tpu.ops.radial import gaussian_rbf_params
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
from schnetpack_tpu_torch.ops import colblock_message as msg
from schnetpack_tpu_torch.ops.colblock_geo import (
    column_geometry_packed, geo_fwd_plain,
)
from torch_port_cases import (
    MSG_ATOL, MSG_RTOL, message_case, torch_message_args,
)
from test_torch_port_model import (
    ASSET, CUTOFF, fcc_box, port_inputs, port_potential,
)

# geometry: the same f32 formulas in both packages, elementwise
GEO_RTOL, GEO_ATOL = 1e-5, 1e-6
# hybrid vs full PaiNN forces: both take dR from f32 message backwards
# that sum the same terms in another order
HYBRID_FULL_ATOL = 1e-5   # eV/Ang, max abs


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_geo(c, with_d=True):
    refs = jcb.ColRefs.from_layout(c["lay"])
    centers, widths = gaussian_rbf_params(c["B"], c["cutoff"], 0.0)
    return np.asarray(jgeo.concat_geo(jgeo.column_geometry_xla(
        jnp.asarray(c["Rs"]), jnp.asarray(c["coff_fm"]), refs, centers,
        widths, c["cutoff"], with_d=with_d)))


@pytest.mark.parametrize("seed,with_d", [(0, True), (3, True), (3, False)])
def test_geometry_matches_jax(seed, with_d):
    c = message_case(seed=seed)
    t, refs, cw = torch_message_args(c)
    geo = geo_fwd_plain(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"],
                        with_d=with_d)
    want = _jax_geo(c, with_d)
    assert geo.shape == want.shape == (*refs.qcol.shape[:2], c["B"] + 4
                                       + with_d, refs.qcol.shape[2])
    np.testing.assert_allclose(geo.numpy(), want, GEO_RTOL, GEO_ATOL)
    pad = (refs.qcol < 0).numpy()
    assert pad.any(), "the case has no padded slots"
    padded = np.moveaxis(geo.numpy(), 2, 3)[pad]
    np.testing.assert_array_equal(padded[:, :c["B"] + 4], 0.0)
    if with_d:
        np.testing.assert_array_equal(padded[:, -1], 1.0)
    # CPU tensors take the twin
    np.testing.assert_array_equal(
        column_geometry_packed(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"],
                               with_d).numpy(), geo.numpy())


def _jax_message_through_geometry(c):
    """jax.vjp of the XLA composition geometry -> message (the reference
    of ``tests/test_colblock.py::loss_ref``): dR flows through the
    geometry."""
    refs = jcb.ColRefs.from_layout(c["lay"])
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


@pytest.mark.parametrize("seed", [0, 3])
def test_hybrid_message_value_and_grads_match_jax(seed):
    c = message_case(seed=seed)
    t, refs, cw = torch_message_args(c)
    with torch.no_grad():
        geo = column_geometry_packed(t["Rs"], t["coff_fm"], refs, cw,
                                     c["cutoff"], with_d=True)
    # edges within 0.05 A of the cutoff on both sides (the sin / fcut
    # chain at its ends)
    d = geo[:, :, -1][refs.qcol >= 0]
    assert ((d > c["cutoff"] - 0.05) & (d < c["cutoff"])).any()
    assert ((d >= c["cutoff"]) & (d < c["cutoff"] + 0.05)).any()

    (jdq, jdmu), jgrads = _jax_message_through_geometry(c)
    ins = [t[k].requires_grad_(True) for k in ("x", "mu", "Rs", "FW")]
    dq, dmu = msg.painn_message_columns_fm_geores(
        ins[0], ins[1], ins[2], geo, ins[3], t["coff_fm"], cw, refs,
        c["cutoff"])
    np.testing.assert_allclose(dq.detach(), jdq, MSG_RTOL, MSG_ATOL)
    np.testing.assert_allclose(dmu.detach(), jdmu, MSG_RTOL, MSG_ATOL)
    grads = torch.autograd.grad((dq, dmu), ins, (t["g_dq"], t["g_dmu"]))
    for name, g, jg in zip(("x", "mu", "R", "FW"), grads, jgrads):
        np.testing.assert_allclose(g, jg, MSG_RTOL, MSG_ATOL,
                                   err_msg=f"grad {name}")


def test_geores_twins_match_full_twins():
    """K6's and K7's twins on the geo against K1's and K2's twins on the
    positions (the two forms of one function)."""
    c = message_case(seed=1)
    t, refs, cw = torch_message_args(c)
    geo = geo_fwd_plain(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"])
    full = (t["x"], t["mu"], t["Rs"], t["FW"], t["coff_fm"], cw, refs,
            c["cutoff"])
    for got, want in zip(
            msg.msg_fwd_geo_plain(t["x"], t["mu"], geo, t["FW"], refs),
            msg.msg_fwd_plain(*full)):
        torch.testing.assert_close(got, want, rtol=MSG_RTOL, atol=MSG_ATOL)
    got = msg.msg_bwd_geores_plain(t["x"], t["mu"], geo, t["FW"], cw, refs,
                                   c["cutoff"], t["g_dq"], t["g_dmu"])
    want = msg.msg_bwd_plain(*full, t["g_dq"], t["g_dmu"])
    for name, g, w in zip(("dx", "dmu", "dR"), got[:3], want):
        torch.testing.assert_close(g, w, rtol=MSG_RTOL, atol=MSG_ATOL,
                                   msg=lambda m: f"{name}: {m}")


def test_geo_with_history_is_refused():
    c = message_case()
    t, refs, cw = torch_message_args(c)
    R = t["Rs"].requires_grad_(True)
    geo = column_geometry_packed(R, t["coff_fm"], refs, cw, c["cutoff"])
    with pytest.raises(ValueError, match="no_grad"):
        msg.painn_message_columns_fm_geores(
            t["x"], t["mu"], R, geo, t["FW"], t["coff_fm"], cw, refs,
            c["cutoff"])


def test_hybrid_forces_equal_full_forces():
    """PaiNN-128x3 with the bench asset: the hybrid forces equal the full
    ones (not twice them: the geometry carries no gradient)."""
    rng = np.random.RandomState(5)
    R, cell = fcc_box(4)
    R = R + rng.uniform(-0.15, 0.15, R.shape)
    params = params_from_jax(load_jax_params(ASSET))
    lay, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    out = {fuse: port_potential(params, fuse)(dict(inputs))
           for fuse in ("full", "hybrid")}
    np.testing.assert_allclose(out["hybrid"][TP.energy].numpy(),
                               out["full"][TP.energy].numpy(), rtol=1e-6)
    F_h, F_f = out["hybrid"][TP.forces], out["full"][TP.forces]
    assert float((F_h - F_f).abs().max()) <= HYBRID_FULL_ATOL
    assert float(F_f.abs().max()) > 0.1   # a force field worth comparing
