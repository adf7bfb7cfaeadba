"""PyTorch port, SchNet column path: the raw-phi geometry (K5's raw form)
and its VJP (K8's twin), the fused cfconv (K9/K10's twins inside one
autograd Function), the whole SchNet against the JAX
``NeuralNetworkPotential(SchNet)`` on the flat pair list, a short MD run,
and the full-size fixture.  The CUDA kernels are held against their twins
in ``test_torch_port_kernels.py``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.atomistic import Atomwise as JAtomwise
from schnetpack_tpu.atomistic import Forces as JForces
from schnetpack_tpu.atomistic import PairwiseDistances
from schnetpack_tpu.data.loader import collate, padding_for
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.ops import colblock as jcb
from schnetpack_tpu.ops import colblock_geo as jgeo
from schnetpack_tpu.ops.activations import shifted_softplus as jssp
from schnetpack_tpu.ops.radial import gaussian_rbf_params
from schnetpack_tpu.ops.schnet_columns import _cfconv_xla
from schnetpack_tpu.representation import SchNet as JSchNet
from schnetpack_tpu.transform.neighborlist import NeighborListTransform
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.atomistic import Atomwise, Forces
from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
from schnetpack_tpu_torch.md import (
    CellBlockNeighborListMD, MaxwellBoltzmannInit, Simulator, VelocityVerlet,
    load_molecules,
)
from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.ops import colblock_geo as geo_op
from schnetpack_tpu_torch.ops import schnet_columns as cf
from schnetpack_tpu_torch.ops.activations import shifted_softplus
from schnetpack_tpu_torch.ops.colblock import ColRefs
from schnetpack_tpu_torch.representation import SchNet
from schnetpack_tpu_torch.units import _parse_unit, md_units
from torch_port_cases import (
    MSG_ATOL, MSG_RTOL, cfconv_case, message_case, torch_message_args,
)
from test_torch_port_model import ROOT, fcc_box, port_inputs

ASSET = os.path.join(ROOT, "scripts", "assets", "bench_schnet_argon.msgpack")
FIXTURE = os.path.join(ROOT, "tests", "data", "port_ref_schnet_argon.npz")
CUTOFF = 5.0
# geometry and its VJP: the same f32 formulas in both packages
GEO_RTOL, GEO_ATOL = 1e-4, 1e-5
# cfconv gradients: the JAX test's own tolerance (tests/test_schnet_columns.py)
CF_GRAD_TOL = 2e-3
# whole model: energy, relative; forces, max abs over the max |F|
E_RTOL = 1e-5
F_SCALED_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_shifted_softplus_matches_jax():
    z = np.linspace(-40.0, 40.0, 4001).astype(np.float32)
    np.testing.assert_allclose(shifted_softplus(torch.tensor(z)).numpy(),
                               np.asarray(jssp(jnp.asarray(z))),
                               rtol=1e-6, atol=1e-7)


def _jax_raw_geo(c):
    refs = jcb.ColRefs.from_layout(c["lay"])
    centers, widths = gaussian_rbf_params(c["B"], c["cutoff"], 0.0)

    def f(R):
        return jgeo.concat_geo(jgeo.column_geometry_xla(
            R, jnp.asarray(c["coff_fm"]), refs, centers, widths,
            c["cutoff"], raw_phi=True))

    return f


@pytest.mark.parametrize("seed", [0, 3])
def test_raw_geometry_matches_jax(seed):
    c = message_case(seed=seed)
    t, refs, cw = torch_message_args(c)
    geo = geo_op.geo_fwd_plain(t["Rs"], t["coff_fm"], refs, cw, c["cutoff"],
                               with_d=False, raw_phi=True)
    want = np.asarray(_jax_raw_geo(c)(jnp.asarray(c["Rs"])))
    assert geo.shape == want.shape == (*refs.qcol.shape[:2], c["B"] + 4,
                                       refs.qcol.shape[2])
    np.testing.assert_allclose(geo.numpy(), want, GEO_RTOL, GEO_ATOL)
    # raw: phi is not cut off, so real edges beyond the cutoff keep it
    g = np.moveaxis(geo.numpy(), 2, 3)
    real, B = (refs.qcol >= 0).numpy(), c["B"]
    beyond = real & (g[..., B] == 0.0)
    assert beyond.any() and (g[beyond][:, :B] > 0).any()
    np.testing.assert_array_equal(g[~real], 0.0)
    # the per-bucket tuple of the JAX package, concatenated, is the layout
    parts = jgeo.split_geo(jnp.asarray(want), refs.ksizes)
    np.testing.assert_array_equal(np.asarray(jgeo.concat_geo(parts)), want)


@pytest.mark.parametrize("seed", [0, 3])
def test_raw_geometry_vjp_matches_jax(seed):
    c = message_case(seed=seed)
    t, refs, cw = torch_message_args(c)
    nx, ny, Ktot = refs.qcol.shape
    g = np.random.RandomState(seed + 7).randn(
        nx, ny, c["B"] + 4, Ktot).astype(np.float32)
    _, vjp = jax.vjp(_jax_raw_geo(c), jnp.asarray(c["Rs"]))
    (want,) = vjp(jnp.asarray(g))
    gt = torch.tensor(g)
    dR = geo_op.geo_bwd_plain(gt, t["Rs"], t["coff_fm"], refs, cw,
                              c["cutoff"])
    np.testing.assert_allclose(dR.numpy(), np.asarray(want), GEO_RTOL,
                               GEO_ATOL)
    # the autograd Function (twins on the CPU) carries the same VJP
    R = t["Rs"].clone().requires_grad_(True)
    geo = geo_op.column_geometry_raw(R, t["coff_fm"], refs, cw, c["cutoff"])
    (dR_op,) = torch.autograd.grad(geo, R, gt)
    torch.testing.assert_close(dR_op, dR, rtol=0, atol=0)


def _jax_cfconv(c):
    refs = jcb.ColRefs.from_layout(c["lay"])
    geo = jgeo.split_geo(jnp.asarray(c["geo"]), refs.ksizes)
    args = [jnp.asarray(c[k]) for k in ("h",)] + [geo] + [
        jnp.asarray(c[k]) for k in ("W1", "b1", "W2", "b2")]
    out, vjp = jax.vjp(lambda *a: _cfconv_xla(*a, refs), *args)
    grads = vjp(jnp.asarray(c["g"]))
    ggeo = np.asarray(jgeo.concat_geo(grads[1]))
    return np.asarray(out), [np.asarray(grads[0]), ggeo] + [
        np.asarray(x) for x in grads[2:]]


@pytest.mark.parametrize("seed", [3, 21])
def test_cfconv_value_and_grads_match_jax(seed):
    c = cfconv_case(seed=seed)
    want, wgrads = _jax_cfconv(c)
    refs = ColRefs.from_layout(c["lay"])
    names = ("h", "geo", "W1", "b1", "W2", "b2")
    ins = [torch.tensor(c[k]).requires_grad_(True) for k in names]
    out = cf.schnet_cfconv_columns(*ins, refs)
    np.testing.assert_allclose(out.detach().numpy(), want, MSG_RTOL,
                               MSG_ATOL)
    grads = torch.autograd.grad(out, ins, torch.tensor(c["g"]))
    for name, g, jg in zip(names, grads, wgrads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=CF_GRAD_TOL,
                                   atol=CF_GRAD_TOL, err_msg=f"grad {name}")
    # the geometry cotangent is zero in the dir channels and padded slots
    gg = np.moveaxis(grads[1].numpy(), 2, 3)
    np.testing.assert_array_equal(gg[..., c["B"] + 1:], 0.0)
    np.testing.assert_array_equal(gg[(refs.qcol < 0).numpy()], 0.0)
    # the twins by themselves
    t = [torch.tensor(c[k]) for k in names]
    torch.testing.assert_close(cf.cf_fwd_plain(*t, refs), out.detach())
    for g, w in zip(cf.cf_bwd_plain(*t, refs, torch.tensor(c["g"])), grads):
        torch.testing.assert_close(g, w)


# ------------------------------------------------------------------ model
def _jax_potential(F, T, B):
    return JNNP(
        representation=JSchNet(n_atom_basis=F, n_interactions=T, n_rbf=B,
                               cutoff=CUTOFF),
        input_modules=[PairwiseDistances()],
        output_modules=[JAtomwise(output_key=P.energy), JForces()])


def _jax_batch(R, cell):
    sample = NeighborListTransform(CUTOFF)({
        P.Z: np.full(len(R), 18, np.int64), P.R: R, P.cell: cell,
        P.pbc: np.ones(3, bool)})
    return collate([sample], padding_for([sample]))


def port_schnet(params=None, F=128, T=3, B=20):
    pot = NeuralNetworkPotential(
        SchNet(n_atom_basis=F, n_interactions=T, n_rbf=B, cutoff=CUTOFF),
        [Atomwise(n_in=F), Forces()])
    if params is not None:
        pot.load_state_dict(params)
    return pot.requires_grad_(False)


def _compare_with_jax(R, cell, tree, F, T, B):
    out = _jax_potential(F, T, B).apply(tree, _jax_batch(R, cell))
    E_ref = float(np.asarray(out[P.energy])[0])
    F_ref = np.asarray(out[P.forces])[:len(R)]
    lay, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    assert lay.dims[0] >= 3 and lay.dims[1] >= 3
    got = port_schnet(params_from_jax(tree), F, T, B)(inputs)
    E = float(got[TP.energy][0])
    Fp = got[TP.forces].numpy()[lay.rank]
    np.testing.assert_allclose(E, E_ref, rtol=E_RTOL)
    scale = np.abs(F_ref).max()
    assert scale > 0
    assert np.abs(Fp - F_ref).max() / scale <= F_SCALED_ATOL
    return Fp


def _box(n_cells, seed, jitter):
    rng = np.random.RandomState(seed)
    R, cell = fcc_box(n_cells)
    return R + rng.uniform(-jitter, jitter, R.shape), cell


def test_small_schnet_matches_jax():
    """F=32, 2 interactions, B=8, seeded flax init."""
    R, cell = _box(3, seed=1, jitter=0.3)
    # 3 unit cells = 15.8 A: the column grid needs 3 columns of >= 5.6 A,
    # so stretch the box a little
    R, cell = R * 1.1, cell * 1.1
    params = _jax_potential(32, 2, 8).init(jax.random.PRNGKey(0),
                                           _jax_batch(R, cell))
    _compare_with_jax(R, cell, jax.device_get(params), 32, 2, 8)


def test_schnet_bench_asset_matches_jax():
    R, cell = _box(4, seed=0, jitter=0.15)
    Fp = _compare_with_jax(R, cell, load_jax_params(ASSET), 128, 3, 20)
    assert np.abs(Fp).max() > 0.05   # a force field worth comparing


def test_params_from_jax_covers_every_schnet_parameter():
    params = params_from_jax(load_jax_params(ASSET))
    state = port_schnet().state_dict()
    assert set(params) == set(state)
    for k, v in params.items():
        assert v.shape == state[k].shape, k
    assert params["representation.interactions.0.filter_0.weight"].shape \
        == (128, 20)
    assert "representation.interactions.2.in2f.bias" not in params


def test_schnet_md_20_steps():
    """20 NVE steps of the 256-atom box through ``SchNetPackCalculator``:
    finite positions and a bounded total-energy drift."""
    R, cell = _box(4, seed=3, jitter=0.05)
    conv = _parse_unit("Ang") * md_units().length
    mol = {TP.Z: np.full(len(R), 18, np.int64), TP.R: R, TP.cell: cell,
           TP.pbc: np.ones(3, bool)}
    system = MaxwellBoltzmannInit(30.0).initialize_system(
        load_molecules([mol], device="cpu"),
        torch.Generator().manual_seed(0))
    nbl = CellBlockNeighborListMD(CUTOFF * conv, skin=0.6 * conv)
    calc = SchNetPackCalculator(port_schnet(),
                                params_from_jax(load_jax_params(ASSET)),
                                cutoff=CUTOFF, cutoff_shell=0.6,
                                neighbor_list=nbl)
    sim = Simulator(system, VelocityVerlet(0.5), calc)
    sim.simulate(20, chunk_size=20)
    s = sim.system
    assert torch.isfinite(s.positions).all()
    E_pot = sim.logs[0]["energy"][:, 0, 0]
    T = sim.logs[0]["temperature"][:, 0, 0]
    E_tot = (E_pot + 1.5 * len(R) * md_units().kB * T) \
        / calc.energy_conversion
    assert np.abs(E_tot - E_tot[0]).max() / len(R) <= 1e-4
    assert 0.0 < float(s.temperature.mean()) < 300.0


def test_schnet_reference_fixture_is_the_bench_box():
    """The full-size fixture (``scripts/make_port_reference_schnet.py``)
    holds the jittered 10,976-atom bench box with finite energy and forces
    whose net force vanishes."""
    ref = np.load(FIXTURE)
    R0, cell = fcc_box(14)
    assert ref["R"].shape == (10976, 3) and ref["forces"].shape == (10976, 3)
    np.testing.assert_allclose(ref["cell"], cell)
    jitter = ref["R"] - R0
    assert np.abs(jitter).max() <= float(ref["jitter"]) + 1e-5
    assert np.isfinite(ref["energy"]) and np.isfinite(ref["forces"]).all()
    assert np.abs(ref["forces"].sum(0)).max() < 1e-2
    assert int(ref["n_pairs"]) > 0


@pytest.mark.parametrize("P,bwd", [(154, True), (1000, True), (222, False),
                                   (1000, False)])
def test_cfconv_kernel_capacity_limit(P, bwd):
    """Neither cfconv kernel keeps a column's rows in shared memory, so
    both take any column capacity: K10 at P = 154 (past its old limit of
    153) and P = 1000, K9 at P = 222 (past its old limit of 221 at B = 20)
    and P = 1000.  At both widths and B = 20 their shared memory (the
    larger of K10's two instances) is within the 232,448-byte opt-in
    limit and the wrappers' check passes; the schedule they launch on at
    that capacity cuts every column's P rows into ``min(RANGES, P)``
    ranges that cover each row once and hold every real slot."""
    for F in cf.N_FILTERS:
        need = max(cf.cf_smem_bytes(F, 20, bwd, w) for w in (False, bwd))
        assert need <= 232_448, (F, need)
        cf.check_width(F, 20)
        assert cf.tuned_width(F, 20)
    for F in (30, 96, 512):   # the general instances take every other F
        cf.check_width(F, 20)
        assert not cf.tuned_width(F, 20)
    c = cfconv_case(F=128, B=20, seed=3)
    refs = dataclasses.replace(ColRefs.from_layout(c["lay"]), P=P, cache={})
    _, grp, G = (cf._bwd_schedule(refs, False) if bwd
                 else cf._fwd_schedule(refs))
    assert G == min(cf.BWD_RANGES if bwd else cf.FWD_RANGES, P)
    rows, slots = grp[..., 0], grp[..., 1]
    assert bool((rows[:, 0] == 0).all()) and bool((rows[:, -1] == P).all())
    assert bool((rows.diff(dim=1) >= 0).all())
    assert int(slots[-1, -1] - slots[0, 0]) == int((refs.qcol >= 0).sum())

