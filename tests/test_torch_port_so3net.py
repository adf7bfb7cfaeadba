"""PyTorch port, SO3net column path: the SO(3) ops (spherical harmonics,
the sympy-free CG table, the tensor product), the generic column gather,
expand and fold (K11-K14's twins inside their autograd Functions), the
convolution, the whole SO3net against the JAX package's column path, the
trained bench asset, a short MD run and the full-size fixture.  The CUDA
kernels are held against their twins in ``test_torch_port_kernels.py``.

Inputs are made with numpy from fixed seeds and handed to both packages;
the JAX package runs its XLA path (``IMPL="xla"``) on the CPU.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.atomistic import Atomwise as JAtomwise
from schnetpack_tpu.atomistic import Forces as JForces
from schnetpack_tpu.atomistic import PairwiseDistances as JPairwiseDistances
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.nn.so3 import SO3Convolution as JSO3Convolution
from schnetpack_tpu.ops import cellblock as jcellblock
from schnetpack_tpu.ops import colblock as jcb
from schnetpack_tpu.ops import so3 as jso3
from schnetpack_tpu.representation import SO3net as JSO3net
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.atomistic import Atomwise, Forces, PairwiseDistances
from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
from schnetpack_tpu_torch.md import (
    CellBlockNeighborListMD, MaxwellBoltzmannInit, Simulator, VelocityVerlet,
    load_molecules,
)
from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.nn.so3 import SO3Convolution
from schnetpack_tpu_torch.ops import colblock_select as sel
from schnetpack_tpu_torch.ops import so3
from schnetpack_tpu_torch.ops.colblock import ColRefs, decode_j, source_order
from schnetpack_tpu_torch.representation import SO3net
from schnetpack_tpu_torch.units import _parse_unit, md_units
from torch_port_cases import message_case, pair_layout_inputs
from test_torch_port_model import ROOT, fcc_box, port_inputs

ASSET = os.path.join(ROOT, "scripts", "assets", "bench_so3net_argon.msgpack")
FIXTURE = os.path.join(ROOT, "tests", "data", "port_ref_so3net_argon.npz")
CUTOFF = 5.0
# f32 evaluations of the same formulas in both packages
YLM_RTOL, YLM_ATOL = 1e-5, 1e-6
# the CG tables: float64 closed form against sympy's exact values
CG_TOL = 1e-12
# gather / expand: exact copies; fold and the VJPs: f32 sums in another order
SELECT_RTOL, SELECT_ATOL = 1e-6, 1e-6
# convolution and tensor product: f32 contractions in another order
CONV_RTOL, CONV_ATOL = 1e-4, 1e-5
# whole model: energy relative; forces elementwise
E_RTOL = 1e-5
F_RTOL, F_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jcellblock, "IMPL", "xla")


# ------------------------------------------------------------------- SO(3)
@pytest.mark.parametrize("lmax", [1, 2, 3])
def test_real_spherical_harmonics_match_jax(lmax):
    rng = np.random.RandomState(lmax)
    v = rng.randn(500, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v = np.concatenate([v, np.zeros((1, 3))]).astype(np.float32)
    want = np.asarray(jso3.real_spherical_harmonics(jnp.asarray(v), lmax))
    got = so3.real_spherical_harmonics(torch.tensor(v), lmax).numpy()
    assert got.shape == (501, (lmax + 1) ** 2)
    np.testing.assert_allclose(got, want, rtol=YLM_RTOL, atol=YLM_ATOL)


@pytest.mark.parametrize("lmax", [1, 2, 3])
def test_cg_table_matches_sympy_table(lmax):
    want = jso3._cg_dense_np(lmax)
    got = so3.cg_dense_np(lmax)
    np.testing.assert_allclose(got, want, rtol=0, atol=CG_TOL)
    if lmax == 2:
        assert (np.abs(got) > CG_TOL).sum() == 83 and got.size == 729
    # the per-degree split sums back to the table
    split = so3.cg_by_degree(lmax, torch.float64).numpy()
    n = (lmax + 1) ** 2
    np.testing.assert_array_equal(
        split.reshape(n, n, lmax + 1, n).sum(2).transpose(0, 2, 1), got)
    np.testing.assert_array_equal(so3.degree_index(lmax),
                                  jso3.degree_index(lmax))


def test_tensor_product_and_scalar2rsh_match_jax():
    rng = np.random.RandomState(5)
    x1, x2 = (rng.randn(13, 9, 8).astype(np.float32) for _ in range(2))
    want = np.asarray(jso3.so3_tensor_product(
        jnp.asarray(x1), jnp.asarray(x2), jso3.cg_dense(2)))
    got = so3.so3_tensor_product(torch.tensor(x1), torch.tensor(x2),
                                 so3.cg_dense(2))
    np.testing.assert_allclose(got.numpy(), want, CONV_RTOL, CONV_ATOL)
    s = rng.randn(13, 8).astype(np.float32)
    np.testing.assert_array_equal(
        so3.scalar2rsh(torch.tensor(s), 2).numpy(),
        np.asarray(jso3.scalar2rsh(jnp.asarray(s), 2)))


# ------------------------------------------------------- gather/expand/fold
_JAX_OPS = {"gather": jcb._column_gather_xla,
            "expand": jcb._column_expand_xla,
            "fold": jcb._column_fold_xla}
_PORT_OPS = {"gather": sel.column_gather_op, "expand": sel.column_expand_op,
             "fold": sel.column_fold_op}


@pytest.mark.parametrize("op", ["gather", "expand", "fold"])
@pytest.mark.parametrize("D", [3, 36, 128, 384])
def test_select_ops_and_vjps_match_jax(op, D):
    c = message_case(seed=D)
    lay = c["lay"]
    refs, jrefs = ColRefs.from_layout(lay), jcb.ColRefs.from_layout(lay)
    nx, ny, Ktot = lay.qcol.shape
    Ap = len(lay.order)
    rng = np.random.RandomState(D + 1)
    table = rng.randn(Ap, D).astype(np.float32)
    edges = rng.randn(nx, ny, Ktot, D).astype(np.float32)
    x, g = (edges, table) if op == "fold" else (table, edges)

    want, vjp = jax.vjp(lambda t: _JAX_OPS[op](t, jrefs), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x).requires_grad_(True)
    out = _PORT_OPS[op](xt, refs)
    (got_g,) = torch.autograd.grad(out, xt, torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               SELECT_RTOL, SELECT_ATOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               SELECT_RTOL, SELECT_ATOL)
    if op != "fold":    # padded slots select zero rows
        np.testing.assert_array_equal(out.detach().numpy()[lay.qcol < 0], 0)
    # the twins by themselves: K11/K13 forward, K12/K14 backward
    twin_fwd = {"gather": sel.gather_fwd_plain, "expand": sel.expand_fwd_plain,
                "fold": sel.fold_fwd_plain}[op]
    twin_bwd = {"gather": sel.gather_bwd_plain, "expand": sel.fold_fwd_plain,
                "fold": sel.expand_fwd_plain}[op]
    torch.testing.assert_close(twin_fwd(torch.tensor(x), refs), out.detach())
    torch.testing.assert_close(twin_bwd(torch.tensor(g), refs), got_g)


def test_so3net_selects_as_often_as_its_kernels_launch(monkeypatch):
    """One force evaluation runs the gather, expand and fold as the MD step
    on the card launches K11-K14 (their twins stand in here): K11 4, K12 3
    (block 0's input carries no gradient), K13 4, K14 4."""
    counts = dict.fromkeys(sel.LAUNCHES, 0)
    for name in counts:
        def counted(*args, _name=name, _plain=getattr(sel, f"{name}_plain")):
            counts[_name] += 1
            return _plain(*args)
        monkeypatch.setattr(sel, f"{name}_plain", counted)
    R, cell = _box(3, seed=1, jitter=0.3, stretch=1.1)
    _, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    port_so3net(F=8, T=3, B=4)(inputs)
    assert counts == {"gather_fwd": 4, "gather_bwd": 3, "expand_fwd": 4,
                      "fold_fwd": 4}


def test_source_order_runs_are_each_rows_slots():
    """K12's schedule: slot e lies in the run of its source atom j(e)."""
    lay = message_case(seed=4)["lay"]
    refs = ColRefs.from_layout(lay)
    esorted, cnt, rowptr = source_order(refs)
    j, valid = decode_j(refs)
    j, valid = j.reshape(-1).numpy(), valid.reshape(-1).numpy()
    es, rp = esorted.numpy(), rowptr.numpy()
    assert rp[0] == 0 and rp[-1] == valid.sum() == cnt.sum()
    for row in range(len(rp) - 1):
        run = es[rp[row]:rp[row + 1]]
        assert valid[run].all() and (j[run] == row).all()
        assert (np.diff(run) > 0).all()   # slot order within a run


# ------------------------------------------------------------- convolution
def _geometry(c):
    """(x, radial, dirs, fcut) on the layout of a message case."""
    lay = c["lay"]
    rng = np.random.RandomState(11)
    Ap = len(lay.order)
    rij = np.asarray(jcb._column_gather_xla(
        jnp.asarray(c["Rs"]), jcb.ColRefs.from_layout(lay)))
    rij = rij + lay.offcol.astype(np.float32) - np.asarray(
        jcb._column_expand_xla(jnp.asarray(c["Rs"]),
                               jcb.ColRefs.from_layout(lay)))
    d = np.sqrt(np.maximum((rij ** 2).sum(-1), 1e-15))
    dirs = (rij / d[..., None]).astype(np.float32)
    radial = np.exp(-((d[..., None] - np.linspace(0, 3, 6)) ** 2)).astype(
        np.float32)
    fcut = (0.5 * (np.cos(np.pi * d / 3.0) + 1) * (d < 3.0)
            * lay.emask).astype(np.float32)
    x = (rng.randn(Ap, 9, 8) * 0.5).astype(np.float32)
    return x, radial, dirs, fcut


def test_so3_convolution_value_and_grads_match_jax():
    c = message_case(seed=3)
    lay = c["lay"]
    args = _geometry(c)
    jrefs = jcb.ColRefs.from_layout(lay)
    conv = JSO3Convolution(lmax=2, n_atom_basis=8, n_radial=6)
    jargs = [jnp.asarray(a) for a in args]
    params = conv.init(jax.random.PRNGKey(1), *jargs, col_refs=jrefs)
    want, vjp = jax.vjp(
        lambda *a: conv.apply(params, *a, col_refs=jrefs), *jargs)
    g = np.random.RandomState(2).randn(*want.shape).astype(np.float32)
    want_g = vjp(jnp.asarray(g))

    tconv = SO3Convolution(2, 8, 6)
    lin = params["params"]["filternet"]["linear"]
    tconv.load_state_dict({
        "filternet.weight": torch.tensor(np.asarray(lin["kernel"]).T),
        "filternet.bias": torch.tensor(np.asarray(lin["bias"]))})
    ins = [torch.tensor(a).requires_grad_(True) for a in args]
    out = tconv(*ins, ColRefs.from_layout(lay))
    grads = torch.autograd.grad(out, ins, torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               CONV_RTOL, CONV_ATOL)
    for name, got, w in zip(("x", "radial", "dir", "cutoff"), grads, want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), CONV_RTOL,
                                   CONV_ATOL, err_msg=f"grad {name}")


# ------------------------------------------------------------------ model
def _jax_potential(F, T, B):
    return JNNP(
        representation=JSO3net(n_atom_basis=F, n_interactions=T, lmax=2,
                               n_rbf=B, cutoff=CUTOFF),
        input_modules=[JPairwiseDistances()],
        output_modules=[JAtomwise(output_key=P.energy), JForces()])


def _jax_column_inputs(lay, inputs):
    """The JAX package's column-layout inputs for the port's ``inputs``
    (as its MD calculator makes them, with an empty flat pair list)."""
    f32 = np.float32
    return {
        P.R: jnp.asarray(inputs[TP.R].numpy()),
        P.Z: jnp.asarray(inputs[TP.Z].numpy()),
        P.idx_m: jnp.zeros(len(lay.order), jnp.int32),
        P.atom_mask: jnp.asarray(lay.slot_mask.astype(f32)),
        P.n_atoms: jnp.asarray(inputs[TP.n_atoms].numpy()),
        P.cell_qcol: jnp.asarray(lay.qcol),
        P.cell_dcol: jnp.asarray(lay.dcol),
        P.cell_emask: jnp.asarray(lay.emask.astype(f32)),
        P.cell_ksz: tuple(jnp.zeros((k,), jnp.int8) for k in lay.ksizes),
        P.cell_coff: jnp.asarray(lay.offcol.astype(f32)),
        P.idx_i: jnp.zeros(1, jnp.int32),
        P.idx_j: jnp.zeros(1, jnp.int32),
        P.offsets: jnp.full((1, 3), 1e3, jnp.float32),
        P.pair_mask: jnp.zeros(1, jnp.float32),
    }


def port_so3net(params=None, F=64, T=3, B=20):
    pot = NeuralNetworkPotential(
        SO3net(n_atom_basis=F, n_interactions=T, lmax=2, n_rbf=B,
               cutoff=CUTOFF),
        [Atomwise(n_in=F), Forces()], input_modules=[PairwiseDistances()])
    if params is not None:
        pot.load_state_dict(params)
    return pot.requires_grad_(False)


def _box(n_cells, seed, jitter, stretch=1.0):
    rng = np.random.RandomState(seed)
    R, cell = fcc_box(n_cells)
    return (R + rng.uniform(-jitter, jitter, R.shape)) * stretch, \
        cell * stretch


def _compare_with_jax(R, cell, tree, F, T, B):
    lay, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    assert lay.dims[0] >= 3 and lay.dims[1] >= 3
    out = _jax_potential(F, T, B).apply(tree, _jax_column_inputs(lay, inputs))
    E_ref = float(np.asarray(out[P.energy])[0])
    F_ref = np.asarray(out[P.forces])
    got = port_so3net(params_from_jax(tree), F, T, B)(inputs)
    np.testing.assert_allclose(float(got[TP.energy][0]), E_ref, rtol=E_RTOL)
    np.testing.assert_allclose(got[TP.forces].numpy(), F_ref, rtol=F_RTOL,
                               atol=F_ATOL)
    assert np.abs(F_ref[lay.slot_mask == 0]).max() == 0.0
    return got[TP.forces].numpy()[lay.rank]


def test_small_so3net_matches_jax_column_path():
    """SO3net-16x2 (lmax 2, B=8), seeded flax init, on a periodic box."""
    R, cell = _box(3, seed=1, jitter=0.3, stretch=1.1)
    lay, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    params = _jax_potential(16, 2, 8).init(
        jax.random.PRNGKey(0), _jax_column_inputs(lay, inputs))
    Fp = _compare_with_jax(R, cell, jax.device_get(params), 16, 2, 8)
    assert np.abs(Fp).max() > 1e-4


def test_so3net_bench_asset_matches_jax():
    R, cell = _box(4, seed=0, jitter=0.15)
    Fp = _compare_with_jax(R, cell, load_jax_params(ASSET), 64, 3, 20)
    assert np.abs(Fp).max() > 0.05   # a force field worth comparing


def test_params_from_jax_covers_every_so3net_parameter():
    params = params_from_jax(load_jax_params(ASSET))
    state = port_so3net().state_dict()
    assert set(params) == set(state)
    for k, v in params.items():
        assert v.shape == state[k].shape, k
    assert params["representation.convs.2.filternet.weight"].shape \
        == (192, 20)
    assert "representation.mix3.0.bias" not in params


def test_so3net_md_20_steps():
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
    calc = SchNetPackCalculator(port_so3net(),
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


def test_so3net_refuses_other_layouts():
    with pytest.raises(NotImplementedError, match="column layout"):
        port_so3net(F=8, T=1, B=4).representation({TP.R: torch.zeros(4, 3)})
    # shared interactions are ported (one block); the flat and dense
    # layouts run and agree
    shared = SO3net(n_atom_basis=8, n_interactions=3, n_rbf=4,
                    shared_interactions=True)
    assert len(shared.convs) == 1
    R = np.random.RandomState(4).rand(7, 3) * 3.0
    out = [shared(PairwiseDistances()(ins))[TP.multipole_representation]
           for ins in pair_layout_inputs(R, CUTOFF)]
    torch.testing.assert_close(out[1], out[0], rtol=1e-5, atol=1e-6)


def test_default_device_without_cuda_raises(monkeypatch):
    """``load_molecules`` puts the system on the card unless asked for the
    CPU; with no card the default fails."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mol = {TP.Z: np.full(2, 18, np.int64), TP.R: np.eye(2, 3)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_molecules([mol])
    assert load_molecules([mol], device="cpu").positions.device.type == "cpu"


def test_so3net_reference_fixture_is_the_bench_box():
    """The full-size fixture (``scripts/make_port_reference_so3net.py``)
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
