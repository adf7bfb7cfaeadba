"""PyTorch port, the slab-decomposed column path on one device: row 12's
twins (the message K20/K21 stand for) in the wrap, halo_x and halo_xy
source-index modes against ``jax.vjp`` of ``_painn_message_xla`` and
``_msg_hx_xla``, the halo'd gather and its VJP (K11/K12's halo modes)
against ``_gather_hx_xla``, and the one-shard halo (a periodic-wrap
concatenation whose autograd adds the halo planes' cotangents back, also
with nx = 2, where one plane is both halos); then
``make_sharded_column_eval``, ``make_sharded_column_md`` and
``make_sharded_column_rpmd`` (1-D and 2-D meshes), a Langevin chunk at
kT = 0, and two NVE and two Langevin chunks of ``SpatialColumnSimulator``
against the JAX package's on ``make_column_mesh(1)``; ``md/prng.py``'s
keys and normal draws against ``jax.random``, and the Langevin noise's
independence of the column split.  The CUDA kernels are held against these twins in
``test_torch_port_kernels.py``.
"""
import dataclasses

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
from schnetpack_tpu.ops import colblock as jcb
from schnetpack_tpu.ops.colblock_shard import _gather_hx_xla, _msg_hx_xla
from schnetpack_tpu.parallel import columns as jcols
from schnetpack_tpu.representation import PaiNN as JPaiNN
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.atomistic import Atomwise, Forces, PairwiseDistances
from schnetpack_tpu_torch.convert import params_from_jax
from schnetpack_tpu_torch.md import prng
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.ops import colblock_edge as edge
from schnetpack_tpu_torch.ops import colblock_select as sel
from schnetpack_tpu_torch.ops.cellblock import build_column_layout
from schnetpack_tpu_torch.ops.colblock import ColRefs
from schnetpack_tpu_torch.ops.colblock_shard import COLS_AXIS, COLS_AXIS_Y
from schnetpack_tpu_torch.parallel import (
    ColumnMesh, MeshError, SpatialColumnSimulator, column_inputs, column_noise, make_column_mesh,
    make_sharded_column_chunk, make_sharded_column_eval,
    make_sharded_column_md, make_sharded_column_rpmd,
)
from schnetpack_tpu_torch.representation import PaiNN
from torch_port_cases import MSG_ATOL, MSG_RTOL, slab_case
from test_torch_port_schnet import _jax_batch

# filter-weight cotangent (a sum over every edge) and the energy: held
# normwise, ||g - w|| <= SUM_RTOL ||w||
SUM_RTOL = 1e-5
# whole model on the slab path: energy relative, forces elementwise
E_RTOL = 1e-5
F_RTOL, F_ATOL = 1e-4, 1e-5
# two NVE chunks: positions and momenta after 10 steps (the JAX test's
# tolerance for its 1- vs 8-device trajectories)
MD_TOL = 2e-4
MODES = {"wrap": None, "halo_x": COLS_AXIS,
         "halo_xy": (COLS_AXIS, COLS_AXIS_Y)}
#: (mode, grid): x slabs and (x, y) blocks on aliased (2) and plain grids
CASES = [("wrap", (3, 3)), ("wrap", (2, 3)), ("halo_x", (3, 3)),
         ("halo_x", (2, 3)), ("halo_xy", (3, 3)), ("halo_xy", (2, 2))]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def port_refs(lay, mode, device="cpu"):
    return dataclasses.replace(ColRefs.from_layout(lay, device=device),
                               shard_axis=MODES[mode])


def jax_halo(table, grid, P_, mode):
    """The one-shard halo of the JAX package (``halo_x``/``halo_xy`` with
    self-loop ppermutes), outside shard_map."""
    nx, ny = grid
    t = table.reshape(nx, ny, P_, -1)
    if mode == "halo_xy":
        t = jnp.concatenate([t[:, -1:], t, t[:, :1]], axis=1)
    return jnp.concatenate([t[-1:], t, t[:1]], axis=0)


def jax_message(c, mode):
    """(outputs, VJP) of the JAX row-12 oracle on the slab's xmu."""
    lay = c["lay"]
    refs = jcb.ColRefs.from_layout(lay)
    nx, ny, P_, _ = lay.dims

    def f(xmu, rbf, dirs, FW):
        if mode == "wrap":
            return jcb._painn_message_xla(xmu, rbf, dirs, FW, refs)
        return _msg_hx_xla(jax_halo(xmu, (nx, ny), P_, mode), rbf, dirs, FW,
                           refs, mode == "halo_xy")

    args = [jnp.asarray(c[k]) for k in ("xmu", "rbf", "dir", "FW")]
    out, vjp = jax.vjp(f, *args)
    return out, vjp((jnp.asarray(c["g_dq"]), jnp.asarray(c["g_dmu"])))


def _normwise(got, want, name):
    w = np.asarray(want, np.float64)
    err = np.linalg.norm(got.detach().double().numpy() - w)
    assert err <= SUM_RTOL * np.linalg.norm(w), (name, err)


@pytest.mark.parametrize("mode,grid", CASES)
def test_row12_message_matches_jax(mode, grid):
    """The row-12 op (``painn_message_columns``: the halo, then K20/K21's
    twins) and its gradients in every input against the JAX oracle."""
    c = slab_case(grid, seed=sum(grid))
    out, want = jax_message(c, mode)
    refs = port_refs(c["lay"], mode)
    ins = [torch.tensor(c[k]).requires_grad_(True)
           for k in ("xmu", "rbf", "dir", "FW")]
    got = edge.painn_message_columns(*ins, refs)
    for g, w in zip(got, out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   MSG_RTOL, MSG_ATOL)
    grads = torch.autograd.grad(got, ins, (torch.tensor(c["g_dq"]),
                                           torch.tensor(c["g_dmu"])))
    for name, g, w in zip(("xmu", "rbf", "dir"), grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), MSG_RTOL,
                                   MSG_ATOL, err_msg=name)
    _normwise(grads[3], want[3], "FW")
    # padded slots get no geometry cotangent
    pad = (refs.qcol < 0).numpy()
    assert pad.any()
    np.testing.assert_array_equal(grads[1].numpy()[pad], 0.0)
    np.testing.assert_array_equal(grads[2].numpy()[pad], 0.0)


@pytest.mark.parametrize("mode,grid", [("halo_x", (2, 3)),
                                       ("halo_xy", (2, 2))])
def test_row12_backward_twin_returns_the_halod_cotangent(mode, grid):
    """K21's twin on the halo'd table returns dxmu over all of it (the
    ``dxmu_h`` of ``_msg_hx_bwd_call``), against ``jax.vjp`` of
    ``_msg_hx_xla`` in xmu_h."""
    c = slab_case(grid, seed=5)
    lay = c["lay"]
    nx, ny, P_, _ = lay.dims
    jrefs = jcb.ColRefs.from_layout(lay)
    xmu_h = np.asarray(jax_halo(jnp.asarray(c["xmu"]), (nx, ny), P_, mode))
    _, vjp = jax.vjp(lambda x: _msg_hx_xla(x, jnp.asarray(c["rbf"]),
                                           jnp.asarray(c["dir"]),
                                           jnp.asarray(c["FW"]), jrefs,
                                           mode == "halo_xy"),
                     jnp.asarray(xmu_h))
    (want,) = vjp((jnp.asarray(c["g_dq"]), jnp.asarray(c["g_dmu"])))
    refs = port_refs(lay, mode)
    got = edge.msg_bwd_edge_plain(
        torch.tensor(xmu_h.reshape(-1, xmu_h.shape[-1])),
        *[torch.tensor(c[k]) for k in ("rbf", "dir", "FW")], refs,
        torch.tensor(c["g_dq"]), torch.tensor(c["g_dmu"]))
    assert got[0].shape[0] == (nx + 2) * (ny + 2 * (mode == "halo_xy")) * P_
    np.testing.assert_allclose(got[0].numpy(),
                               np.asarray(want).reshape(got[0].shape),
                               MSG_RTOL, MSG_ATOL)


@pytest.mark.parametrize("mode,grid", [("halo_x", (3, 3)), ("halo_x", (2, 3)),
                                       ("halo_xy", (3, 3)),
                                       ("halo_xy", (2, 2))])
def test_halo_gather_matches_jax(mode, grid):
    """K11/K12's halo twins (the decoded-index gather of the halo'd table
    and its transpose) against ``_gather_hx_xla`` and its VJP, and the
    sharded gather op with the halo's cotangent folded back."""
    c = slab_case(grid, seed=7)
    lay = c["lay"]
    nx, ny, P_, ks = lay.dims
    refs = port_refs(lay, mode)
    hy = mode == "halo_xy"
    rng = np.random.RandomState(11)
    table = rng.randn(nx * ny * P_, 3).astype(np.float32)
    g = rng.randn(*lay.emask.shape, 3).astype(np.float32)
    qcol = jnp.asarray(lay.qcol)

    def jgather(t):
        return _gather_hx_xla(jax_halo(t, (nx, ny), P_, mode), qcol, ks, P_,
                              hy)

    out, vjp = jax.vjp(jgather, jnp.asarray(table))
    (dT,) = vjp(jnp.asarray(g))
    table_h = np.asarray(jax_halo(jnp.asarray(table), (nx, ny), P_, mode))
    table_h = torch.tensor(table_h.reshape(-1, 3))
    np.testing.assert_array_equal(sel.gather_fwd_plain(table_h, refs).numpy(),
                                  np.asarray(out))
    _, vjp_h = jax.vjp(lambda t: _gather_hx_xla(t, qcol, ks, P_, hy),
                       jnp.asarray(table_h.numpy().reshape(
                           nx + 2, ny + 2 * hy, P_, 3)))
    (dT_h,) = vjp_h(jnp.asarray(g))
    np.testing.assert_allclose(
        sel.gather_bwd_plain(torch.tensor(g), refs).numpy(),
        np.asarray(dT_h).reshape(-1, 3), rtol=1e-6, atol=1e-6)
    t = torch.tensor(table).requires_grad_(True)
    got = sel.column_gather_op(t, refs)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    (dt,) = torch.autograd.grad(got, t, torch.tensor(g))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dT), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------------ model
CUTOFF = 3.0


def _system(n=400, L=24.0, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0, L, size=(n, 3)), rng.randint(1, 9, n),
            np.eye(3) * L)


def _models(R, Z, cell, cutoff):
    """The JAX PaiNN (F = 16, 2 interactions, B = 8, seeded flax init)
    with forces, and the port's with its parameters."""
    jpot = JNNP(representation=JPaiNN(n_atom_basis=16, n_interactions=2,
                                      n_rbf=8, cutoff=cutoff),
                input_modules=[JPairwiseDistances()],
                output_modules=[JAtomwise(output_key=P.energy), JForces()])
    sample = {P.Z: Z.astype(np.int64), P.R: R, P.cell: cell,
              P.pbc: np.ones(3, bool)}
    from schnetpack_tpu.data.loader import collate, padding_for
    from schnetpack_tpu.transform.neighborlist import NeighborListTransform

    sample = NeighborListTransform(cutoff)(sample)
    tree = jax.device_get(jpot.init(jax.random.PRNGKey(2),
                                    collate([sample], padding_for([sample]))))
    pot = NeuralNetworkPotential(
        PaiNN(n_atom_basis=16, n_interactions=2, n_rbf=8, cutoff=cutoff),
        [Atomwise(n_in=16), Forces()], input_modules=[PairwiseDistances()])
    return jpot, tree, pot, params_from_jax(tree)


@pytest.mark.parametrize("grid,two_d", [((4, 4), False), ((2, 3), False),
                                        ((3, 2), True)])
def test_sharded_column_eval_matches_jax(grid, two_d):
    """``make_sharded_column_eval`` on one shard against the JAX package's
    on ``make_column_mesh(1)`` (1-D) or ``dims=(1, 1)`` (2-D)."""
    R, Z, cell = _system()
    lay = build_column_layout(R, CUTOFF, cell, np.ones(3, bool),
                              dims=(*grid, 1))
    jpot, tree, pot, params = _models(R, Z, cell, CUTOFF)
    jmesh = jcols.make_column_mesh(1, dims=(1, 1) if two_d else None)
    jin = jcols.column_inputs(lay, R, Z, sharded=True, mesh_2d=two_d)
    with jmesh:
        e_ref, f_ref = jcols.make_sharded_column_eval(jpot, tree, jin,
                                                      jmesh)(jin)
    mesh = make_column_mesh(1, dims=(1, 1) if two_d else None, device="cpu")
    inputs = column_inputs(lay, R, Z, mesh_2d=two_d, device="cpu")
    e, f = make_sharded_column_eval(pot, params, inputs, mesh)(inputs)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref).reshape(-1, 3),
                               F_RTOL, F_ATOL)
    assert np.abs(f.numpy()).max() > 1e-3


def test_multi_card_mesh_raises():
    """A mesh that the cards or the grid cannot hold raises ``MeshError``
    before any rank communicates: NCCL with more ranks than visible cards,
    several ranks without a joined group, and a column grid whose nx (ny)
    is not a multiple of px (py)."""
    n_cards = torch.cuda.device_count()
    with pytest.raises(MeshError, match="visible cards"):
        make_column_mesh(n_cards + 1, device="cuda")
    with pytest.raises(MeshError, match="joined process group"):
        make_column_mesh(2, device="cpu")
    with pytest.raises(MeshError, match="hold 2 ranks"):
        make_column_mesh(3, dims=(2, 1), device="cpu")
    R, Z, cell = _system()
    lay = build_column_layout(R, CUTOFF, cell, np.ones(3, bool),
                              dims=(3, 4, 1))
    for dims in [(2,), (1, 3)]:
        # the mesh of rank 0 as a joined group would make it
        mesh = ColumnMesh(None, dims, (COLS_AXIS, COLS_AXIS_Y)[:len(dims)],
                          torch.device("cpu"))
        with pytest.raises(MeshError, match="multiple of px and ny of py"):
            column_inputs(lay, R, Z, mesh=mesh)


def test_spatial_simulator_two_nve_chunks_match_jax():
    """Two 5-step NVE chunks of ``SpatialColumnSimulator`` (a host re-bin
    before each) against the JAX package's on ``make_column_mesh(1)``."""
    cutoff, L, n = 4.0, 24.0, 300
    rng = np.random.RandomState(9)
    R = rng.uniform(0, L, size=(n, 3))
    Z = np.full(n, 18, np.int64)
    masses = np.full(n, 39.9)
    cell = np.eye(3) * L
    p0 = rng.randn(n, 3) * 0.05
    jpot, tree, pot, params = _models(R, Z, cell, cutoff)
    jmesh = jcols.make_column_mesh(1)
    jsim = jcols.SpatialColumnSimulator(jpot, tree, R, Z, masses, cell, jmesh,
                                        cutoff=cutoff, skin=0.5,
                                        dims=(4, 4, 1), dt=0.2)
    jsim.p = p0.copy()
    with jmesh:
        jsim.simulate(10, chunk_size=5)
    sim = SpatialColumnSimulator(pot, params, R, Z, masses, cell,
                                 make_column_mesh(1, device="cpu"),
                                 cutoff=cutoff, skin=0.5, dims=(4, 4, 1),
                                 dt=0.2)
    sim.p = p0.copy()
    sim.simulate(10, chunk_size=5)
    assert sim.rebuilds == jsim.rebuilds == 2
    assert np.abs(sim.R - R).max() > 1e-3
    np.testing.assert_allclose(sim.R, jsim.R, rtol=MD_TOL, atol=MD_TOL)
    np.testing.assert_allclose(sim.p, jsim.p, rtol=MD_TOL, atol=MD_TOL)
    assert sim.host_seconds > 0
    # the Langevin form: two chunks of JAX's noise streams
    jsim = jcols.SpatialColumnSimulator(jpot, tree, R, Z, masses, cell, jmesh,
                                        cutoff=cutoff, skin=0.5,
                                        dims=(4, 4, 1), dt=0.2, kT=0.03,
                                        gamma=0.05, seed=11)
    jsim.p = p0.copy()
    with jmesh:
        jsim.simulate(10, chunk_size=5)
    sim = SpatialColumnSimulator(pot, params, R, Z, masses, cell,
                                 make_column_mesh(1, device="cpu"),
                                 cutoff=cutoff, skin=0.5, dims=(4, 4, 1),
                                 dt=0.2, kT=0.03, gamma=0.05, seed=11)
    sim.p = p0.copy()
    sim.simulate(10, chunk_size=5)
    np.testing.assert_array_equal(sim.key.numpy(),
                                  np.asarray(jsim.key, np.int64))
    np.testing.assert_allclose(sim.R, jsim.R, rtol=MD_TOL, atol=MD_TOL)
    np.testing.assert_allclose(sim.p, jsim.p, rtol=MD_TOL, atol=MD_TOL)


# ------------------------------------------------------- Langevin noise
# the normal draws: JAX's float32 erfinv against the port's, up to the
# ulps of log1p (at most 3 ulps of a value under 5.5)
DRAW_ATOL = 1e-6


@pytest.mark.parametrize("seed", [0, 11, 2**31 + 5])
def test_prng_matches_jax(seed):
    """``prng_key``, ``split`` and ``fold_in`` equal JAX's bit for bit;
    ``normal`` is within DRAW_ATOL, over several steps and column ids."""
    jkey = jax.random.PRNGKey(seed)
    key = prng.prng_key(seed)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey, np.int64))
    jk, k = jax.random.split(jkey)[1], prng.split(key)[1]
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk, np.int64))
    cols = np.array([0, 1, 5, 63, 4097])
    for step in (0, 1, 37, 199):
        js = jax.random.fold_in(jk, step)
        ks = prng.fold_in(k, step)
        np.testing.assert_array_equal(ks.numpy(), np.asarray(js, np.int64))
        jc = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(js, cols)
        kc = prng.fold_in(ks, torch.tensor(cols))
        np.testing.assert_array_equal(kc.numpy(), np.asarray(jc, np.int64))
        want = jax.vmap(lambda q: jax.random.normal(q, (400, 3)))(jc)
        got = prng.normal(kc, 1200).reshape(len(cols), 400, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=DRAW_ATOL)
    # the tails, where torch's own erfinv is 90 ulps from JAX's
    big = np.asarray(jax.random.normal(js, (200_000,)))
    got = prng.normal(ks, 200_000).numpy()
    assert np.abs(big).max() > 4.0
    np.testing.assert_allclose(got, big, rtol=0, atol=DRAW_ATOL)


def test_column_noise_is_independent_of_the_split():
    """The noise of columns [0, n) is the noise of [0, k) then [k, n), bit
    for bit, for every split point: a column's draws depend on its global
    id only."""
    key = prng.split(prng.prng_key(4))[1]
    whole = column_noise(key, range(6), 12, 16)
    for k in (1, 5, 11):
        parts = torch.cat([column_noise(key, range(6), k, 16),
                           column_noise(key, range(6), 12 - k, 16, col0=k)],
                          1)
        assert torch.equal(whole, parts), k
    assert not torch.equal(whole[0], whole[1])


def _chunk_case(two_d=False, seed=5):
    cutoff, L, n = 4.0, 24.0, 300
    rng = np.random.RandomState(seed)
    R = rng.uniform(0, L, size=(n, 3))
    Z = np.full(n, 18, np.int64)
    cell = np.eye(3) * L
    lay = build_column_layout(R, cutoff + 0.5, cell, np.ones(3, bool),
                              dims=(4, 4, 1))
    jpot, tree, pot, params = _models(R, Z, cell, cutoff)
    m = lay.slot_mask > 0
    p0 = (rng.randn(n, 3) * 0.05)[lay.order] * m[:, None]
    mass = np.full(n, 39.9)[lay.order] * m
    R_s = R[lay.order] * m[:, None]
    return lay, R, Z, jpot, tree, pot, params, R_s, p0, mass


def test_langevin_chunk_at_zero_temperature_matches_jax():
    """A kT = 0, gamma > 0 chunk (pure friction) against the JAX
    package's ``make_sharded_column_chunk``, and a gamma = 0 chunk equals
    the NVE chunk bit for bit (the noise is multiplied by c2 = 0)."""
    lay, R, Z, jpot, tree, pot, params, R_s, p0, mass = _chunk_case()
    jmesh = jcols.make_column_mesh(1)
    jin = jcols.column_inputs(lay, R, Z, sharded=True)
    f32 = [jnp.asarray(a, jnp.float32) for a in (R_s, p0, mass)]
    with jmesh:
        jfn = jcols.make_sharded_column_chunk(jpot, tree, jin, jmesh, 0.2, 6,
                                              gamma=0.5, kT=0.0)
        jR, jp = jfn(jin, *f32, jax.random.PRNGKey(3))
    mesh = make_column_mesh(1, device="cpu")
    ins = column_inputs(lay, R, Z, device="cpu")
    t32 = [torch.tensor(a, dtype=torch.float32) for a in (R_s, p0, mass)]
    fn = make_sharded_column_chunk(pot, params, mesh, 0.2, 6, gamma=0.5,
                                   kT=0.0)
    gR, gp = fn(ins, *t32, prng.prng_key(3))
    np.testing.assert_allclose(gR.numpy(), np.asarray(jR), MD_TOL, MD_TOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jp), MD_TOL, MD_TOL)
    # friction: the kinetic energy falls below the NVE chunk's
    nve = make_sharded_column_chunk(pot, params, mesh, 0.2, 6)
    nR, np_ = nve(ins, *t32)
    assert (gp ** 2).sum() < 0.8 * (np_ ** 2).sum()
    zero = make_sharded_column_chunk(pot, params, mesh, 0.2, 6, gamma=0.0,
                                     kT=0.03)
    zR, zp = zero(ins, *t32, prng.prng_key(3))
    assert torch.equal(zR, nR) and torch.equal(zp, np_)


@pytest.mark.parametrize("two_d", [False, True])
def test_sharded_column_md_matches_jax(two_d):
    """``make_sharded_column_md`` (10 steps) against the JAX package's on
    ``make_column_mesh(1)`` (1-D) or ``dims=(1, 1)`` (2-D, whose
    [nx, ny, P, 3] positions come back in that shape)."""
    lay, R, Z, jpot, tree, pot, params, R_s, p0, _ = _chunk_case()
    nx, ny, P_, _ = lay.dims
    shape = (nx, ny, P_, 3) if two_d else (-1, 3)
    jmesh = jcols.make_column_mesh(1, dims=(1, 1) if two_d else None)
    jin = jcols.column_inputs(lay, R, Z, sharded=True, mesh_2d=two_d)
    with jmesh:
        jfn = jcols.make_sharded_column_md(jpot, tree, jin, jmesh,
                                           mass=39.9, dt=0.2, n_steps=10)
        jR, jp = jfn(jin, *[jnp.asarray(a.reshape(shape), jnp.float32)
                            for a in (R_s, p0)])
    mesh = make_column_mesh(1, dims=(1, 1) if two_d else None, device="cpu")
    ins = column_inputs(lay, R, Z, mesh_2d=two_d, device="cpu")
    fn = make_sharded_column_md(pot, params, ins, mesh, mass=39.9, dt=0.2,
                                n_steps=10)
    gR, gp = fn(ins, *[torch.tensor(a.reshape(shape), dtype=torch.float32)
                       for a in (R_s, p0)])
    assert gR.shape == tuple(jR.shape)
    assert np.abs(gR.numpy() - R_s.reshape(shape)).max() > 1e-3
    np.testing.assert_allclose(gR.numpy(), np.asarray(jR), MD_TOL, MD_TOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jp), MD_TOL, MD_TOL)


@pytest.mark.parametrize("two_d", [False, True])
def test_sharded_column_rpmd_matches_jax(two_d):
    """``make_sharded_column_rpmd`` (3 beads, 6 steps) against the JAX
    package's on a one-device 1-D or 2-D mesh."""
    lay, R, Z, jpot, tree, pot, params, R_s, p0, _ = _chunk_case()
    nx, ny, P_, _ = lay.dims
    m = (lay.slot_mask > 0)[None, :, None]
    rng = np.random.RandomState(8)
    beads = (R_s[None] + 0.05 * rng.randn(3, *R_s.shape)) * m
    pb = (p0[None] + 0.02 * rng.randn(3, *p0.shape)) * m
    shape = (3, nx, ny, P_, 3) if two_d else (3, -1, 3)
    kw = dict(n_beads=3, mass=39.9, dt=0.2, n_steps=6, omega=0.3)
    jmesh = jcols.make_column_mesh(1, dims=(1, 1) if two_d else None)
    jin = jcols.column_inputs(lay, R, Z, sharded=True, mesh_2d=two_d)
    with jmesh:
        jfn = jcols.make_sharded_column_rpmd(jpot, tree, jin, jmesh, **kw)
        jR, jp = jfn(jin, *[jnp.asarray(a.reshape(shape), jnp.float32)
                            for a in (beads, pb)])
    mesh = make_column_mesh(1, dims=(1, 1) if two_d else None, device="cpu")
    ins = column_inputs(lay, R, Z, mesh_2d=two_d, device="cpu")
    fn = make_sharded_column_rpmd(pot, params, ins, mesh, **kw)
    gR, gp = fn(ins, *[torch.tensor(a.reshape(shape), dtype=torch.float32)
                       for a in (beads, pb)])
    assert gR.shape == tuple(jR.shape)
    np.testing.assert_allclose(gR.numpy(), np.asarray(jR), MD_TOL, MD_TOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jp), MD_TOL, MD_TOL)


def test_langevin_noise_drawn_in_blocks_is_the_same(monkeypatch):
    """A chunk whose noise is drawn one step at a time (a small
    ``NOISE_BLOCK``) equals the chunk that draws it all at once, bit for
    bit."""
    from schnetpack_tpu_torch.parallel import columns

    lay, R, Z, _, _, pot, params, R_s, p0, mass = _chunk_case()
    mesh = make_column_mesh(1, device="cpu")
    ins = column_inputs(lay, R, Z, device="cpu")
    t32 = [torch.tensor(a, dtype=torch.float32) for a in (R_s, p0, mass)]
    key = prng.split(prng.prng_key(9))[1]

    def run():
        return make_sharded_column_chunk(pot, params, mesh, 0.2, 5,
                                         gamma=0.5, kT=0.03)(ins, *t32, key)

    whole = run()
    monkeypatch.setattr(columns, "NOISE_BLOCK", 1)
    stepwise = run()
    assert torch.equal(whole[0], stepwise[0])
    assert torch.equal(whole[1], stepwise[1])
