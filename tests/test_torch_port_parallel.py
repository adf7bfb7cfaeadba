"""PyTorch port, the slab path on several ranks: gloo processes on the
CPU (``parallel.mesh.spawn_ranks``, one thread each; the workers are
``torch_parallel_workers.py``) against the JAX package on the 8-device
virtual CPU mesh of ``conftest.py``.

* The halo exchange between ranks (``ops/colblock_shard.py::
  HaloExchange``) and its VJP against JAX's ``halo_x``/``halo_xy`` under
  ``shard_map``: x slabs at px = 2, where both neighbours are one rank
  (nx_loc = 2, and nx_loc = 1, where that rank's one plane is both
  halos), and at px = 4; (x, y) blocks at (2, 2).
* ``make_sharded_column_eval``, ``make_sharded_column_md``,
  ``make_sharded_column_rpmd``, a Langevin chunk at kT > 0 and two NVE and
  two Langevin chunks of ``SpatialColumnSimulator`` against the JAX
  package's on ``make_column_mesh(2)`` (x slabs, 2 ranks) and ``dims=(2,
  2)`` ((x, y) blocks, 4 ranks), at the tolerances of
  ``test_torch_port_slab.py``; the chunk also against the port's own on
  one rank (its noise is drawn per global column).

The ranks of one mesh run every case in one spawn (a module fixture):
starting the processes costs seconds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import torch_parallel_workers as workers
from schnetpack_tpu.ops import colblock_shard as jshard
from schnetpack_tpu.parallel import columns as jcols
from schnetpack_tpu_torch.md import prng
from schnetpack_tpu_torch.ops.cellblock import build_column_layout
from schnetpack_tpu_torch.parallel import (
    column_inputs, make_column_mesh, make_sharded_column_chunk, spawn_ranks,
)
from test_torch_port_slab import (
    CUTOFF, E_RTOL, F_ATOL, F_RTOL, MD_TOL, _models, _system,
)

#: mesh name -> dims (x slabs over 2 ranks, (x, y) blocks over 4)
MESHES = {"x2": (2,), "xy22": (2, 2)}
#: halo cases: (mesh dims, column grid (nx, ny))
HALO = {"px2_nx4": ((2,), (4, 3)), "px2_nx2": ((2,), (2, 3)),
        "px4_nx4": ((4,), (4, 3)), "xy22_4x4": ((2, 2), (4, 4)),
        "xy22_2x2": ((2, 2), (2, 2))}
SIM_NVT = dict(kT=0.03, gamma=0.05, seed=11)
CHUNK_KW = dict(dt=0.2, n_steps=6, gamma=0.5, kT=0.03)
CHUNK_SEED = 3
RPMD_KW = dict(n_beads=3, mass=39.9, dt=0.2, n_steps=6, omega=0.3)


def _axes(dims):
    return ((jshard.COLS_AXIS, jshard.COLS_AXIS_Y) if len(dims) == 2
            else jshard.COLS_AXIS)


def _jmesh(dims):
    return jcols.make_column_mesh(int(np.prod(dims)),
                                  dims=dims if len(dims) == 2 else None)


def _pspec(dims):
    return (PartitionSpec(jshard.COLS_AXIS, jshard.COLS_AXIS_Y)
            if len(dims) == 2 else PartitionSpec(jshard.COLS_AXIS))


def _halo_case(name):
    dims, (nx, ny) = HALO[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    table = rng.randn(nx, ny, 4, 3).astype(np.float32)
    hx = nx // dims[0] + 2
    hy = ny // dims[1] + 2 if len(dims) == 2 else ny
    cot = rng.randn(dims[0] * hx, (dims[1] if len(dims) == 2 else 1) * hy,
                    4, 3).astype(np.float32)
    return dims, table, cot


def _jax_halo(name):
    """JAX's halo'd slabs (side by side) and the VJP in the table."""
    dims, table, cot = _halo_case(name)
    mesh = _jmesh(dims)
    spec = _pspec(dims)
    f = jax.shard_map(lambda t: jshard.halo_xy(t, _axes(dims))[0],
                      mesh=mesh, in_specs=(spec,), out_specs=spec,
                      check_vma=False)
    with mesh:
        out, vjp = jax.vjp(f, jnp.asarray(table))
        (dt,) = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(dt)


# ------------------------------------------------------------ the systems
#: the flax init reads its sample's shapes only: a few atoms give the
#: whole system's parameters, without the full-size eager trace
INIT_ATOMS = 8


def _eval_case():
    R, Z, cell = _system()
    jpot, tree, pot, params = _models(R[:INIT_ATOMS], Z[:INIT_ATOMS], cell,
                                      CUTOFF)
    return dict(R=R, Z=Z, cell=cell, cutoff=CUTOFF, grid=(4, 4, 1),
                jpot=jpot, tree=tree, pot=pot, params=params)


def _chunk_case():
    """``test_torch_port_slab.py``'s chunk box, with beads and masses."""
    cutoff, L, n = 4.0, 24.0, 300
    rng = np.random.RandomState(5)
    R = rng.uniform(0, L, size=(n, 3))
    Z = np.full(n, 18, np.int64)
    cell = np.eye(3) * L
    lay = build_column_layout(R, cutoff + 0.5, cell, np.ones(3, bool),
                              dims=(4, 4, 1))
    jpot, tree, pot, params = _models(R[:INIT_ATOMS], Z[:INIT_ATOMS], cell,
                                      cutoff)
    m = lay.slot_mask > 0
    p0 = (rng.randn(n, 3) * 0.05)[lay.order] * m[:, None]
    mass = np.full(n, 39.9)[lay.order] * m
    R_s = R[lay.order] * m[:, None]
    rng = np.random.RandomState(8)
    beads = (R_s[None] + 0.05 * rng.randn(3, *R_s.shape)) * m[None, :, None]
    pb = (p0[None] + 0.02 * rng.randn(3, *p0.shape)) * m[None, :, None]
    return dict(R=R, Z=Z, cell=cell, cutoff=cutoff + 0.5, grid=(4, 4, 1),
                lay=lay, jpot=jpot, tree=tree, pot=pot, params=params,
                R_s=R_s, p0=p0, mass=mass, beads=beads, pb=pb,
                masses=np.full(n, 39.9), sim_cutoff=cutoff,
                sim_p0=np.random.RandomState(9).randn(n, 3) * 0.05)


def _jobs(ev, ch):
    """The slab path's jobs of one mesh (``torch_parallel_workers.
    slab_path``)."""
    base = dict(R=ch["R"], Z=ch["Z"], cell=ch["cell"], cutoff=ch["cutoff"],
                grid=ch["grid"], pot=ch["pot"], params=ch["params"])
    sim = dict(pot=ch["pot"], params=ch["params"], R=ch["R"], Z=ch["Z"],
               masses=ch["masses"], cell=ch["cell"], cutoff=ch["sim_cutoff"],
               grid=ch["grid"], p0=ch["sim_p0"])
    return [
        ("eval", {k: ev[k] for k in ("R", "Z", "cell", "cutoff", "grid",
                                     "pot", "params")}),
        ("md", dict(base, R_s=ch["R_s"], p0=ch["p0"],
                    kw=dict(mass=39.9, dt=0.2, n_steps=10))),
        ("rpmd", dict(base, beads=ch["beads"], pb=ch["pb"], kw=RPMD_KW)),
        ("chunk", dict(base, R_s=ch["R_s"], p0=ch["p0"], mass=ch["mass"],
                       kw=CHUNK_KW, seed=CHUNK_SEED)),
        ("sim", sim),
        ("sim", dict(sim, nvt=SIM_NVT)),
    ]


@pytest.fixture(scope="module")
def cases():
    return _eval_case(), _chunk_case()


@pytest.fixture(scope="module")
def port(cases, tmp_path_factory):
    """Every case run on the ranks: {"halo": {name: per-rank results},
    mesh name: rank 0's and rank 1's job results}."""
    ev, ch = cases
    out = {"halo": {}}
    for world, meshes in ((2, ["x2"]), (4, ["xy22"])):
        halos = [n for n, (d, _) in HALO.items() if int(np.prod(d)) == world]
        dims = MESHES[meshes[0]]
        res = spawn_ranks(workers.slab_path_and_halo, world,
                          (dims, _jobs(ev, ch),
                           [_halo_case(n) for n in halos]),
                          str(tmp_path_factory.mktemp(f"ranks{world}")))
        for i, name in enumerate(halos):
            out["halo"][name] = [r[1][i] for r in res]
        out[meshes[0]] = [r[0] for r in res]
    return out


# ------------------------------------------------------------------ halo
@pytest.mark.parametrize("name", list(HALO))
def test_halo_exchange_and_its_vjp_match_jax(port, name):
    """Each rank's halo'd slab (bit for bit: the exchange copies) and the
    VJP in its slab (1e-6: an edge plane's cotangent sums up to three
    terms, in another order) against JAX's ``halo_xy`` under
    ``shard_map``; a double backward through the exchange raises."""
    dims, table, _ = _halo_case(name)
    want, want_dt = _jax_halo(name)
    nx, ny = table.shape[:2]
    px = dims[0]
    py = dims[1] if len(dims) == 2 else 1
    nxl, nyl = nx // px, ny // py
    for r, (h, dt, hy, twice) in enumerate(port["halo"][name]):
        # the exchange's backward detaches its planes: a double backward
        # raises instead of dropping the other ranks' terms
        assert twice
        ix, iy = np.unravel_index(r, (px, py))
        sx, sy = h.shape[:2]
        assert hy == (len(dims) == 2)
        np.testing.assert_array_equal(
            h, want[ix * sx:(ix + 1) * sx, iy * sy:(iy + 1) * sy])
        np.testing.assert_allclose(
            dt, want_dt[ix * nxl:(ix + 1) * nxl, iy * nyl:(iy + 1) * nyl],
            rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ slab model
@pytest.fixture(scope="module")
def jax_runs(cases):
    """The JAX package's eval, MD, RPMD, Langevin chunk and simulators on
    each mesh."""
    ev, ch = cases
    out = {}
    for name, dims in MESHES.items():
        two_d = len(dims) == 2
        jmesh = _jmesh(dims)
        lay = build_column_layout(ev["R"], ev["cutoff"], ev["cell"],
                                  np.ones(3, bool), dims=ev["grid"])
        jin = jcols.column_inputs(lay, ev["R"], ev["Z"], sharded=True,
                                  mesh_2d=two_d)
        clay = ch["lay"]
        nx, ny, P_, _ = clay.dims
        cin = jcols.column_inputs(clay, ch["R"], ch["Z"], sharded=True,
                                  mesh_2d=two_d)
        shape = (nx, ny, P_, 3) if two_d else (-1, 3)
        bshape = (3, nx, ny, P_, 3) if two_d else (3, -1, 3)

        def f32(a, s=shape):
            return jnp.asarray(a.reshape(s), jnp.float32)

        r = {}
        with jmesh:
            E, F = jcols.make_sharded_column_eval(ev["jpot"], ev["tree"],
                                                  jin, jmesh)(jin)
            r["eval"] = (np.asarray(E), np.asarray(F).reshape(-1, 3))
            R, p = jcols.make_sharded_column_md(
                ch["jpot"], ch["tree"], cin, jmesh, mass=39.9, dt=0.2,
                n_steps=10)(cin, f32(ch["R_s"]), f32(ch["p0"]))
            r["md"] = tuple(np.asarray(a).reshape(-1, 3) for a in (R, p))
            R, p = jcols.make_sharded_column_rpmd(
                ch["jpot"], ch["tree"], cin, jmesh, **RPMD_KW)(
                    cin, f32(ch["beads"], bshape), f32(ch["pb"], bshape))
            r["rpmd"] = tuple(np.asarray(a).reshape(3, -1, 3) for a in (R, p))
            kw = dict(CHUNK_KW)
            R, p = jcols.make_sharded_column_chunk(
                ch["jpot"], ch["tree"], cin, jmesh, kw.pop("dt"),
                kw.pop("n_steps"), **kw)(
                    cin, f32(ch["R_s"]), f32(ch["p0"]),
                    f32(ch["mass"], shape[:-1]),
                    jax.random.PRNGKey(CHUNK_SEED))
            r["chunk"] = tuple(np.asarray(a).reshape(-1, 3) for a in (R, p))
            for key, nvt in (("sim", {}), ("sim_nvt", SIM_NVT)):
                sim = jcols.SpatialColumnSimulator(
                    ch["jpot"], ch["tree"], ch["R"], ch["Z"], ch["masses"],
                    ch["cell"], jmesh, cutoff=ch["sim_cutoff"], skin=0.5,
                    dims=ch["grid"], dt=0.2, **nvt)
                sim.p = ch["sim_p0"].copy()
                sim.simulate(10, chunk_size=5)
                r[key] = (sim.R, sim.p, sim.rebuilds,
                          np.asarray(sim.key, np.int64))
        out[name] = r
    return out


def _results(port, mesh):
    """{job: rank 0's result}, after checking every rank got the same."""
    kinds = ["eval", "md", "rpmd", "chunk", "sim", "sim_nvt"]
    ranks = port[mesh]
    for other in ranks[1:]:
        for a, b in zip(ranks[0], other):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    return dict(zip(kinds, ranks[0]))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_eval_matches_jax(port, jax_runs, mesh):
    """Each rank's partial energy (rtol 1e-5) and the gathered forces
    (rtol 1e-4, atol 1e-5) against the JAX package's on the same mesh."""
    E, F = _results(port, mesh)["eval"]
    E_ref, F_ref = jax_runs[mesh]["eval"]
    assert E.shape == E_ref.shape == (int(np.prod(MESHES[mesh])),)
    np.testing.assert_allclose(E, E_ref, rtol=E_RTOL, atol=1e-6)
    np.testing.assert_allclose(E.sum(), E_ref.sum(), rtol=E_RTOL)
    np.testing.assert_allclose(F, F_ref, F_RTOL, F_ATOL)
    assert np.abs(F).max() > 1e-3


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_md_matches_jax(port, jax_runs, mesh):
    """10 NVE steps of ``make_sharded_column_md``: positions and momenta
    within 2e-4 of the JAX package's."""
    R, p = _results(port, mesh)["md"]
    R_ref, p_ref = jax_runs[mesh]["md"]
    np.testing.assert_allclose(R, R_ref, MD_TOL, MD_TOL)
    np.testing.assert_allclose(p, p_ref, MD_TOL, MD_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_rpmd_matches_jax(port, jax_runs, mesh):
    """6 steps of 3 beads of ``make_sharded_column_rpmd``."""
    R, p = _results(port, mesh)["rpmd"]
    R_ref, p_ref = jax_runs[mesh]["rpmd"]
    np.testing.assert_allclose(R, R_ref, MD_TOL, MD_TOL)
    np.testing.assert_allclose(p, p_ref, MD_TOL, MD_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_langevin_chunk_matches_jax_and_one_rank(port, jax_runs, cases,
                                                 mesh):
    """A 6-step Langevin chunk at kT = 0.03 against the JAX package's on
    the same mesh and against the port's on one rank: the noise is drawn
    per global column, so the split changes nothing but f32 sums."""
    ch = cases[1]
    R, p = _results(port, mesh)["chunk"]
    R_ref, p_ref = jax_runs[mesh]["chunk"]
    np.testing.assert_allclose(R, R_ref, MD_TOL, MD_TOL)
    np.testing.assert_allclose(p, p_ref, MD_TOL, MD_TOL)
    ins = column_inputs(ch["lay"], ch["R"], ch["Z"], device="cpu")
    fn = make_sharded_column_chunk(ch["pot"], ch["params"],
                                   make_column_mesh(1, device="cpu"),
                                   **CHUNK_KW)
    R1, p1 = fn(ins, *[torch.tensor(a, dtype=torch.float32)
                       for a in (ch["R_s"], ch["p0"], ch["mass"])],
                prng.prng_key(CHUNK_SEED))
    np.testing.assert_allclose(R, R1.double().numpy(), 1e-5, 1e-5)
    np.testing.assert_allclose(p, p1.double().numpy(), 1e-5, 1e-5)
    # the thermostat acted: the kinetic energy moved off the NVE chunk's
    assert np.abs(p - _results(port, mesh)["md"][1]).max() > 1e-3


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spatial_simulator_chunks_match_jax(port, jax_runs, mesh):
    """Two 5-step NVE chunks, then two Langevin chunks, of
    ``SpatialColumnSimulator`` (the ranks all-gather and re-bin the box
    at each chunk boundary) against the JAX package's on the same
    mesh."""
    res = _results(port, mesh)
    for key in ("sim", "sim_nvt"):
        R, p, rebuilds, chunk_key = res[key]
        R_ref, p_ref, rebuilds_ref, key_ref = jax_runs[mesh][key]
        assert rebuilds == rebuilds_ref == 2
        np.testing.assert_array_equal(chunk_key, key_ref)
        np.testing.assert_allclose(R, R_ref, rtol=MD_TOL, atol=MD_TOL)
        np.testing.assert_allclose(p, p_ref, rtol=MD_TOL, atol=MD_TOL)
