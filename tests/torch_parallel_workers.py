"""Rank workers of the port's multi-rank tests (``test_torch_port_parallel
.py``, ``test_torch_port_data_parallel.py``), started by
``parallel.mesh.spawn_ranks`` as gloo processes on the CPU.  A spawned
rank imports this module by name, so it imports torch and the port only,
never JAX.  Each worker takes its inputs whole, cuts its rank's part, and
returns numpy results (the slab path's gathered into sorted column
order), so that the test compares any rank's with the JAX package's."""
import numpy as np
import torch

from schnetpack_tpu_torch import properties as P
from schnetpack_tpu_torch.convert import params_to_jax
from schnetpack_tpu_torch.md import prng
from schnetpack_tpu_torch.ops.cellblock import build_column_layout
from schnetpack_tpu_torch.ops.colblock_shard import (
    COLS_AXIS, COLS_AXIS_Y, halo_xy,
)
from schnetpack_tpu_torch.parallel import (
    DataParallelTask, SpatialColumnSimulator, column_inputs, gather_slabs,
    make_column_mesh, make_mesh, make_parallel_eval_step,
    make_sharded_column_chunk,
    make_sharded_column_eval, make_sharded_column_md,
    make_sharded_column_rpmd, slab_of,
)
from schnetpack_tpu_torch.parallel.spatial import shard_batch_by_atoms
from schnetpack_tpu_torch.train import AtomisticTask


def column_mesh(dims):
    """x slabs for a 1-tuple, (x, y) blocks for a pair; on the CPU."""
    two_d = len(dims) == 2
    return make_column_mesh(int(np.prod(dims)), dims if two_d else None,
                            device="cpu")


def halo(rank, cases):
    """For each (dims, table [nx, ny, P, D], cotangent): this rank's
    halo'd slab and the VJP of the halo in its slab, for the cotangent's
    block of this rank (the cotangent is laid out as JAX's shard_map
    output: the ranks' halo'd slabs side by side), whether y has its
    halo too, and whether a double backward through the exchange
    raised."""
    torch.set_num_threads(1)
    out = []
    for dims, table, cot in cases:
        mesh = column_mesh(dims)
        x0, nxl, y0, nyl = mesh.slab(*table.shape[:2])
        t = torch.tensor(table[x0:x0 + nxl, y0:y0 + nyl]).requires_grad_(True)
        axes = (COLS_AXIS, COLS_AXIS_Y) if mesh.two_d else COLS_AXIS
        h, hy = halo_xy(t, axes, mesh)
        sx, sy = h.shape[:2]
        cx = mesh.coords
        iy = cx[1] if mesh.two_d else 0
        g = cot[cx[0] * sx:(cx[0] + 1) * sx, iy * sy:(iy + 1) * sy]
        (d,) = torch.autograd.grad(h, t, torch.tensor(g), create_graph=True)
        try:
            torch.autograd.grad(d.sum(), t)
            twice = False
        except RuntimeError:
            twice = True
        out.append((h.detach().numpy(), d.detach().numpy(), hy, twice))
    return out


def _np(t):
    return t.detach().double().numpy()


def slab_path(rank, dims, jobs):
    """The slab path's jobs on the mesh ``dims``; each job a (kind,
    arguments) pair, kind one of eval, md, rpmd, chunk, sim."""
    torch.set_num_threads(1)
    mesh = column_mesh(dims)
    out = []
    for kind, a in jobs:
        if kind == "sim":
            sim = SpatialColumnSimulator(
                a["pot"], a["params"], a["R"], a["Z"], a["masses"], a["cell"],
                mesh, cutoff=a["cutoff"], skin=0.5, dims=a["grid"], dt=0.2,
                **a.get("nvt", {}))
            sim.p = a["p0"].copy()
            sim.simulate(10, chunk_size=5)
            out.append((sim.R, sim.p, sim.rebuilds, sim.key.numpy()))
            continue
        lay = build_column_layout(a["R"], a["cutoff"], a["cell"],
                                  np.ones(3, bool), dims=a["grid"])
        ins = column_inputs(lay, a["R"], a["Z"], mesh=mesh)

        def cut(x, lead=0):
            x = torch.as_tensor(x, dtype=torch.float32)
            if lead:
                return torch.stack([slab_of(lay, mesh, b) for b in x])
            return slab_of(lay, mesh, x)

        def whole(x, lead=0):
            if lead:
                return np.stack([_np(gather_slabs(lay, mesh, b)) for b in x])
            return _np(gather_slabs(lay, mesh, x))

        if kind == "eval":
            E, F = make_sharded_column_eval(a["pot"], a["params"], ins,
                                            mesh)(ins)
            out.append((_np(E), whole(F)))
        elif kind == "md":
            fn = make_sharded_column_md(a["pot"], a["params"], ins, mesh,
                                        **a["kw"])
            R, p = fn(ins, cut(a["R_s"]), cut(a["p0"]))
            out.append((whole(R), whole(p)))
        elif kind == "rpmd":
            fn = make_sharded_column_rpmd(a["pot"], a["params"], ins, mesh,
                                          **a["kw"])
            R, p = fn(ins, cut(a["beads"], 1), cut(a["pb"], 1))
            out.append((whole(R, 1), whole(p, 1)))
        elif kind == "chunk":
            fn = make_sharded_column_chunk(a["pot"], a["params"], mesh,
                                           **a["kw"])
            R, p = fn(ins, cut(a["R_s"]), cut(a["p0"]), cut(a["mass"]),
                      prng.prng_key(a["seed"]))
            out.append((whole(R), whole(p)))
        else:
            raise ValueError(kind)
    return out


def slab_path_and_halo(rank, dims, jobs, halo_cases):
    """``slab_path`` and ``halo`` in one spawn of the ranks."""
    return slab_path(rank, dims, jobs), halo(rank, halo_cases)


def _data_parallel(mesh, rank, pot, outputs, task_kw, batches, n_steps):
    if rank:
        # rank 0's weights reach every rank through the broadcast
        with torch.no_grad():
            for p in pot.parameters():
                p.add_(1.0)
    task = AtomisticTask(pot, outputs, **task_kw)
    dp = DataParallelTask(task, mesh)
    state = task.create_state()
    metrics = []
    for _ in range(n_steps):
        state, m = dp.train_step(state, batches[rank])
        metrics.append({k: (float(v), float(c)) for k, (v, c) in m.items()})
    val = make_parallel_eval_step(task, mesh)(task.eval_params(state),
                                              batches[rank])
    return (params_to_jax(task.model),
            params_to_jax(task.model, state.ema_params), metrics,
            {k: (float(v), float(c)) for k, (v, c) in val.items()})


def _pair_sharded(mesh, pot, batch, keys):
    local, shardings = shard_batch_by_atoms(batch, mesh)
    with torch.no_grad():
        out = pot(local)
    return ({k: _np(out[k]) for k in keys}, int(local[P.idx_i].shape[0]),
            shardings[P.idx_i])


def data_parallel(rank, dp_cases, pair_cases):
    """Each data-parallel case (pot, outputs, task keywords, one batch a
    rank, steps) on a ``data`` mesh of every rank, rank r on batch r: the
    parameters and the EMA copy as flax trees, each step's metrics and
    ``make_parallel_eval_step``'s; then each pair-split case (pot, batch,
    output keys) on an ``atoms`` mesh (``parallel/spatial.py``): the
    outputs of those keys, the rank's pairs and the split axis."""
    torch.set_num_threads(1)
    n = torch.distributed.get_world_size()
    mesh = make_mesh(n, ("data",), device="cpu")
    dp = [_data_parallel(mesh, rank, *c) for c in dp_cases]
    atoms = make_mesh(n, ("atoms",), device="cpu")
    return dp, [_pair_sharded(atoms, *c) for c in pair_cases]


def halo_kernels(rank, lay, F, B, seed):
    """K11/K12 and K20/K21 in their halo modes on this rank's slab of
    ``lay`` over two gloo ranks on the card, the halo planes from the
    other rank, against the twins' route on the CPU over the same mesh:
    the largest errors of the outputs and of the gradients, and the
    launches of the card's run."""
    from schnetpack_tpu_torch.ops import colblock_edge as edge
    from schnetpack_tpu_torch.ops import colblock_select as sel
    from schnetpack_tpu_torch.ops.colblock import ColRefs

    mesh = make_column_mesh(2, device="cuda", backend="gloo")
    nx, ny, P_, ks = lay.dims
    x0, nxl, _, _ = mesh.slab(nx, ny)
    rng = np.random.RandomState(seed + rank)
    A = nxl * ny * P_
    emask = lay.emask[x0:x0 + nxl, :, :, None]

    def r(*s, scale=1.0):
        return torch.tensor((rng.randn(*s) * scale).astype(np.float32))

    host = dict(table=r(A, 3), edges=r(nxl, ny, lay.qcol.shape[2], 3),
                xmu=r(A, 6 * F, scale=0.3),
                rbf=r(nxl, ny, lay.qcol.shape[2], B + 1, scale=0.3)
                * torch.tensor(emask, dtype=torch.float32),
                dir=r(nxl, ny, lay.qcol.shape[2], 3)
                * torch.tensor(emask, dtype=torch.float32),
                FW=r(B + 1, 3 * F, scale=0.3), g_dq=r(A, F),
                g_dmu=r(A, 3 * F))
    out, launches = {}, {}
    for dev in (torch.device("cpu"), mesh.device):
        refs = ColRefs(torch.as_tensor(lay.qcol[x0:x0 + nxl], device=dev),
                       torch.as_tensor(lay.dcol[x0:x0 + nxl], device=dev),
                       int(P_), tuple(int(k) for k in ks), COLS_AXIS, mesh)
        t = {k: v.to(dev) for k, v in host.items()}
        before = {**sel.LAUNCHES, **edge.LAUNCHES}
        table = t["table"].clone().requires_grad_(True)
        rows = sel.column_gather_op(table, refs)
        (dtable,) = torch.autograd.grad(rows, table, t["edges"])
        ins = [t[k].clone().requires_grad_(True)
               for k in ("xmu", "rbf", "dir")]
        dq, dmu = edge.painn_message_columns(*ins, t["FW"], refs)
        grads = torch.autograd.grad((dq, dmu), ins, (t["g_dq"], t["g_dmu"]))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            after = {**sel.LAUNCHES, **edge.LAUNCHES}
            launches = {k: after[k] - before[k] for k in after}
        out[dev.type] = [x.detach().cpu() for x in
                         (rows, dtable, dq, dmu, *grads)]
    names = ("K11", "K12", "K20 dq", "K20 dmu", "K21 dxmu", "K21 drbf",
             "K21 ddir")
    errs = {}
    for name, g, w in zip(names, out["cuda"], out["cpu"]):
        errs[name] = (float((g - w).abs().max()), float(w.abs().max()),
                      bool(torch.allclose(g, w, rtol=1e-4, atol=1e-5)))
    return errs, launches, nxl
