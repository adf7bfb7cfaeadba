"""Shared inputs of the PyTorch-port tests (numpy seeds; no jax import,
so the card-only tests run where jax is not installed)."""
import numpy as np
import torch

from schnetpack_tpu_torch.ops.cellblock import (
    build_cell_layout, build_column_layout,
)
from schnetpack_tpu_torch.ops.colblock import ColRefs
from schnetpack_tpu_torch.ops.radial import gaussian_rbf_table

# message op: f32 sums in another order than XLA's or the kernels'
MSG_RTOL, MSG_ATOL = 1e-4, 1e-5
MIX_RTOL, MIX_ATOL = 1e-4, 1e-5


def random_box(n=120, L=12.0, seed=0):
    """The inputs of ``tests/test_colblock.py::_random_box``."""
    rng = np.random.RandomState(seed)
    return rng.uniform(0, L, size=(n, 3)), np.eye(3) * L


def message_case(F=32, B=12, cutoff=3.0, seed=0):
    rng = np.random.RandomState(seed)
    R, cell = random_box(110, 11.0, seed)
    lay = build_column_layout(R, cutoff + 0.4, cell, np.ones(3, bool),
                              min_grid=3)
    Ap = len(lay.order)
    Rs = (R[lay.order] * lay.slot_mask[:, None]).astype(np.float32)
    coff_fm = np.ascontiguousarray(
        np.moveaxis(lay.offcol, -1, 2)).astype(np.float32)
    return dict(
        lay=lay, Rs=Rs, coff_fm=coff_fm, cutoff=cutoff, B=B,
        x=(rng.randn(Ap, 3 * F) * 0.3).astype(np.float32),
        mu=(rng.randn(Ap, 3 * F) * 0.3).astype(np.float32),
        FW=(rng.randn(B + 1, 3 * F) * 0.3).astype(np.float32),
        g_dq=rng.randn(Ap, F).astype(np.float32),
        g_dmu=rng.randn(Ap, 3 * F).astype(np.float32),
    )


def torch_message_args(c, device="cpu"):
    t = {k: torch.tensor(c[k], device=device)
         for k in ("x", "mu", "Rs", "FW", "coff_fm", "g_dq", "g_dmu")}
    refs = ColRefs.from_layout(c["lay"], device=device)
    cw = gaussian_rbf_table(c["B"], c["cutoff"], device=device)
    return t, refs, cw


def wide_column_case(P, seed, Ktot=1200, n_atoms=None):
    """A synthetic 3 x 3-column layout at capacity ``P`` (K8's and K14's
    capacity cases): random source and destination rows among each
    column's first ``n_atoms`` (default P - 7) rows, a fifth of the slots
    padded, bucket sizes Ktot // 9, positions in a 2 A cube and per-slot
    offsets in [-3, 3] A, so that every real slot has d > 0 and, at a
    3 A cutoff, some lie inside it and some beyond."""
    rng = np.random.RandomState(seed)
    nx = ny = 3
    n_atoms = n_atoms or P - 7
    qcol = rng.randint(0, n_atoms, size=(nx, ny, Ktot)).astype(np.int32)
    dcol = rng.randint(0, n_atoms, size=(nx, ny, Ktot)).astype(np.int32)
    pad = rng.rand(nx, ny, Ktot) < 0.2
    qcol[pad] = dcol[pad] = -1
    dcol[0, 0, :2] = (0, n_atoms - 1)           # the first and last rows
    qcol[0, 0, :2] = (1, 2)
    ksizes = (Ktot // 9,) * 8 + (Ktot - 8 * (Ktot // 9),)
    Rs = rng.uniform(0.0, 2.0, size=(nx * ny * P, 3)).astype(np.float32)
    coff_fm = rng.uniform(-3.0, 3.0, size=(nx, ny, 3, Ktot)).astype(
        np.float32)
    return dict(qcol=qcol, dcol=dcol, P=P, ksizes=ksizes, Rs=Rs,
                coff_fm=coff_fm)


def cfconv_case(F=32, B=8, seed=21, n=100, L=10.0):
    """Inputs of ``tests/test_schnet_columns.py::test_kernel_matches_xla_
    and_grads``: a random box, synthetic raw-phi geometry zeroed at padded
    slots, and random filter weights; plus a cotangent g of the output.
    Its box of n = 100 atoms and side L = 10 A makes one column; n = 110,
    L = 11 a 3 x 3 grid."""
    rng = np.random.RandomState(seed)
    R, cell = random_box(n, L, seed)
    lay = build_column_layout(R, 3.4, cell, np.ones(3, bool), min_grid=3)
    Ap = len(lay.order)
    geo = rng.randn(*lay.emask.shape, B + 4).astype(np.float32)
    geo *= lay.emask[..., None]
    return dict(
        lay=lay, B=B,
        h=rng.randn(Ap, F).astype(np.float32),
        geo=np.ascontiguousarray(np.moveaxis(geo, 3, 2)),
        W1=(rng.randn(B, F) * 0.3).astype(np.float32),
        b1=(rng.randn(F) * 0.1).astype(np.float32),
        W2=(rng.randn(F, F) * 0.2).astype(np.float32),
        b2=(rng.randn(F) * 0.1).astype(np.float32),
        g=rng.randn(Ap, F).astype(np.float32),
    )


def mixing_case(A=37, F=32, seed=0):
    """Random mixing inputs; the weights' scale 0.2 at F = 32 shrinks as
    1/sqrt(F), so the activations keep their size at any width."""
    rng = np.random.RandomState(seed)
    w = 0.2 * (32.0 / F) ** 0.5

    def r(*s, scale=1.0):
        return (rng.randn(*s) * scale).astype(np.float32)

    return dict(q=r(A, F), mu=r(A, 3 * F), dq=r(A, F, scale=0.5),
                dmu=r(A, 3 * F, scale=0.5), kmix=r(F, 2 * F, scale=w),
                k0=r(2 * F, F, scale=w), b0=r(F, scale=0.1),
                k1=r(F, 3 * F, scale=w), b1=r(3 * F, scale=0.1),
                gq=r(A, F), gmu=r(A, 3 * F))


MIX_INPUTS = ("q", "mu", "dq", "dmu", "kmix", "k0", "b0", "k1", "b1")


def cell_case(F=32, B=8, seed=9, n=90, L=10.0, cutoff=3.4, dims=None):
    """The box of ``tests/test_cellblock.py::TestFusedMessage``: a random
    periodic box in the 27-cell layout (a 2-cell grid per axis at these
    sizes: offsets alias; ``dims`` pins another grid), with features xmu
    [A', 6F], a basis zeroed at padded slots, directions and filter
    weights scaled as in ``message_case``, and cotangents of dq and
    dmu."""
    rng = np.random.RandomState(seed)
    R, cell = random_box(n, L, seed)
    lay = build_cell_layout(R, cutoff, cell, np.ones(3, bool), dims=dims)
    Ap, K = lay.nbh_idx.shape

    def r(*s, scale=1.0):
        return (rng.randn(*s) * scale).astype(np.float32)

    return dict(
        lay=lay, qidx=lay.qidx, xmu=r(Ap, 6 * F, scale=0.3),
        rbf=r(Ap, K, B + 1, scale=0.3) * lay.nbh_mask[..., None],
        dir=r(Ap, K, 3),
        FW=r(B + 1, 3 * F, scale=0.3), g_dq=r(Ap, F), g_dmu=r(Ap, 3 * F))


def narrow_row_sum_walk(vals, order, rowptr, lanes):
    """The narrow row sums of K12, K14 and K17 (``csrc/colblock_select.cu::
    row_sum_narrow_kernel``) on edge values ``vals`` [E, D] in their f32
    order: lane l of a row's group of ``lanes`` adds the slots
    order[rowptr[r] + l], order[rowptr[r] + l + lanes], ... from 0, then
    the group adds its partials by the butterfly of ``__shfl_xor_sync``
    (at offsets lanes / 2, ..., 1, lane l taking lane l ^ offset's).
    Returns the sums as lane d mod ``lanes`` writes element d, the lanes'
    final partials [A, lanes, D] and the reads per slot."""
    A, D = len(rowptr) - 1, vals.shape[1]
    start, end = rowptr[:-1].long(), rowptr[1:].long()
    lane = torch.arange(lanes)
    part = torch.zeros((A, lanes, D), dtype=vals.dtype)
    reads = torch.zeros(vals.shape[0], dtype=torch.int64)
    steps = -(-int((end - start).max()) // lanes) if A else 0
    for t in range(steps):
        pos = start[:, None] + lane + t * lanes
        live = pos < end[:, None]
        e = order[pos[live]].long()
        part[live] += vals[e]
        reads.index_add_(0, e, torch.ones_like(e))
    off = lanes // 2
    while off:
        part = part + part[:, lane ^ off]
        off //= 2
    d = torch.arange(D)
    return part[:, d % lanes, d], part, reads


def slab_case(grid, F=32, B=8, seed=0):
    """A random periodic box in the column layout on ``grid`` (nx, ny) with
    random xmu [A', 6F], a basis and directions zeroed at padded slots,
    filter weights and cotangents of dq and dmu (the row-12 message's
    inputs; a 2 on either axis aliases the offsets)."""
    rng = np.random.RandomState(seed)
    R, cell = random_box(110, 11.0, seed)
    lay = build_column_layout(R, 3.4, cell, np.ones(3, bool),
                              dims=(*grid, 1))
    Ap = len(lay.order)
    m = lay.emask[..., None]

    def r(*s, scale=1.0):
        return (rng.randn(*s) * scale).astype(np.float32)

    return dict(lay=lay, xmu=r(Ap, 6 * F, scale=0.3),
                rbf=r(*lay.emask.shape, B + 1, scale=0.3) * m,
                dir=r(*lay.emask.shape, 3) * m,
                FW=r(B + 1, 3 * F, scale=0.3), g_dq=r(Ap, F),
                g_dmu=r(Ap, 3 * F))


def grads_close(got: dict, want: dict, rtol: float):
    """The worst leaf (name, error) of a parameter gradient ``got`` against
    ``want`` (name -> tensor or array): per leaf ||g - w|| / ||w||, and
    for a leaf whose ||w|| is under 1e-3 of the largest leaf's, ||g - w||
    over 1e-3 of that largest norm; the gradient passes when the error is
    at most ``rtol``."""
    def arr(v):
        return np.asarray(v.detach().cpu().double() if torch.is_tensor(v)
                          else v, np.float64)

    norms = {k: np.linalg.norm(arr(w)) for k, w in want.items()}
    floor = 1e-3 * max(norms.values())
    errs = {k: np.linalg.norm(arr(got[k]) - arr(want[k]))
            / max(norms[k], floor) for k in want}
    worst = max(errs, key=errs.get)
    return worst, float(errs[worst])


def fcc_argon(n_cells: int, a: float = 5.26, jitter: float = 0.0,
              seed: int = 0, stretch: float = 1.0):
    """FCC argon supercell of n_cells^3 unit cells (``bench.py::fcc_box``;
    14 cells: the 10,976-atom bench box), jittered uniformly by
    +-``jitter`` A from a numpy seed and scaled by ``stretch``."""
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                    -1).reshape(-1, 1, 3)
    R = ((base[None] + grid) * a).reshape(-1, 3)
    R = R + np.random.RandomState(seed).uniform(-jitter, jitter, R.shape)
    return R * stretch, np.eye(3) * a * n_cells * stretch


def column_inputs(R, cell, build_cutoff, device="cpu"):
    """(layout, model inputs) of one molecule on the column layout, as the
    MD calculator hands them to the model (``test_torch_port_model.py::
    port_inputs`` without jax)."""
    from schnetpack_tpu_torch import properties as TP

    lay = build_column_layout(R, build_cutoff, cell, np.ones(3, bool),
                              min_grid=3)
    Rs = (R[lay.order] * lay.slot_mask[:, None]).astype(np.float32)
    inputs = {
        TP.R: torch.tensor(Rs),
        TP.Z: torch.tensor(np.where(lay.slot_mask > 0, 18, 0)),
        TP.idx_m: torch.zeros(len(lay.order), dtype=torch.int64),
        TP.atom_mask: torch.tensor(lay.slot_mask),
        TP.n_atoms: torch.tensor([len(R)]),
        TP.cell_qcol: torch.tensor(lay.qcol),
        TP.cell_dcol: torch.tensor(lay.dcol),
        TP.cell_coff_fm: torch.tensor(np.ascontiguousarray(
            np.moveaxis(lay.offcol, -1, 2)).astype(np.float32)),
    }
    inputs = {k: v.to(device) for k, v in inputs.items()}
    inputs[TP.cell_ksz] = tuple(lay.ksizes)
    return lay, inputs


def pair_layout_inputs(R, cutoff, Z=None, n_neighbors=None):
    """(flat inputs, dense inputs) of one molecule at positions ``R``
    (float32, no cell): the pair list within ``cutoff`` from the port's
    host neighbor list, and the [A, K] matrix of the same pairs (padded
    slots point to the last atom with mask 0, as the MD neighbor list
    pads) with its reverse map and the MD calculator's one-pair flat list
    that carries no pair."""
    from schnetpack_tpu_torch import properties as TP
    from schnetpack_tpu_torch.ops.neighbor_gather import build_reverse_map
    from schnetpack_tpu_torch.transform.neighborlist import neighbor_list

    A = len(R)
    i, j, _ = neighbor_list(R, cutoff)
    base = {
        TP.R: torch.tensor(R, dtype=torch.float32),
        TP.Z: torch.tensor(np.full(A, 18) if Z is None else Z),
        TP.idx_m: torch.zeros(A, dtype=torch.int64),
        TP.atom_mask: torch.ones(A),
        TP.n_atoms: torch.tensor([A]),
    }
    flat = dict(base, **{
        TP.idx_i: torch.tensor(i), TP.idx_j: torch.tensor(j),
        TP.offsets: torch.zeros(len(i), 3),
        TP.pair_mask: torch.ones(len(i))})
    counts = np.bincount(i, minlength=A)
    K = n_neighbors or int(counts.max()) + 1
    slots = np.arange(len(i)) - np.searchsorted(i, i)
    nbh = np.full((A, K), A - 1, np.int64)
    mask = np.zeros((A, K), np.float32)
    nbh[i, slots] = j
    mask[i, slots] = 1.0
    dense = dict(base, **{
        TP.nbh_idx: torch.tensor(nbh), TP.nbh_mask: torch.tensor(mask),
        TP.nbh_offsets: torch.zeros(A, K, 3),
        TP.nbh_rev: torch.tensor(build_reverse_map(
            i, j, np.zeros((len(i), 3)), slots, A, K)),
        TP.idx_i: torch.zeros(1, dtype=torch.int32),
        TP.idx_j: torch.zeros(1, dtype=torch.int32),
        TP.offsets: torch.full((1, 3), 1e3),
        TP.pair_mask: torch.zeros(1)})
    return flat, dense
