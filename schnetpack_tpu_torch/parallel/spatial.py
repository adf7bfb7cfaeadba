"""The flat layout split over a mesh of ranks (port of
``schnetpack_tpu/parallel/spatial.py``).

The JAX package shards the atom and pair axes of a padded batch over a
mesh axis and lets XLA's SPMD partitioner place the collectives; every
device's memory stays O(total atoms) there (``spatial.py:4-8``).  Torch
has no partitioner, so the port keeps that semantics with the pair axis
split and the atom arrays replicated: each rank evaluates its share of
the pairs, and the two places where the flat layout crosses between the
atoms and the pairs (``ops/scatter.py::enter_pairs`` at the gathers of
``atomistic/distances.py``, ``leave_pairs`` at its segment sums) sum over
the ranks, forward or backward.  Every module that reads the pair list
itself goes through the same two crossings (``pair_take``/``pair_sum``:
ZBL, Coulomb, Ewald's real-space sum, ``Strain``'s offsets, the
long-range list's ``Rij_lr``).  The energy, the forces, the stress and
every other atom array then come out whole and equal on every rank.  A
parameter's gradient does not (the pair side holds each rank's share),
so the model refuses a call that could train (``model/base.py``):
evaluate with frozen parameters or under ``torch.no_grad()``, and train
data-parallel.  Every pair array must split evenly over the ranks
(``pad_batch_for_mesh``): one left whole would be summed once a rank.
For large boxes the slab path (``parallel/columns.py``) splits the atoms
too.

Usage, on every rank of a joined group::

    mesh = make_mesh(D, axis_names=("atoms",), device="cuda")
    batch = pad_batch_for_mesh(batch, D)
    local, shardings = shard_batch_by_atoms(batch, mesh)
    with torch.no_grad():
        out = model(local)   # energies and forces of the whole batch
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import properties as structure
from .mesh import MeshError

#: keys whose leading axis is the atom axis (replicated here)
_ATOM_KEYS = {
    structure.Z, structure.R, structure.idx_m, structure.atom_mask,
    structure.nbh_idx, structure.nbh_mask, structure.nbh_offsets,
    structure.nbh_rev, structure.forces,
}
#: keys whose leading axis is the pair axis (split over the ranks)
_PAIR_KEYS = {
    structure.idx_i, structure.idx_j, structure.offsets, structure.pair_mask,
    structure.idx_i_lr, structure.idx_j_lr, structure.offsets_lr,
    structure.pair_mask_lr,
}


def batch_shardings(batch: Dict[str, np.ndarray], mesh,
                    axis: str = "atoms") -> Dict[str, Optional[str]]:
    """For every batch key, the mesh axis its leading axis is split over
    (``axis`` for a pair array whose length the ranks divide) or None
    (replicated: atom and per-molecule arrays)."""
    n = mesh.axis_size(axis)
    return {k: (axis if k in _PAIR_KEYS and np.shape(v)
                and np.shape(v)[0] % n == 0 else None)
            for k, v in batch.items()}


def shard_batch_by_atoms(batch: Dict[str, np.ndarray], mesh,
                         axis: str = "atoms"
                         ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(this rank's batch on its device, ``batch_shardings``): the rank's
    contiguous share of each pair array, every other array whole, and the
    mesh under ``pair_mesh``.  A pair array whose length the ranks do not
    divide raises ``MeshError``."""
    shardings = batch_shardings(batch, mesh, axis)
    uneven = sorted(k for k in _PAIR_KEYS & set(batch) if shardings[k] is None)
    if uneven:
        raise MeshError(
            f"pair arrays {uneven} do not split over {mesh.axis_size(axis)} "
            "ranks: pad the batch with pad_batch_for_mesh first")
    r, n = mesh.axis_index(axis), mesh.axis_size(axis)
    local = {}
    for k, v in batch.items():
        v = torch.as_tensor(np.asarray(v))
        if shardings[k] is not None:
            m = v.shape[0] // n
            v = v[r * m:(r + 1) * m]
        local[k] = v.to(mesh.device)
    local[structure.pair_mesh] = mesh
    return local, shardings


def pad_batch_for_mesh(batch: Dict[str, np.ndarray],
                       n_devices: int) -> Dict[str, np.ndarray]:
    """Pad the atom and pair axes up to multiples of ``n_devices``
    (padding atoms follow the standard conventions: Z = 0, idx_m the pad
    molecule, masks 0; padded pairs point at the last atom with mask 0),
    as the JAX package's ``pad_batch_for_mesh``."""
    out = dict(batch)
    A = len(batch[structure.Z])
    M = batch[structure.n_atoms].shape[0]

    def pad_to(x, target, fill):
        n = target - x.shape[0]
        if n <= 0:
            return x
        padding = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
        return np.concatenate([x, padding])

    A2 = -(-A // n_devices) * n_devices
    if A2 != A:
        out[structure.Z] = pad_to(batch[structure.Z], A2, 0)
        out[structure.R] = pad_to(batch[structure.R], A2, 0.0)
        out[structure.idx_m] = pad_to(batch[structure.idx_m], A2, M - 1)
        out[structure.atom_mask] = pad_to(batch[structure.atom_mask], A2, 0.0)
        for k in (structure.nbh_idx, structure.nbh_rev):
            if k in batch:
                out[k] = pad_to(batch[k], A2,
                                A - 1 if k == structure.nbh_idx else 0)
        if structure.nbh_mask in batch:
            out[structure.nbh_mask] = pad_to(batch[structure.nbh_mask], A2,
                                             0.0)
        if structure.nbh_offsets in batch:
            out[structure.nbh_offsets] = pad_to(batch[structure.nbh_offsets],
                                                A2, 0.0)
    for k in _PAIR_KEYS:
        if k in out:
            Pn = out[k].shape[0]
            P2 = -(-Pn // n_devices) * n_devices
            fill = 0.0 if out[k].dtype.kind == "f" else (A2 - 1)
            if "mask" in k:
                fill = 0.0
            out[k] = pad_to(out[k], P2, fill)
    return out
