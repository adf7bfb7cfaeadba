"""Batching: collate variable-size molecules into fixed-shape padded batches
(a copy of ``schnetpack_tpu/data/loader.py``: the same keys, dtypes and
padding, as numpy arrays; the caller moves a batch to its device).

The collate concatenates ragged samples, shifts the pair indices, pads to
a ``PaddingSpec`` and emits validity masks:

* atoms padded with Z=0 at slots [n_real_atoms, A); their ``idx_m`` points
  to the last (padding) molecule slot M-1;
* pairs padded with ``idx_i = idx_j = A-1`` (a padding atom) and an offset
  of (1e3, 0, 0) so the pair distance is far beyond any cutoff — padded
  pairs are zeroed both by the cutoff envelope and by ``pair_mask``;
* per-molecule properties padded with zeros, ``mol_mask`` marks real ones.

The spec always reserves at least one padding atom and one padding molecule
so masked scatters never alias real data.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from .. import properties as structure

PAD_OFFSET = 1.0e3  # Cartesian x-offset given to padded pairs

_PAIR_KEYS = {
    structure.idx_i: (structure.idx_j, structure.offsets, structure.pair_mask),
    structure.idx_i_lr: (structure.idx_j_lr, structure.offsets_lr, structure.pair_mask_lr),
}


@dataclasses.dataclass(frozen=True)
class PaddingSpec:
    """Static shape budget for one batch.

    ``n_neighbors > 0`` additionally emits the dense neighbor-matrix layout
    (``_nbh_idx``/``_nbh_mask``/``_nbh_offsets``, [A, K]) — the TPU-fast
    path: message aggregation becomes a reduction over the K axis instead
    of a scatter (see representation modules).
    """

    n_atoms: int
    n_pairs: int
    n_molecules: int
    n_pairs_lr: int = 0
    n_triples: int = 0
    n_neighbors: int = 0

    def validate(self, total_atoms: int, total_pairs: int, n_mol: int):
        if self.n_atoms < total_atoms + 1:
            raise ValueError(
                f"PaddingSpec.n_atoms={self.n_atoms} too small for "
                f"{total_atoms} atoms (+1 padding slot required)"
            )
        if self.n_pairs < total_pairs:
            raise ValueError(
                f"PaddingSpec.n_pairs={self.n_pairs} too small for {total_pairs} pairs"
            )
        if self.n_molecules < n_mol + 1:
            raise ValueError(
                f"PaddingSpec.n_molecules={self.n_molecules} too small for "
                f"{n_mol} molecules (+1 padding slot required)"
            )


def round_up(x: int, multiple: int) -> int:
    return int(math.ceil(max(x, 1) / multiple) * multiple)


def padding_for(
    samples: Sequence[Dict[str, np.ndarray]],
    atom_multiple: int = 16,
    pair_multiple: int = 128,
    mol_extra: int = 1,
) -> PaddingSpec:
    """Tight spec for one list of samples, rounded to compile-friendly buckets."""
    ta = sum(len(s[structure.Z]) for s in samples)
    tp = sum(len(s.get(structure.idx_i, ())) for s in samples)
    tlr = sum(len(s.get(structure.idx_i_lr, ())) for s in samples)
    ttr = sum(len(s.get(structure.idx_j_triples, ())) for s in samples)
    return PaddingSpec(
        n_atoms=round_up(ta + 1, atom_multiple),
        n_pairs=round_up(tp, pair_multiple),
        n_molecules=len(samples) + mol_extra,
        n_pairs_lr=round_up(tlr, pair_multiple) if tlr else 0,
        n_triples=round_up(ttr, pair_multiple) if ttr else 0,
    )


def _float(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == np.float64 else x


def collate(
    samples: Sequence[Dict[str, np.ndarray]],
    spec: Optional[PaddingSpec] = None,
    float_dtype=np.float32,
) -> Dict[str, np.ndarray]:
    if spec is None:
        spec = padding_for(samples)
    n_mol = len(samples)
    n_atoms_per = np.array([len(s[structure.Z]) for s in samples], dtype=np.int32)
    total_atoms = int(n_atoms_per.sum())
    atom_off = np.concatenate([[0], np.cumsum(n_atoms_per)]).astype(np.int32)

    pairs_per = np.array(
        [len(s.get(structure.idx_i, ())) for s in samples], dtype=np.int32
    )
    total_pairs = int(pairs_per.sum())
    spec.validate(total_atoms, total_pairs, n_mol)

    A, P, M = spec.n_atoms, spec.n_pairs, spec.n_molecules
    batch: Dict[str, np.ndarray] = {}

    # --- atoms ---------------------------------------------------------
    Z = np.zeros(A, dtype=np.int32)
    R = np.zeros((A, 3), dtype=float_dtype)
    idx_m = np.full(A, M - 1, dtype=np.int32)
    for k, s in enumerate(samples):
        a0, a1 = atom_off[k], atom_off[k + 1]
        Z[a0:a1] = s[structure.Z]
        R[a0:a1] = s[structure.R]
        idx_m[a0:a1] = k
    batch[structure.Z] = Z
    batch[structure.R] = R
    batch[structure.idx_m] = idx_m
    atom_mask = np.zeros(A, dtype=float_dtype)
    atom_mask[:total_atoms] = 1.0
    batch[structure.atom_mask] = atom_mask

    # --- molecules -----------------------------------------------------
    n_at = np.zeros(M, dtype=np.int32)
    n_at[:n_mol] = n_atoms_per
    batch[structure.n_atoms] = n_at
    seg = np.full(M + 1, total_atoms, dtype=np.int32)
    seg[: n_mol + 1] = atom_off
    batch[structure.seg_m] = seg
    mol_mask = np.zeros(M, dtype=float_dtype)
    mol_mask[:n_mol] = 1.0
    batch[structure.mol_mask] = mol_mask

    cell = np.zeros((M, 3, 3), dtype=float_dtype)
    pbc = np.zeros((M, 3), dtype=bool)
    for k, s in enumerate(samples):
        if structure.cell in s and s[structure.cell] is not None:
            cell[k] = s[structure.cell]
        if structure.pbc in s and s[structure.pbc] is not None:
            pbc[k] = s[structure.pbc]
    batch[structure.cell] = cell
    batch[structure.pbc] = pbc

    # --- pair lists (short-range and optional long-range) ---------------
    def _collate_pairs(key_i, key_j, key_off, key_mask, P_budget):
        ii = np.full(P_budget, A - 1, dtype=np.int32)
        jj = np.full(P_budget, A - 1, dtype=np.int32)
        off = np.zeros((P_budget, 3), dtype=float_dtype)
        off[:, 0] = PAD_OFFSET
        mask = np.zeros(P_budget, dtype=float_dtype)
        p = 0
        for k, s in enumerate(samples):
            if key_i not in s:
                continue
            np_k = len(s[key_i])
            ii[p: p + np_k] = s[key_i] + atom_off[k]
            jj[p: p + np_k] = s[key_j] + atom_off[k]
            off[p: p + np_k] = s[key_off]
            mask[p: p + np_k] = 1.0
            p += np_k
        batch[key_i] = ii
        batch[key_j] = jj
        batch[key_off] = off
        batch[key_mask] = mask

    _collate_pairs(
        structure.idx_i, structure.idx_j, structure.offsets, structure.pair_mask, P
    )
    if spec.n_pairs_lr:
        _collate_pairs(
            structure.idx_i_lr,
            structure.idx_j_lr,
            structure.offsets_lr,
            structure.pair_mask_lr,
            spec.n_pairs_lr,
        )

    # --- triples ---------------------------------------------------------
    if spec.n_triples:
        ti = np.full(spec.n_triples, A - 1, dtype=np.int32)
        tj = np.full(spec.n_triples, P - 1 if P else 0, dtype=np.int32)
        tk = np.full(spec.n_triples, P - 1 if P else 0, dtype=np.int32)
        tmask = np.zeros(spec.n_triples, dtype=float_dtype)
        p = 0
        pair_off = np.concatenate([[0], np.cumsum(pairs_per)])
        for k, s in enumerate(samples):
            if structure.idx_j_triples not in s:
                continue
            nt = len(s[structure.idx_j_triples])
            ti[p: p + nt] = s[structure.idx_i_triples] + atom_off[k]
            tj[p: p + nt] = s[structure.idx_j_triples] + pair_off[k]
            tk[p: p + nt] = s[structure.idx_k_triples] + pair_off[k]
            tmask[p: p + nt] = 1.0
            p += nt
        batch[structure.idx_i_triples] = ti
        batch[structure.idx_j_triples] = tj
        batch[structure.idx_k_triples] = tk
        batch[structure.triple_mask] = tmask

    # --- dense neighbor matrix ------------------------------------------
    if spec.n_neighbors:
        K = spec.n_neighbors
        nbh = np.full((A, K), A - 1, dtype=np.int32)
        nmask = np.zeros((A, K), dtype=float_dtype)
        noff = np.zeros((A, K, 3), dtype=float_dtype)
        noff[:, :, 0] = PAD_OFFSET
        valid = batch[structure.pair_mask] > 0
        iiv = batch[structure.idx_i][valid]
        jjv = batch[structure.idx_j][valid]
        offv = batch[structure.offsets][valid]
        # pairs are globally sorted by center atom: slot = rank within group
        counts = np.bincount(iiv, minlength=A)
        if counts.max(initial=0) > K:
            raise ValueError(
                f"an atom has {counts.max()} neighbors > n_neighbors={K}"
            )
        starts = np.zeros(A + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        slots = np.arange(len(iiv)) - starts[iiv]
        nbh[iiv, slots] = jjv
        noff[iiv, slots] = offv
        nmask[iiv, slots] = 1.0
        batch[structure.nbh_idx] = nbh
        batch[structure.nbh_mask] = nmask
        batch[structure.nbh_offsets] = noff
        # reverse-edge map enabling the scatter-free gather VJP
        from ..ops.neighbor_gather import build_reverse_map

        batch[structure.nbh_rev] = build_reverse_map(
            iiv, jjv, offv, slots, A, K
        )

    # --- everything else: targets / extra per-atom or per-molecule data ---
    handled = set(batch) | {structure.idx, structure.n_atoms, structure.seg_m}
    for key in samples[0]:
        if key in handled:
            continue
        vals = [np.asarray(s[key]) for s in samples]
        v0 = vals[0]
        # per-atom iff the leading dim matches the atom count of EVERY
        # sample AND the key is not registered as per-molecule (a (3,)
        # dipole target in a batch of 3-atom molecules must not misroute)
        per_atom = (
            v0.ndim >= 1
            and key != structure.pbc
            and key not in structure.per_molecule_keys
            and all(v.ndim >= 1 and v.shape[0] == n for v, n in zip(vals, n_atoms_per))
        )
        if per_atom:
            # per-atom property -> concatenate and pad along atoms
            out = np.zeros((A,) + v0.shape[1:], dtype=float_dtype if np.issubdtype(v0.dtype, np.floating) else v0.dtype)
            for k, v in enumerate(vals):
                out[atom_off[k]: atom_off[k + 1]] = v
            batch[key] = out
        elif v0.ndim >= 1 and all(v.shape[0] == 1 for v in vals):
            # per-molecule property stored with a LEADING SINGLETON dim
            # (the reference DB convention for molecule scalars/vectors:
            # energy (1,), dipole (1, 3), polarizability (1, 3, 3)) ->
            # concatenate along it: energy -> [M], dipole -> [M, 3].
            # Stacking instead would yield [M, 1] energy targets that
            # silently BROADCAST against [M] Atomwise predictions in the
            # loss ([M, M] error matrix -> trains toward the label mean).
            out = np.zeros(
                (M,) + v0.shape[1:],
                dtype=float_dtype if np.issubdtype(v0.dtype, np.floating) else v0.dtype,
            )
            for k, v in enumerate(vals):
                out[k] = v[0]
            batch[key] = out
        else:
            # per-molecule property -> stack and pad along molecules
            out = np.zeros((M,) + v0.shape, dtype=float_dtype if np.issubdtype(v0.dtype, np.floating) else v0.dtype)
            for k, v in enumerate(vals):
                out[k] = v
            batch[key] = out

    if structure.idx in samples[0]:
        idxs = np.full(M, -1, dtype=np.int32)
        for k, s in enumerate(samples):
            idxs[k] = np.asarray(s[structure.idx]).reshape(-1)[0]
        batch[structure.idx] = idxs
    return batch


class AtomsLoader:
    """Minimal single-process batch iterator with static padding.

    ``padding``: a fixed PaddingSpec, or None to compute per-batch bucketed
    specs.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        padding: Optional[PaddingSpec] = None,
        padding_buckets: Optional[Sequence[PaddingSpec]] = None,
        drop_last: bool = False,
        seed: int = 0,
        indices: Optional[Sequence[int]] = None,
        sampler=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.padding = padding
        # sorted list of specs; each batch picks the smallest fitting one
        # (bounded recompiles, much less padding waste on heterogeneous data)
        self.padding_buckets = (
            sorted(padding_buckets, key=lambda s: s.n_atoms)
            if padding_buckets else None
        )
        self.drop_last = drop_last
        self.indices = list(indices) if indices is not None else list(range(len(dataset)))
        self.sampler = sampler
        self._rng = np.random.RandomState(seed)
        self._epoch = 0

    def _spec_for(self, samples):
        if self.padding_buckets:
            ta = sum(len(s[structure.Z]) for s in samples)
            tp = sum(len(s.get(structure.idx_i, ())) for s in samples)
            for spec in self.padding_buckets:
                if spec.n_atoms >= ta + 1 and spec.n_pairs >= tp:
                    return spec
            return self.padding_buckets[-1]
        return self.padding

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.sampler is not None:
            order = list(self.sampler)
        elif self.shuffle:
            order = list(self.indices)
            self._rng.shuffle(order)
        else:
            order = self.indices
        self._epoch += 1
        for b0 in range(0, len(order), self.batch_size):
            chunk = order[b0: b0 + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            samples = [self.dataset[i] for i in chunk]
            yield collate(samples, self._spec_for(samples))


def static_padding_for_dataset(
    dataset,
    batch_size: int,
    indices: Optional[Sequence[int]] = None,
    sample_limit: int = 512,
    safety: float = 1.05,
    dense_layout: bool = False,
) -> PaddingSpec:
    """Scan (a subsample of) the dataset and derive one static PaddingSpec
    covering any batch of ``batch_size`` samples — so training compiles once.

    ``dense_layout=True`` additionally sizes ``n_neighbors`` (max per-atom
    neighbor count over the scan, with headroom) so collate emits the dense
    [A, K] neighbor matrix and training runs the scatter-free K-axis
    aggregation path instead of flat gather/segment-sum."""
    idxs = list(indices) if indices is not None else list(range(len(dataset)))
    if len(idxs) > sample_limit:
        step = len(idxs) // sample_limit
        idxs = idxs[::step][:sample_limit]
    max_atoms = 1
    max_pairs = 1
    max_lr = 0
    max_tr = 0
    max_nbrs = 0
    for i in idxs:
        s = dataset[i]
        max_atoms = max(max_atoms, len(s[structure.Z]))
        max_pairs = max(max_pairs, len(s.get(structure.idx_i, ())))
        max_lr = max(max_lr, len(s.get(structure.idx_i_lr, ())))
        max_tr = max(max_tr, len(s.get(structure.idx_j_triples, ())))
        if dense_layout and structure.idx_i in s and len(s[structure.idx_i]):
            max_nbrs = max(max_nbrs, int(np.bincount(
                np.asarray(s[structure.idx_i])).max()))
    return PaddingSpec(
        n_atoms=round_up(int(batch_size * max_atoms * safety) + 1, 16),
        n_pairs=round_up(int(batch_size * max_pairs * safety), 128),
        n_molecules=batch_size + 1,
        n_pairs_lr=round_up(int(batch_size * max_lr * safety), 128) if max_lr else 0,
        n_triples=round_up(int(batch_size * max_tr * safety), 128) if max_tr else 0,
        n_neighbors=(round_up(int(max_nbrs * safety) + 1, 4)
                     if dense_layout and max_nbrs else 0),
    )
