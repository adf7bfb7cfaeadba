"""
Canonical names for the keys of the flat batch dictionary.

Every layer of the framework communicates through a single flat
``Dict[str, torch.Tensor]`` whose keys are the string constants defined
here.  The strings are identical to ``schnetpack_tpu.properties``, so batch
dicts cross between the JAX package and this port unchanged; they mirror
the key registry of schnetpack (``src/schnetpack/properties.py:10-84``)
plus the keys of the fixed-shape padded and column-bucketed layouts.
"""
from typing import Dict, Final, List

# ---------------------------------------------------------------------------
# structure / indexing
# ---------------------------------------------------------------------------
idx: Final[str] = "_idx"

#: unique molecule/system id within a batch
idx_m: Final[str] = "_idx_m"
#: index of center atom of each pair
idx_i: Final[str] = "_idx_i"
#: index of neighbor atom of each pair
idx_j: Final[str] = "_idx_j"

#: long-range pair indices (beyond the short-range cutoff split)
idx_i_lr: Final[str] = "_idx_i_lr"
idx_j_lr: Final[str] = "_idx_j_lr"

lidx_i: Final[str] = "_idx_i_local"
lidx_j: Final[str] = "_idx_j_local"

#: triples (angular terms)
idx_i_triples: Final[str] = "_idx_i_triples"
idx_j_triples: Final[str] = "_idx_j_triples"
idx_k_triples: Final[str] = "_idx_k_triples"

#: nuclear charges [n_atoms]
Z: Final[str] = "_atomic_numbers"
#: atom positions [n_atoms, 3]
R: Final[str] = "_positions"
#: unit cells [n_molecules, 3, 3]
cell: Final[str] = "_cell"
#: periodic boundary condition flags [n_molecules, 3]
pbc: Final[str] = "_pbc"

#: pair displacement vectors R[idx_j] - R[idx_i] + offsets, [n_pairs, 3]
Rij: Final[str] = "_Rij"
Rij_lr: Final[str] = "_Rij_lr"
#: integer cell-shift offsets of each pair (in Cartesian coords) [n_pairs, 3]
offsets: Final[str] = "_offsets"
offsets_lr: Final[str] = "_offsets_lr"

#: number of atoms per molecule [n_molecules]
n_atoms: Final[str] = "_n_atoms"
#: cumulative segment boundaries (exclusive cumsum of n_atoms) [n_molecules+1]
seg_m: Final[str] = "_seg_m"
#: number of neighbors per atom [n_atoms]
n_nbh: Final[str] = "_n_nbh"

#: dense neighbor matrix [n_atoms, K]: j-index of each neighbor slot
nbh_idx: Final[str] = "_nbh_idx"
#: dense neighbor validity mask [n_atoms, K]
nbh_mask: Final[str] = "_nbh_mask"
#: dense per-slot PBC offsets [n_atoms, K, 3]
nbh_offsets: Final[str] = "_nbh_offsets"
#: dense displacement vectors [n_atoms, K, 3] (computed in-model)
nbh_rij: Final[str] = "_nbh_Rij"
#: reverse-edge map [n_atoms, K]: flat index of each edge's reverse edge
nbh_rev: Final[str] = "_nbh_rev"
#: cell-blocked candidate neighbor indices [nx, ny, nz, C, K] int32
#: (presence switches representations to the MXU selection-gather path;
#: atoms must be cell-sorted and the nbh_* arrays given in sorted space)
cell_qidx: Final[str] = "_cell_qidx"
#: column-bucketed source halo-row indices [nx, ny, 9, Kcol] int32
#: (presence switches representations to the column-kernel fast path)
cell_qcol: Final[str] = "_cell_qcol"
#: column-bucketed destination indices z*C + s [nx, ny, 9, Kcol] int32
cell_dcol: Final[str] = "_cell_dcol"
#: column-bucketed Cartesian periodic offsets [nx, ny, 9, Kcol, 3]
cell_coff: Final[str] = "_cell_coff"
#: feature-major Cartesian periodic offsets [nx, ny, 3, Ktot] (presence
#: enables the fused geometry kernel: R -> geo entirely in VMEM)
cell_coff_fm: Final[str] = "_cell_coff_fm"
#: column-bucketed edge mask [nx, ny, 9, Kcol]
cell_emask: Final[str] = "_cell_emask"
#: build cutoff of the dense neighbor matrix (scalar; consumers can
#: check long-range truncation against it)
nbh_cutoff: Final[str] = "_nbh_cutoff"
#: static bucket-size carrier: tuple of 9 zero arrays, shapes (ksizes[c9],)
cell_ksz: Final[str] = "_cell_ksz"
#: precomputed one-hot selection matrices for the column kernels
#: (ohj_parts 9-tuple, ohd_full, ohd_parts 9-tuple) — static between NBL
#: rebuilds; see ops/colblock.py build_onehots
cell_oh: Final[str] = "_cell_oh"
#: marker (any array): inputs are LOCAL slabs of a shard_map run over the
#: "cols" mesh axis; column ops then halo-exchange x-boundary planes
cell_shard: Final[str] = "_cell_shard"
#: the slab's mesh of ranks (``parallel.columns.ColumnMesh``): the halo
#: planes come from the neighbouring ranks (absent: one rank, the wrap)
cell_mesh: Final[str] = "_cell_mesh"
#: the mesh whose ranks split the flat pair list (``parallel/spatial.py``):
#: each rank holds its share of the pairs, every atom array whole
pair_mesh: Final[str] = "_pair_mesh"
#: column-layout per-edge displacement vectors [nx, ny, 9, Kcol, 3]
col_rij: Final[str] = "_col_Rij"
#: the forward's column-layout refs (``ops.colblock.ColRefs``), built once
#: so that its modules share the index schedules cached on them
col_refs: Final[str] = "_col_refs"
#: the 27-cell refs (``ops.cellblock_gather.CellRefs``), made once per
#: neighbor-list build so that every step shares the index schedules
#: cached on them
cell_refs: Final[str] = "_cell_refs"

# --- TPU padded-batch layout ------------------------------------------------
#: 1.0 for real atoms, 0.0 for padding [n_atoms]
atom_mask: Final[str] = "_atom_mask"
#: 1.0 for real pairs, 0.0 for padding [n_pairs]
pair_mask: Final[str] = "_pair_mask"
#: 1.0 for real molecules, 0.0 for padding [n_molecules]
mol_mask: Final[str] = "_mol_mask"
#: 1.0 for real long-range pairs [n_pairs_lr]
pair_mask_lr: Final[str] = "_pair_mask_lr"
#: 1.0 for real triples
triple_mask: Final[str] = "_triple_mask"

# ---------------------------------------------------------------------------
# chemical properties
# ---------------------------------------------------------------------------
energy: Final[str] = "energy"
forces: Final[str] = "forces"
stress: Final[str] = "stress"
strain: Final[str] = "strain"
masses: Final[str] = "masses"
dipole_moment: Final[str] = "dipole_moment"
dipole_derivatives: Final[str] = "dipole_derivatives"
partial_charges: Final[str] = "partial_charges"
polarizability: Final[str] = "polarizability"
polarizability_derivatives: Final[str] = "polarizability_derivatives"
total_charge: Final[str] = "total_charge"
spin_multiplicity: Final[str] = "spin_multiplicity"
electric_field: Final[str] = "electric_field"
magnetic_field: Final[str] = "magnetic_field"
nuclear_magnetic_moments: Final[str] = "nuclear_magnetic_moments"
shielding: Final[str] = "shielding"
nuclear_spin_coupling: Final[str] = "nuclear_spin_coupling"
hessian: Final[str] = "hessian"

#: external fields required for a given response property
required_external_fields: Dict[str, List[str]] = {
    dipole_moment: [electric_field],
    dipole_derivatives: [electric_field],
    partial_charges: [electric_field],
    polarizability: [electric_field],
    polarizability_derivatives: [electric_field],
    shielding: [magnetic_field],
    nuclear_spin_coupling: [magnetic_field],
}

external_fields: List[str] = [electric_field, magnetic_field]

#: properties that are always per-MOLECULE even when their leading dim
#: happens to equal an atom count (e.g. a (3,) dipole target in a batch of
#: 3-atom molecules) — used by the collate to disambiguate routing
per_molecule_keys: List[str] = [
    energy,
    stress,
    dipole_moment,
    polarizability,
    total_charge,
    spin_multiplicity,
    electric_field,
    magnetic_field,
]

# ---------------------------------------------------------------------------
# internal helper keys
# ---------------------------------------------------------------------------
scalar_representation: Final[str] = "scalar_representation"
vector_representation: Final[str] = "vector_representation"
multipole_representation: Final[str] = "multipole_representation"

#: set of structure keys (everything a raw sample must carry)
structure_keys = frozenset(
    {Z, R, cell, pbc, idx_m, idx_i, idx_j, offsets, n_atoms}
)
