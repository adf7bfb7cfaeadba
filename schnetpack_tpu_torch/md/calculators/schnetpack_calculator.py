"""Machine-learning potential calculator for MD (parity:
``schnetpack_tpu/md/calculators/schnetpack_calculator.py``).

``neighbor_list`` takes the reference's names or a neighbor-list object:

* ``"all_pairs"`` (the default): the flat layout, the all-pairs list of
  ``PairwiseMDCalculator`` (every ordered same-molecule pair, masked at
  ``cutoff + cutoff_shell`` on the device at every call);
* ``"dense"``: a ``DenseNeighborListMD`` of ``cutoff`` and the skin
  ``max(cutoff_shell, 0.5)`` (``schnetpack_calculator.py:76-84``), whose
  state passes ``nbh_idx``, ``nbh_mask``, ``nbh_offsets`` and ``nbh_rev``
  with a one-pair flat list that carries no pair (``idx_i``/``idx_j`` 0,
  offset 1e3, ``pair_mask`` 0, ``:168-208``), which tells FieldSchNet to
  take its dense branch;
* ``"cellblock"`` (the column layout) and ``"cellblock_atom"`` (the
  27-cell atom layout), a ``CellBlockNeighborListMD`` of the skin
  ``max(cutoff_shell, 0.3)``.

On the flat and dense layouts the replicas (ring-polymer beads) and their
molecules go through the model in one call over R * A atoms, the
replica-shifted batch of ``PairwiseMDCalculator._get_system_molecules``
(``:273-292``); positions and offsets are in model units.

On the blocked layouts the model runs in the neighbor list's sorted
space: positions are taken in ``cell_order`` (converted to model units),
and forces come back to the original atom order through ``cell_rank``.  A
rebuild on the device re-bins the atoms, so after one the whole
sorted-space state (order, rank, Z, idx_m, atom mask, qcol/dcol, offsets)
is the neighbor list's new state, exactly as after a host build.  The
27-cell layout's state passes ``cell_qidx``, ``nbh_idx``, ``nbh_mask`` and
``nbh_offsets`` (``schnetpack_calculator.py:192-199``) and the neighbor
state's ``CellRefs``, so that its cached schedules outlive the step.
Ring-polymer beads (``n_replicas > 1``, column layout) share one layout
(``:210-276``): each bead's positions, in ``cell_order``, go through the
model with the same tables, one bead after another, and its forces come
back through ``cell_rank``; energy is written per bead.  The JAX package
vmaps the model, and the Pallas batching rule adds the bead axis to each
kernel's grid; here the kernels run once per bead, with one ``ColRefs``
(and its cached schedules) shared by all beads of a step, and each bead's
autograd graph is freed before the next bead runs, so peak memory stays
that of one replica.

With the default ``wgrad=False`` the potential's parameters are frozen:
MD differentiates with respect to positions only, and the kernels' plain
backward instances run.  ``wgrad=True`` leaves ``requires_grad`` as it is
(``schnetpack_calculator.py:43, 68-75``), so a parameter that requires
grad gets its cotangent from the kernels' wgrad instances.

The constructor takes the JAX calculator's keys (``schnetpack_calculator.
py:28-44``) and refuses at once what the port cannot run:
``precision="bf16"`` or ``"mixed"`` (the reduced-precision feature mode,
ROADMAP Queue 1 item 8; ``None`` and ``"f32"`` run as f32).  A
``stress_key`` writes the model's stress (a potential built with
``Forces(calc_stress=True)``) into ``System.stress`` in MD units, so that
a barostat reads it; the calculator then has a variable cell, which the
simulator's NPT integrators need (``fixed_cell`` is False).  The column
layout refuses stress (``model.base.ColumnStressError``), and the JAX
dense and 27-cell MD lists keep the offsets of their build, so NPT runs
on ``all_pairs``, whose offsets follow the current cell every step.

``EnsembleCalculator`` (``schnetpack_calculator.py:294-333``) runs one
model per member over one set of inputs a step (on the column layout one
``ColRefs`` and its cached schedules for every member and bead), each
member's graph freed before the next, and writes the members' mean into
the system and their population standard deviation (ddof 0, as
``jnp.std``) into ``system.properties`` as ``forces_uncertainty`` and
``energy_uncertainty``, in MD units.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from ... import properties as structure
from ...atomistic.distances import column_refs
from ..neighborlist_md import CellBlockNeighborListMD, DenseNeighborListMD
from ..system import System
from .base import PairwiseMDCalculator


#: the reference's ``neighbor_list`` names
NEIGHBOR_LISTS = ("all_pairs", "dense", "cellblock", "cellblock_atom")


def check_options(neighbor_list, precision) -> None:
    """Raise for the calculator options the port does not run."""
    if isinstance(neighbor_list, str) and neighbor_list not in NEIGHBOR_LISTS:
        raise ValueError(
            "the port's calculator takes neighbor_list='all_pairs', "
            "'dense', 'cellblock', 'cellblock_atom' or a neighbor-list "
            f"object, not {neighbor_list!r}")
    if precision in ("bf16", "mixed"):
        raise NotImplementedError(
            f"precision={precision!r}: the reduced-precision feature mode "
            "is not ported (ROADMAP Queue 1 item 8); use None or 'f32'")
    if precision not in (None, "f32"):
        raise ValueError(f"precision must be None, 'f32', 'bf16' or "
                         f"'mixed', not {precision!r}")


class SchNetPackCalculator(PairwiseMDCalculator):
    def __init__(
        self,
        model,                      # NeuralNetworkPotential
        params: Optional[Dict[str, torch.Tensor]] = None,
        cutoff: float = 5.0,        # model units
        force_key: str = structure.forces,
        energy_unit: str = "eV",
        position_unit: str = "Ang",
        energy_key: str = structure.energy,
        stress_key: Optional[str] = None,
        cutoff_shell: float = 0.0,
        required_properties: Sequence[str] = (),
        neighbor_list: Union[CellBlockNeighborListMD, DenseNeighborListMD,
                             str] = "all_pairs",
        precision: Optional[str] = None,
        wgrad: bool = False,
    ):
        super().__init__(cutoff=float(cutoff), cutoff_shell=cutoff_shell,
                         required_properties=required_properties,
                         force_key=force_key, energy_unit=energy_unit,
                         position_unit=position_unit, energy_key=energy_key,
                         stress_key=stress_key)
        check_options(neighbor_list, precision)
        #: without a stress the cell stays fixed: no NPT integrator
        self.fixed_cell = stress_key is None
        if stress_key is not None and neighbor_list == "cellblock":
            raise ValueError(
                f"stress_key={stress_key!r} on the column layout "
                "(neighbor_list='cellblock'): its periodic offsets are not "
                "strained (model.base.ColumnStressError); use all_pairs, "
                "dense or cellblock_atom")
        outputs = getattr(model, "model_outputs", None)
        if stress_key is not None and outputs is not None \
                and stress_key not in outputs:
            raise ValueError(
                f"stress_key={stress_key!r}: the model returns no such "
                f"output ({outputs}); build it with Forces(calc_stress=True)")
        self.model = model
        if params is not None:
            self.model.load_state_dict(params)
        if not wgrad:
            self.model.requires_grad_(False)
        conv = self.position_conversion
        if neighbor_list == "dense":
            neighbor_list = DenseNeighborListMD(
                cutoff * conv, skin=max(cutoff_shell, 0.5) * conv)
        elif neighbor_list in ("cellblock", "cellblock_atom"):
            neighbor_list = CellBlockNeighborListMD(
                cutoff * conv, skin=max(cutoff_shell, 0.3) * conv,
                layout="column" if neighbor_list == "cellblock" else "atom")
        #: the skin neighbor list, None on the all-pairs list
        self.nbl = None if neighbor_list == "all_pairs" else neighbor_list

    def init_state(self, system: System):
        self.model.to(system.positions.device)
        if self.nbl is None:
            return None
        self.nbl.build(system)
        return self.nbl.state()

    def update_state(self, system: System, calc_state):
        """Per-step skin check; the new state after a rebuild."""
        if self.nbl is not None and self.nbl.maybe_rebuild(system):
            return self.nbl.state()
        return calc_state

    def model_inputs(self, system: System, calc_state) -> Dict[str, torch.Tensor]:
        """The model's inputs: on the flat and dense layouts every replica's
        (``_flat_inputs``), on the blocked layouts replica 0's positions in
        sorted space."""
        if calc_state is None or "cell_order" not in calc_state:
            return self._flat_inputs(system, calc_state)
        inv = 1.0 / self.position_conversion
        order = calc_state["cell_order"]
        M = system.n_molecules
        inputs = {
            structure.R: system.positions[0, order] * inv,
            structure.Z: calc_state["cell_Z"],
            structure.idx_m: calc_state["cell_idx_m"],
            structure.atom_mask: calc_state["cell_atom_mask"],
            structure.n_atoms: system.n_atoms_per_mol,
            structure.mol_mask: system.positions.new_ones(M),
            structure.cell: system.cells[0] * inv,
        }
        if structure.cell_qidx in calc_state:
            inputs.update({
                structure.cell_qidx: calc_state[structure.cell_qidx],
                structure.cell_refs: calc_state[structure.cell_refs],
                structure.nbh_idx: calc_state[structure.nbh_idx],
                structure.nbh_mask: calc_state[structure.nbh_mask],
                structure.nbh_offsets: calc_state[structure.nbh_offsets] * inv,
            })
        else:
            inputs.update({
                structure.cell_qcol: calc_state[structure.cell_qcol],
                structure.cell_dcol: calc_state[structure.cell_dcol],
                structure.cell_coff_fm:
                    calc_state[structure.cell_coff_fm] * inv,
                structure.cell_ksz: calc_state[structure.cell_ksz],
            })
        return inputs

    def _flat_inputs(self, system: System, calc_state):
        """The R * A-atom batch of every replica with the all-pairs list, or
        with the dense state (``calc_state``) and a one-pair flat list that
        carries no pair (``schnetpack_calculator.py:168-208``)."""
        inputs = self._get_system_molecules(system)
        if calc_state is None:
            inputs.update(self._pair_inputs(system))
            return inputs
        R = inputs[structure.R]
        inputs.update({
            structure.nbh_idx: calc_state[structure.nbh_idx],
            structure.nbh_mask: calc_state[structure.nbh_mask],
            structure.nbh_rev: calc_state[structure.nbh_rev],
            structure.nbh_offsets: (calc_state[structure.nbh_offsets]
                                    / self.position_conversion),
            structure.idx_i: torch.zeros(1, dtype=torch.int32,
                                         device=R.device),
            structure.idx_j: torch.zeros(1, dtype=torch.int32,
                                         device=R.device),
            structure.offsets: R.new_full((1, 3), 1e3),
            structure.pair_mask: R.new_zeros(1),
        })
        return inputs

    def _evaluate(self, model, base, system: System, calc_state):
        """{energy [R, M], forces [R, A, 3] in the original atom order,
        stress [R, M, 3, 3]} (the keys the model returns) of ``model`` on
        every replica, in model units: one call over all replicas on the
        flat and dense layouts, one per replica on the blocked layouts."""
        R_, A, M = system.n_replicas, system.total_atoms, system.n_molecules
        shapes = {self.energy_key: (R_, M), self.force_key: (R_, A, 3),
                  self.stress_key: (R_, M, 3, 3)}
        if calc_state is None or "cell_order" not in calc_state:
            out = model(dict(base))
            return {k: out[k].detach().reshape(shape)
                    for k, shape in shapes.items() if k in out}
        order, rank = calc_state["cell_order"], calc_state["cell_rank"]
        inv = 1.0 / self.position_conversion
        runs = []
        for r in range(system.n_replicas):
            inputs = dict(base)
            if r:
                inputs[structure.R] = system.positions[r, order] * inv
            out = model(inputs)
            if self.force_key in out:
                out[self.force_key] = out[self.force_key][rank]
            runs.append({k: out[k].detach() for k in shapes if k in out})
        return {k: torch.stack([run[k] for run in runs])
                for k in runs[0]}

    def shared_inputs(self, system: System, calc_state, n_evals: int):
        """The model's inputs, with the column refs made once when more
        than one evaluation reads them."""
        base = self.model_inputs(system, calc_state)
        if n_evals > 1 and structure.cell_qcol in base:
            column_refs(base)
        return base

    def calculate(self, system: System, calc_state) -> System:
        """Energy, forces and (with ``stress_key``) stress of every
        replica, one model evaluation each (see the module's docstring for
        beads)."""
        return self._update_system(system, self._evaluate(
            self.model,
            self.shared_inputs(system, calc_state, system.n_replicas),
            system, calc_state))


class EnsembleCalculator(SchNetPackCalculator):
    """The members' mean and population std (see the module's docstring).
    ``models``: one loaded ``NeuralNetworkPotential`` per member (the JAX
    package's stacked parameters exist for its vmap, which the port does
    not run)."""

    def __init__(self, models: Sequence, cutoff: float = 5.0,
                 wgrad: bool = False, **kwargs):
        super().__init__(models[0], None, cutoff, wgrad=wgrad, **kwargs)
        #: the ``system.properties`` streams it writes, to log
        self.property_keys = tuple(
            f"{k}_uncertainty" for k in (self.energy_key, self.force_key,
                                         self.stress_key) if k is not None)
        self.models = list(models)
        if not wgrad:
            for m in self.models:
                m.requires_grad_(False)

    def init_state(self, system: System):
        for m in self.models:
            m.to(system.positions.device)
        return super().init_state(system)

    def calculate(self, system: System, calc_state) -> System:
        base = self.shared_inputs(system, calc_state,
                                  system.n_replicas * len(self.models))
        runs = [self._evaluate(m, base, system, calc_state)
                for m in self.models]
        outputs, unc = {}, {}
        for key, conv in ((self.energy_key, self.energy_conversion),
                          (self.force_key, self.force_conversion),
                          (self.stress_key, self.stress_conversion)):
            if key is None or key not in runs[0]:
                continue
            members = torch.stack([run[key] for run in runs])
            outputs[key] = members.mean(0)
            unc[f"{key}_uncertainty"] = members.std(0, correction=0) * conv
        system = self._update_system(system, outputs)
        return system.replace(properties={**system.properties, **unc})
