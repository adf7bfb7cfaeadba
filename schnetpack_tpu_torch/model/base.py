"""Model composition and the response engine (parity:
``schnetpack_tpu/model/base.py``).

``NeuralNetworkPotential`` runs input modules -> representation -> output
heads over the flat batch dict and computes the responses its specs
(``Forces``, ``Response``) ask for, all from one energy closure of the
positions R, a per-molecule strain eps, and the electric field F, the
magnetic field B and the nuclear magnetic moments I
(``model/base.py:151-190``), with ``torch.autograd`` (the kernels'
``autograd.Function``s have no functorch rules, so not ``torch.func``):

* first derivatives come from one ``torch.autograd.grad`` over the leaves
  that are needed: forces -dE/dR, stress (dE/deps / |det cell|,
  symmetrised; ``Strain`` is inserted as the first input module) and the
  dipole -dE/dF (``StaticExternalFields`` is inserted where a ``Response``
  needs fields and no such module is there);
* second derivatives keep the first gradient's graph, even with frozen
  parameters, and take batched vector products of it
  (``is_grads_batched``).  Molecules never couple, so one tangent applied
  to every molecule at once gives each molecule its own response: the
  Hessian and the spin coupling in the per-molecule block form [M, Amax,
  3, Amax, 3] from 3 Amax products (``_blocked``, the slot layout of the
  JAX ``_block_layout``), the polarizability -d2E/dF2 [M, 3, 3] from 3,
  the dipole derivatives dmu/dR [M, 3, A, 3] and the partial charges
  tr(dmu/dR_a) / 3 from the same 3 products of dE/dF with respect to R,
  the polarizability derivatives [M, 3, 3, A, 3] from 9 more, and the
  shielding d2E/dB dI [A, 3, 3] from 3 products of dE/dB with respect to
  I.

How the graph is kept depends on the caller:

* training (grad mode on and a parameter that requires grad): every
  response keeps its graph (``create_graph=True``) and the outputs stay
  attached, so that a loss on them reaches the weights, as
  ``jax.value_and_grad`` around the JAX model's ``apply`` does;
* MD and inference: the outputs are detached.

The column and 27-cell layouts' kernels have no second derivative: there
a second-order response, or training, raises ``SecondOrderLayoutError``
(the JAX training step never takes them).  Stress on the column layout
raises ``ColumnStressError``: the JAX ``Strain`` does not strain that
layout's periodic offsets (``cell_coff``, ``cell_coff_fm``), so its
column stress lacks the periodic-image term, and the port does not mirror
that number.  The 27-cell layout strains ``nbh_offsets`` and computes it.

``postprocessors`` (e.g. ``transform.AddOffsets``) run on the outputs
unless ``do_postprocessing`` is off, per call or for the model.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from .. import properties
from ..atomistic.response import (
    SECOND_ORDER, Forces, Response, StaticExternalFields, Strain,
    is_response_module, required_derivatives,
)


class SecondOrderLayoutError(ValueError):
    """A second derivative (a second-order response, or a loss on a
    response for training) was asked for on the column or 27-cell layout,
    whose kernels have none."""


class ColumnStressError(ValueError):
    """Stress was asked for on the column layout, whose periodic offsets
    the strain does not reach (see the module's docstring)."""


def _vjps(y: torch.Tensor, x: torch.Tensor, tangents: torch.Tensor,
          create_graph: bool) -> torch.Tensor:
    """[T, *x.shape]: the vector-Jacobian products of ``y`` with each of
    ``tangents`` [T, *y.shape], batched; zeros where y does not depend
    on x."""
    if not y.requires_grad:
        return x.new_zeros((tangents.shape[0],) + x.shape)
    (g,) = torch.autograd.grad(y, x, tangents, retain_graph=True,
                               create_graph=create_graph,
                               is_grads_batched=True, allow_unused=True)
    if g is None:
        return x.new_zeros((tangents.shape[0],) + x.shape)
    return g


class NeuralNetworkPotential(nn.Module):
    def __init__(self, representation: nn.Module, output_modules: Sequence,
                 input_modules: Sequence[nn.Module] = (),
                 postprocessors: Sequence[Callable] = (),
                 do_postprocessing: bool = True):
        super().__init__()
        self.response_specs: List = [m for m in output_modules
                                     if is_response_module(m)]
        heads = [m for m in output_modules if not is_response_module(m)]
        self.need = required_derivatives(self.response_specs)
        self.props = set()
        for spec in self.response_specs:
            self.props.update(spec.response_properties)
        ins = list(input_modules)
        if self.need["strain"] and not any(isinstance(m, Strain)
                                           for m in ins):
            ins.insert(0, Strain())
        fields: List[str] = []
        for spec in self.response_specs:
            if isinstance(spec, Response):
                fields += [f for f in spec.required_fields
                           if f not in fields]
        if fields and not any(isinstance(m, StaticExternalFields)
                              for m in ins):
            ins.insert(0, StaticExternalFields(fields))
        self.required_fields = fields
        self.input_modules = nn.ModuleList(ins)
        self.representation = representation
        self.output_modules = nn.ModuleList(heads)
        self.postprocessors = list(postprocessors)
        self.do_postprocessing = do_postprocessing
        #: the outputs the model advertises (``model/base.py:86-101``)
        self.model_outputs: List[str] = []
        for m in heads:
            for attr in ("output_key", "dipole_key", "polar_key",
                         "charges_key", "per_atom_output_key"):
                key = getattr(m, attr, None)
                if key and key not in self.model_outputs:
                    self.model_outputs.append(key)
        for spec in self.response_specs:
            if isinstance(spec, Forces):
                self.model_outputs += [
                    k for k, on in ((spec.force_key, spec.calc_forces),
                                    (spec.stress_key, spec.calc_stress))
                    if on]
            else:
                self.model_outputs += [p for p in spec.response_properties
                                       if p not in self.model_outputs]

    def second_order(self) -> bool:
        """Whether a call now keeps the responses' graph (training)."""
        return torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())

    def _check_layout(self, inputs, train: bool) -> None:
        blocked = (properties.cell_qcol in inputs
                   or properties.cell_qidx in inputs)
        second = sorted(self.props & SECOND_ORDER)
        if blocked and (second or (train and self.response_specs)):
            raise SecondOrderLayoutError(
                f"{', '.join(second) or 'responses with a graph for training'}"
                ": not available on the column or 27-cell layout (its "
                "kernels have no second derivative); use the flat or dense "
                "layout, or call the model under torch.no_grad() or with "
                "frozen parameters for first derivatives")
        if properties.stress in self.props and properties.cell_qcol in inputs:
            raise ColumnStressError(
                "stress on the column layout: the strain does not reach "
                "its periodic offsets (cell_coff, cell_coff_fm), so the "
                "JAX package's column stress lacks the periodic-image "
                "term; use the flat, dense or 27-cell layout")

    def forward(self, inputs: Dict[str, torch.Tensor],
                do_postprocessing: Optional[bool] = None):
        inputs = dict(inputs)
        train = bool(self.response_specs) and self.second_order()
        self._check_layout(inputs, train)
        if not self.response_specs:
            out = self._run(inputs)
        else:
            with torch.enable_grad():
                out = self._respond(inputs, train)
        post = (self.do_postprocessing if do_postprocessing is None
                else do_postprocessing)
        if post:
            for pp in self.postprocessors:
                out = pp(out)
        return out

    def _run(self, inputs):
        for m in self.input_modules:
            inputs = m(inputs)
        out = self.representation(inputs)
        for m in self.output_modules:
            out = m(out)
        return out

    def _respond(self, inputs, train: bool):
        props, need = self.props, self.need
        second = bool(props & SECOND_ORDER)
        R0 = inputs[properties.R]
        A, dtype = R0.shape[0], R0.dtype
        M = inputs[properties.n_atoms].shape[0]
        mol_mask = inputs.get(properties.mol_mask)
        if mol_mask is None:
            mol_mask = R0.new_ones(M)
        atom_mask = inputs.get(properties.atom_mask)
        if atom_mask is None:
            atom_mask = R0.new_ones(A)
        leaves = {}

        def leaf(key, value, on):
            value = value.detach().to(dtype)
            if on:
                value.requires_grad_(True)
                leaves[key] = value
            inputs[key] = value
            return value

        R = leaf(properties.R, R0, need["positions"] or second)
        if need["strain"]:
            leaf(properties.strain, R0.new_zeros((M, 3, 3)), True)
        zeros_m3 = R0.new_zeros((M, 3))
        if properties.electric_field in self.required_fields:
            leaf(properties.electric_field,
                 inputs.get(properties.electric_field, zeros_m3),
                 need["electric_field"])
        if properties.magnetic_field in self.required_fields:
            leaf(properties.magnetic_field,
                 inputs.get(properties.magnetic_field, zeros_m3),
                 need["magnetic_field"])
            leaf(properties.nuclear_magnetic_moments,
                 inputs.get(properties.nuclear_magnetic_moments,
                            R0.new_zeros((A, 3))),
                 need["nuclear_magnetic_moments"])
        cell = inputs.get(properties.cell)

        energy_key = self.response_specs[0].energy_key
        out = self._run(inputs)
        E = ((out[energy_key] * mol_mask).sum() if energy_key in out
             else R.sum() * 0.0)
        keys = list(leaves)
        grads = (torch.autograd.grad(E, [leaves[k] for k in keys],
                                     create_graph=train or second,
                                     allow_unused=True)
                 if E.requires_grad else [None] * len(keys))
        g = {k: (torch.zeros_like(leaves[k]) if v is None else v)
             for k, v in zip(keys, grads)}

        for spec in self.response_specs:
            fkey = (spec.force_key if isinstance(spec, Forces)
                    else properties.forces)
            skey = (spec.stress_key if isinstance(spec, Forces)
                    else properties.stress)
            if properties.forces in spec.response_properties:
                out[fkey] = -g[properties.R] * atom_mask[:, None]
            if properties.stress in spec.response_properties:
                volume = torch.linalg.det(cell).abs().clamp(min=1e-9)
                sigma = g[properties.strain] / volume[:, None, None]
                out[skey] = 0.5 * (sigma + sigma.transpose(1, 2))
            if (properties.dipole_moment in spec.response_properties
                    and properties.electric_field in g):
                out[properties.dipole_moment] = (
                    -g[properties.electric_field] * mol_mask[:, None])
        if second:
            self._second_order(inputs, out, leaves, g, train, mol_mask,
                               atom_mask)
        if not train:
            out = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in out.items()}
        return out

    def _second_order(self, inputs, out, leaves, g, train, mol_mask,
                      atom_mask) -> None:
        props = self.props
        R = leaves.get(properties.R)
        M = mol_mask.shape[0]
        idx_m = inputs[properties.idx_m].long()
        eye3 = torch.eye(3, dtype=R.dtype, device=R.device)
        per_mol = eye3[:, None, :].expand(3, M, 3)    # e_i on every molecule
        # [M, A]: atom a belongs to molecule m (cross-molecule terms are 0)
        onehot = (idx_m[None, :] == torch.arange(
            M, device=R.device)[:, None]).to(R.dtype)
        EF, MF = properties.electric_field, properties.magnetic_field
        I_key = properties.nuclear_magnetic_moments
        fields = EF in self.required_fields

        if properties.hessian in props:
            out[properties.hessian] = self._blocked(
                g[properties.R], R, inputs, mol_mask, train)
        alpha_graph = train or properties.polarizability_derivatives in props
        if properties.polarizability in props and fields:
            # [i, M, j] -> alpha[m, j, i] = -d2E / dF_j dF_i
            cols = -_vjps(g[EF], leaves[EF], per_mol, alpha_graph)
            out[properties.polarizability] = cols.permute(1, 2, 0)
        if fields and (properties.dipole_derivatives in props
                       or properties.partial_charges in props):
            # [i, A, 3]: d mu_i / dR_a for the molecule of atom a
            dmu = -_vjps(g[EF], R, per_mol, train)
            if properties.dipole_derivatives in props:
                out[properties.dipole_derivatives] = (
                    dmu[None] * onehot[:, None, :, None])
            if properties.partial_charges in props:
                out[properties.partial_charges] = (
                    torch.diagonal(dmu, dim1=0, dim2=2).sum(-1) / 3.0
                    * atom_mask)
        if properties.polarizability_derivatives in props and fields:
            alpha = out.get(properties.polarizability)
            if alpha is None:
                alpha = -_vjps(g[EF], leaves[EF], per_mol,
                               alpha_graph).permute(1, 2, 0)
            tang = torch.eye(9, dtype=R.dtype, device=R.device).reshape(
                9, 1, 3, 3).expand(9, M, 3, 3)
            d = _vjps(alpha, R, tang, train).reshape(3, 3, -1, 3)
            out[properties.polarizability_derivatives] = (
                d[None] * onehot[:, None, None, :, None])
        if properties.shielding in props and MF in self.required_fields:
            cols = _vjps(g[MF], leaves[I_key], per_mol, train)  # [j, A, 3]
            out[properties.shielding] = (cols.permute(1, 2, 0)
                                         * atom_mask[:, None, None])
        if (properties.nuclear_spin_coupling in props
                and MF in self.required_fields):
            out[properties.nuclear_spin_coupling] = self._blocked(
                g[I_key], leaves[I_key], inputs, mol_mask, train)

    @staticmethod
    def _blocked(grad: torch.Tensor, x: torch.Tensor, inputs, mol_mask,
                 train: bool) -> torch.Tensor:
        """[M, Amax, 3, Amax, 3] per-molecule blocks of d(grad)/dx, grad
        and x [A, 3], from 3 Amax batched products: the tangent of slot s
        and direction d moves the s-th atom of every molecule at once
        (``model/base.py:236-270``)."""
        A = x.shape[0]
        idx_m = inputs[properties.idx_m].long()
        n_at = inputs[properties.n_atoms].long()
        seg = torch.cumsum(n_at, 0) - n_at
        amax = int((n_at.to(mol_mask.dtype) * mol_mask).max())
        amax = max(min(amax, A), 1)
        slots = torch.arange(amax, device=x.device)
        mol_atoms = (seg[:, None] + slots[None, :]).clamp(0, A - 1)
        slot_valid = ((slots[None, :] < n_at[:, None])
                      & (mol_mask[:, None] > 0)).to(x.dtype)
        atom_slot = torch.arange(A, device=x.device) - seg[idx_m]
        eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
        tang = ((atom_slot[None, None, :, None] == slots[:, None, None, None])
                .to(x.dtype) * eye3[None, :, None, :])   # [s, d, A, e]
        rows = _vjps(grad, x, tang.reshape(3 * amax, A, 3), train)
        blocks = rows.reshape(amax, 3, A, 3)[:, :, mol_atoms, :]
        blocks = blocks.permute(2, 3, 4, 0, 1)         # [M, p, e, s, d]
        return (blocks * slot_valid[:, :, None, None, None]
                * slot_valid[:, None, None, :, None])


#: the reference's generic name
AtomisticModel = NeuralNetworkPotential
