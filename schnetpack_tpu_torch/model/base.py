"""Model composition (parity: ``schnetpack_tpu/model/base.py``).

``NeuralNetworkPotential`` runs input modules -> representation -> output
heads over the flat batch dict (the input modules after the positions
require grad, so that e.g. ``PairwiseDistances`` is differentiated) and,
when a ``Forces`` spec is among the outputs, returns forces = -dE/dR from
one ``torch.autograd.grad`` call.  How that call runs depends on what the
caller needs:

* training (grad mode on and a parameter that requires grad): the forces
  keep their graph (``create_graph=True``) and the energy stays attached,
  so that a loss on the forces reaches the weights, as
  ``jax.value_and_grad`` around the JAX model's ``apply`` does.  The
  column and 27-cell layouts refuse this mode (``SecondOrderLayoutError``):
  their hand-written kernels have no second derivative, and the JAX
  training step never takes them;
* MD and inference (nothing requires grad, or grad mode off): no graph
  is kept and the energy is detached.

``postprocessors`` (e.g. ``transform.AddOffsets``) run on the outputs
unless ``do_postprocessing`` is off, per call or for the model.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from .. import properties
from ..atomistic.response import Forces


class SecondOrderLayoutError(ValueError):
    """A force loss asked for second derivatives on the column or 27-cell
    layout, whose kernels have none."""


class NeuralNetworkPotential(nn.Module):
    def __init__(self, representation: nn.Module, output_modules: Sequence,
                 input_modules: Sequence[nn.Module] = (),
                 postprocessors: Sequence[Callable] = (),
                 do_postprocessing: bool = True):
        super().__init__()
        self.input_modules = nn.ModuleList(input_modules)
        self.representation = representation
        self.response_specs = [m for m in output_modules
                               if isinstance(m, Forces)]
        self.output_modules = nn.ModuleList(
            m for m in output_modules if not isinstance(m, Forces))
        self.postprocessors = list(postprocessors)
        self.do_postprocessing = do_postprocessing
        #: the outputs the model advertises (``model/base.py:86-101``)
        self.model_outputs: List[str] = [
            m.output_key for m in self.output_modules
            if getattr(m, "output_key", None)]
        self.model_outputs += [s.force_key for s in self.response_specs]

    def second_order(self) -> bool:
        """Whether a call now keeps the forces' graph (training)."""
        return torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())

    def forward(self, inputs: Dict[str, torch.Tensor],
                do_postprocessing: Optional[bool] = None):
        inputs = dict(inputs)
        R = inputs[properties.R]
        create_graph = bool(self.response_specs) and self.second_order()
        if create_graph and (properties.cell_qcol in inputs
                             or properties.cell_qidx in inputs):
            raise SecondOrderLayoutError(
                "forces with a graph for training are not available on the "
                "column or 27-cell layout (its kernels have no second "
                "derivative): train on the flat or dense layout, or call "
                "the model under torch.no_grad() or with frozen parameters")
        with (torch.enable_grad() if self.response_specs
              else contextlib.nullcontext()):
            if self.response_specs:
                R = R.detach().requires_grad_(True)
                inputs[properties.R] = R
            for m in self.input_modules:
                inputs = m(inputs)
            out = self.representation(inputs)
            for m in self.output_modules:
                out = m(out)
            for spec in self.response_specs:
                M = out[spec.energy_key].shape[0]
                mol_mask = inputs.get(properties.mol_mask,
                                      R.new_ones(M))
                E = (out[spec.energy_key] * mol_mask).sum()
                (dE,) = torch.autograd.grad(E, R, create_graph=create_graph)
                if not create_graph:
                    out[spec.energy_key] = out[spec.energy_key].detach()
                out[spec.force_key] = (
                    -dE * inputs[properties.atom_mask][:, None])
        post = (self.do_postprocessing if do_postprocessing is None
                else do_postprocessing)
        if post:
            for pp in self.postprocessors:
                out = pp(out)
        return out
