"""Run directories of the JAX training CLI on the port (parity:
``schnetpack_tpu/cli.py:176-186 load_model``).

The JAX ``spktrain`` writes ``model_config.pkl``, the resolved ``model``
config (a plain dict whose ``_target_``s name ``schnetpack_tpu`` classes,
``cli.py:145-147``), and ``best_model``, a pickle of the flax parameter
tree as numpy arrays (``train/callbacks.py:18-27``).  ``load_model`` maps
each target to the port's class through ``TARGETS``, an explicit table
(an unknown target raises with its name), and loads the weights through
``convert.params_from_jax``.  An ``Atomwise`` without ``n_in`` takes the
representation's width, which flax infers.  A ``PairwiseDistances``
skips the column layout where the representation there reads the
positions only (``reads_column_rij``), so a model from the JAX configs,
which list it for every representation, launches no gather it does not
need.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Dict, Tuple

from .atomistic import Atomwise, Forces, PairwiseDistances
from .convert import load_jax_params, params_from_jax
from .model import NeuralNetworkPotential
from .nn import (
    BesselRBF, CosineCutoff, GaussianRBF, GaussianRBFCentered,
    MollifierCutoff,
)
from .representation import FieldSchNet, PaiNN, SchNet, SO3net


def _potential(ctx, representation, input_modules=(), output_modules=(),
               postprocessors=(), do_postprocessing=True):
    if postprocessors:
        raise NotImplementedError(
            "load_model: the port's NeuralNetworkPotential has no "
            "postprocessors")
    rep = _build(representation, ctx)
    ctx = dict(ctx, n_in=getattr(rep, "n_atom_basis", None),
               columns=getattr(rep, "reads_column_rij", True))
    outputs = [m for m in (_build(c, ctx) for c in output_modules)
               if m is not None]
    return NeuralNetworkPotential(
        rep, outputs, input_modules=[_build(c, ctx) for c in input_modules])


def _atomwise(ctx, n_out=1, aggregation_mode="sum",
              per_atom_output_key=None, **kwargs):
    if n_out != 1 or aggregation_mode != "sum" or per_atom_output_key:
        raise NotImplementedError(
            "load_model: the port's Atomwise sums one output per molecule "
            f"(n_out={n_out}, aggregation_mode={aggregation_mode!r}, "
            f"per_atom_output_key={per_atom_output_key!r})")
    kwargs.setdefault("n_in", ctx.get("n_in"))
    return Atomwise(**kwargs)


def _forces(ctx, calc_forces=True, calc_stress=False, stress_key=None,
            **kwargs):
    if calc_stress:
        raise NotImplementedError(
            "load_model: Forces(calc_stress=True): the port's models have "
            "no stress (ROADMAP Queue 1 item 7)")
    return Forces(**kwargs) if calc_forces else None


def _distances(ctx, **kwargs):
    return PairwiseDistances(columns=ctx.get("columns", True), **kwargs)


def _plain(cls) -> Callable:
    return lambda ctx, **kwargs: cls(**kwargs)


def _targets() -> Dict[str, Callable]:
    table = {
        "model.NeuralNetworkPotential": _potential,
        "model.base.NeuralNetworkPotential": _potential,
        "atomistic.Atomwise": _atomwise,
        "atomistic.atomwise.Atomwise": _atomwise,
        "atomistic.Forces": _forces,
        "atomistic.response.Forces": _forces,
        "atomistic.PairwiseDistances": _distances,
        "atomistic.distances.PairwiseDistances": _distances,
    }
    for name, module, cls in [
            ("PaiNN", "representation.painn", PaiNN),
            ("SchNet", "representation.schnet", SchNet),
            ("SO3net", "representation.so3net", SO3net),
            ("FieldSchNet", "representation.field_schnet", FieldSchNet),
            ("GaussianRBF", "nn.radial", GaussianRBF),
            ("GaussianRBFCentered", "nn.radial", GaussianRBFCentered),
            ("BesselRBF", "nn.radial", BesselRBF),
            ("CosineCutoff", "nn.cutoff", CosineCutoff),
            ("MollifierCutoff", "nn.cutoff", MollifierCutoff)]:
        package = module.rsplit(".", 1)[0]
        for path in (f"{module}.{name}", f"{package}.{name}"):
            table[path] = _plain(cls)
    return {f"schnetpack_tpu.{k}": v for k, v in table.items()}


#: JAX package target -> the port's constructor, ``make(context, **kwargs)``
TARGETS = _targets()


def _build(node: Any, ctx: Dict[str, Any]) -> Any:
    if isinstance(node, list):
        return [_build(v, ctx) for v in node]
    if not isinstance(node, dict):
        return node
    node = dict(node)
    target = node.pop("_target_", None)
    if target is None:
        return {k: _build(v, ctx) for k, v in node.items()}
    if target not in TARGETS:
        raise ValueError(f"load_model: no port class for the target "
                         f"{target!r}")
    if target.endswith("NeuralNetworkPotential"):
        return TARGETS[target](ctx, **node)
    kwargs = {k: _build(v, ctx) for k, v in node.items()}
    try:
        return TARGETS[target](ctx, **kwargs)
    except TypeError as e:
        raise TypeError(f"load_model: {target}: {e}") from e


def load_model(model_dir: str, device="cuda") -> Tuple[Any, Dict]:
    """(model, state dict) of a JAX run directory; the model on ``device``
    (the card unless the caller asks for the CPU) with the weights
    loaded."""
    with open(os.path.join(model_dir, "model_config.pkl"), "rb") as f:
        model_cfg = pickle.load(f)
    model = _build(model_cfg, {})
    params = params_from_jax(load_jax_params(
        os.path.join(model_dir, "best_model")))
    model.load_state_dict(params)
    return model.to(device), params
