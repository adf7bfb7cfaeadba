"""Parameters of the JAX package -> the port's modules.

The JAX package saves parameters (``schnetpack_tpu/train/callbacks.py:
18-27``, e.g. ``scripts/assets/bench_painn_argon.msgpack``) as a plain
pickle of nested dicts of numpy arrays, so ``load_jax_params`` needs numpy
alone.  ``params_from_jax`` maps that flax tree to a ``state_dict`` of
``NeuralNetworkPotential(PaiNN, [Atomwise, Forces])``:

* flax ``Dense`` kernels are [in, out]; ``nn.Linear.weight`` is [out, in];
* ``filter_net`` [B, T*3F] becomes ``FW_aug`` [T, B+1, 3F], laid out as
  ``painn.py:403-416`` lays it out: the kernel's B rows and then the bias
  row (``painn.py`` computes the rows as filter_net(I) - bias, equal to
  the kernel up to the last bit; the kernel itself keeps the map exact
  both ways);
* ``mixing_t/{channel_mix, intra_0, intra_1}`` map to kmix [F, 2F],
  k0 [2F, F], b0, k1 [F, 3F], b1 unchanged (the kernels' layout);
* a trainable basis's ``radial_basis/{centers, widths}`` map to
  ``radial_basis.{centers, widths}``.  ``load_jax_params(asset,
  radial_from=npz)`` puts them into a tree that has none: the trained
  PaiNN asset with the centers and widths of a fixture.

Every other module maps by name (``_tree``): a flax ``Dense`` becomes the
``nn.Linear`` of the same name, transposed, an ``nn.Embed`` table
``{name}.weight``, and any other array (``element_embedding``, ``k_plus``,
a gate's ``scaling``, a basis's ``centers``) the parameter of the same
name.  Per-block modules sit in lists (``_LISTS``): ``interaction_t`` ->
``interactions.t``, ``mixing_t`` -> ``mixing.t``, SO3net's ``so3conv_t``
-> ``convs.t``, ``mix{1,2,3}_t`` -> ``mix{1,2,3}.t``, ``gate_t`` ->
``gates.t``, FieldSchNet's ``field_inter_t``, ``dipole_inter_t`` and
``dipole_update_t`` -> ``field_inter.t``, ``dipole_inter.t``,
``dipole_update.t``; a shared block (``interaction_shared``, ...) is
index 0 of its list.  So a SchNet tree (``representation/interaction_t/
filter_0``) maps to ``NeuralNetworkPotential(SchNet, [Atomwise, Forces])``
(the cfconv op transposes the filter weights back to the kernels' [in,
out]), an SO3net tree (``so3conv_t/filternet``, ``mix{1,2,3}_t`` without
bias, ``gate_t/scaling``) to ``NeuralNetworkPotential(SO3net, ...)``, and a
FieldSchNet tree (``representation/{embedding, initial_dipole_update,
interaction_t, field_inter_t, dipole_inter_t, dipole_update_t,
nmm_embedding}``) to ``NeuralNetworkPotential(FieldSchNet, ...)``: e.g.
``dipole_inter_2/filter_electric_field_1`` -> ``dipole_inter.2.
filter_electric_field_1``, ``nmm_embedding/gyromagnetic`` ->
``nmm_embedding.gyromagnetic.weight``.  A ``NuclearEmbedding`` at
``embedding`` and the ``charge_embedding`` / ``spin_embedding`` trees
(``query``, ``k_plus``, ``resmlp/residual_0/dense_0``, ...) map by name
too.

``params_to_jax`` is the inverse: the flax tree (``{"params": ...}``, numpy
float32) of a port potential's parameters, or of any tensors named as its
parameters (gradients, an EMA copy), so that a port-trained run directory
holds the JAX package's ``best_model``.
"""
from __future__ import annotations

import pickle
import re
from typing import Dict, Optional

import numpy as np
import torch


def load_jax_params(path: str, radial_from: Optional[str] = None) -> dict:
    """Unpickle a saved JAX parameter tree (numpy arrays only); with
    ``radial_from``, an ``.npz`` holding ``centers`` and ``widths``, add
    those as a trainable Gaussian basis (``with_radial_params``)."""
    with open(path, "rb") as f:
        tree = pickle.load(f)
    if radial_from is not None:
        ref = np.load(radial_from)
        tree = with_radial_params(tree, ref["centers"], ref["widths"])
    return tree


def with_radial_params(tree: dict, centers, widths) -> dict:
    """A copy of the PaiNN param tree ``tree`` with a trainable Gaussian
    basis: ``representation/radial_basis/{centers, widths}`` set (the
    flax module's param path)."""
    p = dict(tree["params"] if "params" in tree else tree)
    p["representation"] = dict(p["representation"], radial_basis={
        "centers": np.asarray(centers, np.float32),
        "widths": np.asarray(widths, np.float32)})
    return {"params": p} if "params" in tree else p


def _linear(prefix: str, dense: dict, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = dense["linear"]["kernel"].T
    if "bias" in dense["linear"]:
        out[f"{prefix}.bias"] = dense["linear"]["bias"]


#: flax names of per-block modules -> the port's module lists
_LISTS = {"interaction": "interactions", "mixing": "mixing",
          "so3conv": "convs", "mix1": "mix1", "mix2": "mix2", "mix3": "mix3",
          "gate": "gates", "field_inter": "field_inter",
          "dipole_inter": "dipole_inter", "dipole_update": "dipole_update"}
_BLOCK = re.compile(r"^(\w+?)_(\d+|shared)$")


def _module_path(name: str) -> str:
    """The port's path of a flax module directly under the representation
    (``interaction_2`` -> ``interactions.2``, ``so3conv_shared`` ->
    ``convs.0``)."""
    m = _BLOCK.match(name)
    if m is None or m.group(1) not in _LISTS:
        return name
    t = m.group(2)
    return f"{_LISTS[m.group(1)]}.{0 if t == 'shared' else t}"


def _tree(prefix: str, node: dict, out: Dict[str, np.ndarray]) -> None:
    """Map a flax module tree by name (see the module docstring)."""
    if isinstance(node.get("linear"), dict) and "kernel" in node["linear"]:
        _linear(prefix, node, out)
        return
    for k, v in node.items():
        if isinstance(v, dict):
            _tree(f"{prefix}.{k}", v, out)
        else:
            out[f"{prefix}.{'weight' if k == 'embedding' else k}"] = v


def _painn_filters(rep: dict, out: Dict[str, np.ndarray]) -> None:
    """``filter_net`` [B, T*3F] (one [B, 3F] slice with shared filters) ->
    ``FW_aug`` [T, B+1, 3F], the kernel's rows and then the bias."""
    FWm = np.asarray(rep["filter_net"]["linear"]["kernel"], np.float32)
    bias = np.asarray(rep["filter_net"]["linear"]["bias"], np.float32)
    mix = next(v for k, v in rep.items() if k.startswith("mixing_"))
    F3 = 3 * mix["intra_0"]["linear"]["bias"].shape[0]
    out["representation.FW_aug"] = np.stack([
        np.concatenate([FWm[:, t * F3:(t + 1) * F3],
                        bias[None, t * F3:(t + 1) * F3]], axis=0)
        for t in range(FWm.shape[1] // F3)])


def _painn_mixing(prefix: str, mix: dict, out: Dict[str, np.ndarray]) -> None:
    """``mixing_t/{channel_mix, intra_0, intra_1}`` -> kmix, k0, b0, k1,
    b1 in the kernels' (flax's) layout."""
    out[f"{prefix}.kmix"] = mix["channel_mix"]["linear"]["kernel"]
    out[f"{prefix}.k0"] = mix["intra_0"]["linear"]["kernel"]
    out[f"{prefix}.b0"] = mix["intra_0"]["linear"]["bias"]
    out[f"{prefix}.k1"] = mix["intra_1"]["linear"]["kernel"]
    out[f"{prefix}.b1"] = mix["intra_1"]["linear"]["bias"]


def params_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """State dict of the port's PaiNN, SchNet, SO3net or FieldSchNet
    potential from a flax param tree."""
    p = tree["params"] if "params" in tree else tree
    out: Dict[str, np.ndarray] = {}
    for name, node in p["representation"].items():
        pre = f"representation.{_module_path(name)}"
        if name == "filter_net":
            _painn_filters(p["representation"], out)
        elif name.startswith("mixing_"):
            _painn_mixing(pre, node, out)
        else:
            _tree(pre, node, out)

    for name, node in p.items():
        if name.startswith("output_modules_"):
            _tree(f"output_modules.{name.split('_')[-1]}", node, out)
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in out.items()}


#: the port's module lists -> the flax names of their blocks
_FLAX_LISTS = {v: k for k, v in _LISTS.items()}


def _jax_path(prefix: str, shared: bool):
    """The flax module path of a port module path (``representation.
    interactions.2`` -> representation/interaction_2; ``output_modules.0.
    outnet`` -> output_modules_0/outnet)."""
    parts = prefix.split(".")
    if parts[0] == "output_modules":
        return [f"output_modules_{parts[1]}"] + parts[2:]
    if (parts[0] == "representation" and len(parts) > 2
            and parts[1] in _FLAX_LISTS and parts[2].isdigit()):
        t = "shared" if shared else parts[2]
        return [parts[0], f"{_FLAX_LISTS[parts[1]]}_{t}"] + parts[3:]
    return parts


def _put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def params_to_jax(model, tensors: Optional[Dict[str, torch.Tensor]] = None
                  ) -> dict:
    """``{"params": tree}``, the flax tree of ``model``'s parameters (or of
    ``tensors``, named as they are), inverting ``params_from_jax``:
    ``nn.Linear`` weights transposed into ``linear/kernel``, embedding
    tables to ``embedding``, PaiNN's ``FW_aug`` [T, B+1, 3F] into
    ``filter_net`` and its mixing parameters into ``channel_mix``,
    ``intra_0`` and ``intra_1``; a representation built with
    ``shared_interactions`` names its blocks ``*_shared``."""
    from torch import nn as tnn

    if tensors is None:
        tensors = dict(model.named_parameters())
    modules = dict(model.named_modules())
    shared = getattr(model.representation, "shared_interactions", False)
    tree: dict = {}
    for name, value in tensors.items():
        v = np.ascontiguousarray(value.detach().cpu().numpy(), np.float32)
        prefix, leaf = name.rsplit(".", 1)
        path = _jax_path(prefix, shared)
        mod = modules[prefix]
        if leaf == "FW_aug":
            B = v.shape[1] - 1
            _put(tree, path + ["filter_net", "linear"], {
                "kernel": np.concatenate(list(v[:, :B]), axis=1),
                "bias": np.concatenate(list(v[:, B]), axis=0)})
        elif leaf in ("kmix", "k0", "b0", "k1", "b1"):
            dense, key = {"kmix": ("channel_mix", "kernel"),
                          "k0": ("intra_0", "kernel"),
                          "b0": ("intra_0", "bias"),
                          "k1": ("intra_1", "kernel"),
                          "b1": ("intra_1", "bias")}[leaf]
            _put(tree, path + [dense, "linear", key], v)
        elif isinstance(mod, tnn.Linear):
            _put(tree, path + ["linear", "kernel" if leaf == "weight"
                               else "bias"],
                 v.T.copy() if leaf == "weight" else v)
        elif isinstance(mod, tnn.Embedding):
            _put(tree, path + ["embedding"], v)
        else:
            _put(tree, path + [leaf], v)
    return {"params": tree}
