"""Parameters of the JAX package -> the port's modules.

The JAX package saves parameters (``schnetpack_tpu/train/callbacks.py:
18-27``, e.g. ``scripts/assets/bench_painn_argon.msgpack``) as a plain
pickle of nested dicts of numpy arrays, so ``load_jax_params`` needs numpy
alone.  ``params_from_jax`` maps that flax tree to a ``state_dict`` of
``NeuralNetworkPotential(PaiNN, [Atomwise, Forces])``:

* flax ``Dense`` kernels are [in, out]; ``nn.Linear.weight`` is [out, in];
* ``filter_net`` [B, T*3F] becomes ``FW_aug`` [T, B+1, 3F], built as
  ``painn.py:403-416`` builds it: the bias row is filter_net(0) and
  FWm = filter_net(I) - bias;
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
    ``FW_aug`` [T, B+1, 3F]."""
    kern = np.asarray(rep["filter_net"]["linear"]["kernel"], np.float32)
    bias = np.asarray(rep["filter_net"]["linear"]["bias"], np.float32)
    B = kern.shape[0]
    FWm = (np.eye(B, dtype=np.float32) @ kern + bias) - bias
    mix = next(v for k, v in rep.items() if k.startswith("mixing_"))
    F3 = 3 * mix["intra_0"]["linear"]["bias"].shape[0]
    out["representation.FW_aug"] = np.stack([
        np.concatenate([FWm[:, t * F3:(t + 1) * F3],
                        bias[None, t * F3:(t + 1) * F3]], axis=0)
        for t in range(kern.shape[1] // F3)])


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
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}
