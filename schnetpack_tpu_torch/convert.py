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
  k0 [2F, F], b0, k1 [F, 3F], b1 unchanged (the kernels' layout).

A SchNet tree (``representation/interaction_t/filter_0``) maps to
``NeuralNetworkPotential(SchNet, [Atomwise, Forces])``: every Dense layer
of an interaction (``filter_0``, ``filter_1``, ``in2f``, ``f2out_0``,
``f2out_1``) becomes the ``nn.Linear`` of the same name, transposed; the
cfconv op transposes the filter weights back to the kernels' [in, out].

An SO3net tree (``representation/so3conv_t/filternet``) maps to
``NeuralNetworkPotential(SO3net, [Atomwise, Forces], [PairwiseDistances])``:
``so3conv_t/filternet``, ``mix{1,2,3}_t`` (no bias) and ``gate_t/scaling``
become ``convs.t.filternet``, ``mix{1,2,3}.t`` and ``gates.t.scaling``,
each transposed.
"""
from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch


def load_jax_params(path: str) -> dict:
    """Unpickle a saved JAX parameter tree (numpy arrays only)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def _linear(prefix: str, dense: dict, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = dense["linear"]["kernel"].T
    if "bias" in dense["linear"]:
        out[f"{prefix}.bias"] = dense["linear"]["bias"]


def _schnet(rep: dict, out: Dict[str, np.ndarray]) -> None:
    T = sum(1 for k in rep if k.startswith("interaction_"))
    for t in range(T):
        inter = rep[f"interaction_{t}"]
        for name in ("filter_0", "filter_1", "in2f", "f2out_0", "f2out_1"):
            _linear(f"representation.interactions.{t}.{name}", inter[name],
                    out)


def _so3net(rep: dict, out: Dict[str, np.ndarray]) -> None:
    T = sum(1 for k in rep if k.startswith("so3conv_"))
    pre = "representation"
    for t in range(T):
        _linear(f"{pre}.convs.{t}.filternet", rep[f"so3conv_{t}"]["filternet"],
                out)
        for m in ("mix1", "mix2", "mix3"):
            _linear(f"{pre}.{m}.{t}", rep[f"{m}_{t}"], out)
        _linear(f"{pre}.gates.{t}.scaling", rep[f"gate_{t}"]["scaling"], out)


def _painn(rep: dict, out: Dict[str, np.ndarray]) -> None:
    kern = np.asarray(rep["filter_net"]["linear"]["kernel"], np.float32)
    bias = np.asarray(rep["filter_net"]["linear"]["bias"], np.float32)
    B = kern.shape[0]
    FWm = (np.eye(B, dtype=np.float32) @ kern + bias) - bias
    T = sum(1 for k in rep if k.startswith("interaction_"))
    F3 = kern.shape[1] // T
    out["representation.FW_aug"] = np.stack([
        np.concatenate([FWm[:, t * F3:(t + 1) * F3],
                        bias[None, t * F3:(t + 1) * F3]], axis=0)
        for t in range(T)])

    for t in range(T):
        inter = rep[f"interaction_{t}"]
        _linear(f"representation.interactions.{t}.ctx_0", inter["ctx_0"], out)
        _linear(f"representation.interactions.{t}.ctx_1", inter["ctx_1"], out)
        mix = rep[f"mixing_{t}"]
        pre = f"representation.mixing.{t}"
        out[f"{pre}.kmix"] = mix["channel_mix"]["linear"]["kernel"]
        out[f"{pre}.k0"] = mix["intra_0"]["linear"]["kernel"]
        out[f"{pre}.b0"] = mix["intra_0"]["linear"]["bias"]
        out[f"{pre}.k1"] = mix["intra_1"]["linear"]["kernel"]
        out[f"{pre}.b1"] = mix["intra_1"]["linear"]["bias"]


def params_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """State dict of the port's PaiNN, SchNet or SO3net potential from a
    flax param tree."""
    p = tree["params"] if "params" in tree else tree
    rep = p["representation"]
    out: Dict[str, np.ndarray] = {}
    out["representation.embedding.weight"] = rep["embedding"]["embedding"]
    if "so3conv_0" in rep:
        _so3net(rep, out)
    elif "filter_0" in rep.get("interaction_0", {}):
        _schnet(rep, out)
    else:
        _painn(rep, out)

    heads = sorted(k for k in p if k.startswith("output_modules_"))
    for h in heads:
        outnet = p[h]["outnet"]
        idx = h.split("_")[-1]
        for name in sorted(outnet):
            _linear(f"output_modules.{idx}.outnet.{name}", outnet[name], out)
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}
