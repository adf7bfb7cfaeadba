"""Import trained reference (torch) SchNetPack models (parity:
``schnetpack_tpu/interfaces/torch_import.py``).

Migration path for users of the reference framework: load a pickled
``NeuralNetworkPotential`` (the ``best_inference_model`` / ``*.model``
artifacts the reference's ModelCheckpoint and spkdeploy produce) and map
its weights onto the port's modules: ``import_*`` return (model on
``device``, state dict, info), the model built with the port's
constructors, the card unless the caller asks for the CPU.

Unpickling does NOT require the schnetpack package: a meta-path stub
fabricates empty ``nn.Module`` subclasses for every ``schnetpack.*`` class
(pickle restores instances without calling ``__init__``), which is enough
to read the parameter tree and the hyperparameters stored on the modules.
The port keeps its own finder (a copy of the JAX package's); the stub
modules it leaves in ``sys.modules`` serve either package's later loads.

The weights go through the JAX package's mapping (``_set`` on the flax
paths, below), onto a flax-named template of the port model
(``convert.params_to_jax``) whose shapes check every entry, and then into
the model through ``convert.params_from_jax``: so the port's imported
weights, written back with ``params_to_jax``, are the JAX import's tree.
Supported representations: PaiNN, SchNet, SO3net, FieldSchNet; the
mapping covers the representation, the Atomwise head and the
``AddOffsets`` postprocessor (atomref and mean).
"""
from __future__ import annotations

import importlib.abc
import importlib.machinery
import sys
import types
from typing import Dict, Tuple

import numpy as np
import torch

_cache: Dict[str, type] = {}


def _stub_class(attr: str):
    if attr.startswith("__") and attr.endswith("__"):
        # a stub module has no ``__file__`` and the like: ``inspect``
        # walks every module in ``sys.modules`` and reads them
        raise AttributeError(attr)
    if attr not in _cache:
        import torch.nn as nn

        _cache[attr] = type(attr, (nn.Module,), {})
    return _cache[attr]


class _StubLoader(importlib.abc.Loader):
    def create_module(self, spec):
        mod = types.ModuleType(spec.name)
        mod.__path__ = []
        mod.__getattr__ = _stub_class
        return mod

    def exec_module(self, module):
        pass


class _StubFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "schnetpack" or name.startswith("schnetpack."):
            if name in sys.modules:
                return None
            return importlib.machinery.ModuleSpec(name, _StubLoader(), is_package=True)
        return None


def load_torch_model(path: str):
    """Unpickle a reference model -> (numpy state dict, info dict)."""
    finder = _StubFinder()
    sys.meta_path.insert(0, finder)
    try:
        m = torch.load(path, map_location="cpu", weights_only=False)
    finally:
        sys.meta_path.remove(finder)

    sd = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    rep = m.representation
    # AddOffsets may sit at any index in the postprocessor list — scan for
    # its buffers instead of assuming index 1 (reference: the postprocessor
    # order is config-dependent).
    atomref = mean = None
    has_postproc = any(k.startswith("postprocessors.") for k in sd)
    for k, v in sd.items():
        if k.startswith("postprocessors.") and k.endswith(".atomref"):
            atomref = v
        elif k.startswith("postprocessors.") and k.endswith(".mean"):
            mean = v
    if has_postproc and atomref is None and mean is None:
        import warnings

        warnings.warn(
            "torch model has postprocessors but no atomref/mean buffers were "
            "found; energy offsets will not be applied", stacklevel=2
        )
    info = {
        "representation": type(rep).__name__,
        "cutoff": float(sd.get("representation.cutoff_fn.cutoff", [5.0])[0]),
        "n_rbf": int(sd["representation.radial_basis.offsets"].shape[0])
        if "representation.radial_basis.offsets" in sd else 20,
        "n_atom_basis": int(sd["representation.embedding.weight"].shape[1]),
        "max_z": int(sd["representation.embedding.weight"].shape[0]) - 1,
        "atomref": atomref,
        "mean": mean,
    }
    # count interaction blocks (SchNet/PaiNN use .interactions, SO3net
    # uses per-role module lists)
    blocks = "interactions" if any(
        k.startswith("representation.interactions.") for k in sd
    ) else "so3convs"
    n_int = 0
    while any(k.startswith(f"representation.{blocks}.{n_int}.") for k in sd):
        n_int += 1
    info["n_interactions"] = n_int or 3
    return sd, info


def _set(params_flat, path: Tuple[str, ...], value: np.ndarray, transpose=False):
    target = params_flat[path]
    v = value.T if transpose else value
    if target.shape != v.shape:
        raise ValueError(f"shape mismatch at {'/'.join(path)}: {target.shape} vs {v.shape}")
    params_flat[path] = v.astype(np.asarray(target).dtype)


def _flatten(tree: dict, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Dict[Tuple[str, ...], np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _postprocessors(info, energy_key: str):
    """[AddOffsets] where the reference model has an atomref."""
    from ..transform import AddOffsets

    if info["atomref"] is None:
        return []
    atomref = np.zeros(101)
    atomref[: len(info["atomref"])] = info["atomref"]
    return [AddOffsets(
        energy_key, add_mean=info["mean"] is not None, add_atomrefs=True,
        atomrefs=atomref,
        property_mean=float(info["mean"]) if info["mean"] is not None
        else None)]


def _potential(representation, info, energy_key: str, calc_forces: bool,
               head_activation: str):
    """NeuralNetworkPotential(representation, [Atomwise, Forces]) with the
    reference's postprocessors, and the flat flax-named template of its
    parameters."""
    from ..atomistic import Atomwise, Forces, PairwiseDistances
    from ..convert import params_to_jax
    from ..model import NeuralNetworkPotential

    pot = NeuralNetworkPotential(
        representation,
        [Atomwise(n_in=info["n_atom_basis"], output_key=energy_key,
                  activation=head_activation),
         *([Forces(energy_key=energy_key)] if calc_forces else [])],
        input_modules=[PairwiseDistances(columns=False)],
        postprocessors=_postprocessors(info, energy_key))
    return pot, _flatten(params_to_jax(pot)["params"])


def _finish(pot, flat, sd, info, device):
    """The Atomwise head's weights, then the tree into the model on
    ``device``: (model, state dict, info)."""
    from ..cli import _device
    from ..convert import params_from_jax

    device = _device(device)
    _import_atomwise(flat, sd, prefix="output_modules.0.outnet")
    params = params_from_jax({"params": _unflatten(flat)})
    pot.load_state_dict(params)
    return pot.to(device), params, info


def _import_atomwise(flat, sd, prefix: str):
    head = ("output_modules_0", "outnet")
    i = 0
    while f"{prefix}.{i}.weight" in sd:
        _set(flat, head + (f"dense_{i}", "linear", "kernel"),
             sd[f"{prefix}.{i}.weight"], transpose=True)
        _set(flat, head + (f"dense_{i}", "linear", "bias"), sd[f"{prefix}.{i}.bias"])
        i += 1


def _generator():
    """Initial weights (all overwritten by the reference's) from a fixed
    seed."""
    return torch.Generator().manual_seed(0)


def import_painn(path: str, energy_key: str = "energy",
                 calc_forces: bool = True, device="cuda"):
    """(model, state dict, info) of a reference-trained PaiNN potential."""
    from ..representation import PaiNN

    sd, info = load_torch_model(path)
    if info["representation"] != "PaiNN":
        raise ValueError(f"not a PaiNN model: {info['representation']}")

    F = info["n_atom_basis"]
    n_int = info["n_interactions"]
    pot, flat = _potential(PaiNN(
        n_atom_basis=F, n_interactions=n_int, n_rbf=info["n_rbf"],
        cutoff=info["cutoff"], max_z=info["max_z"], activation="silu",
        shared_filters=False, generator=_generator()),
        info, energy_key, calc_forces, "silu")

    rep = ("representation",)
    _set(flat, rep + ("embedding", "embedding"), sd["representation.embedding.weight"])
    _set(flat, rep + ("filter_net", "linear", "kernel"),
         sd["representation.filter_net.weight"], transpose=True)
    _set(flat, rep + ("filter_net", "linear", "bias"),
         sd["representation.filter_net.bias"])
    for t in range(n_int):
        base = f"representation.interactions.{t}.interatomic_context_net"
        _set(flat, rep + (f"interaction_{t}", "ctx_0", "linear", "kernel"),
             sd[f"{base}.0.weight"], transpose=True)
        _set(flat, rep + (f"interaction_{t}", "ctx_0", "linear", "bias"),
             sd[f"{base}.0.bias"])
        _set(flat, rep + (f"interaction_{t}", "ctx_1", "linear", "kernel"),
             sd[f"{base}.1.weight"], transpose=True)
        _set(flat, rep + (f"interaction_{t}", "ctx_1", "linear", "bias"),
             sd[f"{base}.1.bias"])
        mbase = f"representation.mixings.{t}" if f"representation.mixings.{t}.mu_channel_mix.weight" in sd else f"representation.mixing.{t}"
        _set(flat, rep + (f"mixing_{t}", "channel_mix", "linear", "kernel"),
             sd[f"{mbase}.mu_channel_mix.weight"], transpose=True)
        _set(flat, rep + (f"mixing_{t}", "intra_0", "linear", "kernel"),
             sd[f"{mbase}.intraatomic_context_net.0.weight"], transpose=True)
        _set(flat, rep + (f"mixing_{t}", "intra_0", "linear", "bias"),
             sd[f"{mbase}.intraatomic_context_net.0.bias"])
        _set(flat, rep + (f"mixing_{t}", "intra_1", "linear", "kernel"),
             sd[f"{mbase}.intraatomic_context_net.1.weight"], transpose=True)
        _set(flat, rep + (f"mixing_{t}", "intra_1", "linear", "bias"),
             sd[f"{mbase}.intraatomic_context_net.1.bias"])
    return _finish(pot, flat, sd, info, device)


def _check_activation(activation, name: str):
    """The port's SchNet and FieldSchNet run the reference default,
    shifted softplus, only."""
    from ..ops.activations import shifted_softplus

    if activation not in (None, "ssp", shifted_softplus):
        raise ValueError(
            f"{name}: activation {activation!r}: the port's {name} runs "
            "shifted softplus only")


def _schnet_interactions(flat, sd, rep, n_int):
    for t in range(n_int):
        b = f"representation.interactions.{t}"
        _set(flat, rep + (f"interaction_{t}", "filter_0", "linear", "kernel"),
             sd[f"{b}.filter_network.0.weight"], transpose=True)
        _set(flat, rep + (f"interaction_{t}", "filter_0", "linear", "bias"),
             sd[f"{b}.filter_network.0.bias"])
        _set(flat, rep + (f"interaction_{t}", "filter_1", "linear", "kernel"),
             sd[f"{b}.filter_network.1.weight"], transpose=True)
        _set(flat, rep + (f"interaction_{t}", "filter_1", "linear", "bias"),
             sd[f"{b}.filter_network.1.bias"])
        _set(flat, rep + (f"interaction_{t}", "in2f", "linear", "kernel"),
             sd[f"{b}.in2f.weight"], transpose=True)
        _set(flat, rep + (f"interaction_{t}", "f2out_0", "linear", "kernel"),
             sd[f"{b}.f2out.0.weight"], transpose=True)
        _set(flat, rep + (f"interaction_{t}", "f2out_0", "linear", "bias"),
             sd[f"{b}.f2out.0.bias"])
        _set(flat, rep + (f"interaction_{t}", "f2out_1", "linear", "kernel"),
             sd[f"{b}.f2out.1.weight"], transpose=True)
        _set(flat, rep + (f"interaction_{t}", "f2out_1", "linear", "bias"),
             sd[f"{b}.f2out.1.bias"])


def import_schnet(path: str, energy_key: str = "energy", calc_forces: bool = True,
                  activation=None, head_activation=None, device="cuda"):
    """(model, state dict, info) of a reference-trained SchNet potential.

    The activation is not recoverable from the state dict.  The reference
    SchNet defaults to shifted_softplus (ref representation/schnet.py:22),
    the only one the port's SchNet runs, and its Atomwise head to silu
    (ref atomistic/atomwise.py:27); pass ``head_activation`` ("ssp" or
    "silu") for a model trained with another head.
    """
    from ..representation import SchNet

    _check_activation(activation, "SchNet")
    sd, info = load_torch_model(path)
    if info["representation"] != "SchNet":
        raise ValueError(f"not a SchNet model: {info['representation']}")
    F = info["n_atom_basis"]
    n_int = info["n_interactions"]
    pot, flat = _potential(SchNet(
        n_atom_basis=F, n_interactions=n_int, n_rbf=info["n_rbf"],
        cutoff=info["cutoff"], max_z=info["max_z"], generator=_generator()),
        info, energy_key, calc_forces, head_activation or "silu")
    rep = ("representation",)
    _set(flat, rep + ("embedding", "embedding"), sd["representation.embedding.weight"])
    _schnet_interactions(flat, sd, rep, n_int)
    return _finish(pot, flat, sd, info, device)


def import_so3net(path: str, energy_key: str = "energy",
                  calc_forces: bool = True, head_activation=None,
                  device="cuda"):
    """(model, state dict, info) of a reference-trained SO3net potential:
    the real-Ylm bases and the real CG tensors agree elementwise with the
    reference's (``tests/test_so3_import.py``), so the weights transfer
    directly."""
    from ..representation import SO3net

    sd, info = load_torch_model(path)
    if info["representation"] != "SO3net":
        raise ValueError(f"not a SO3net model: {info['representation']}")
    F = info["n_atom_basis"]
    n_int = info["n_interactions"]
    lmax = sd["representation.so3convs.0.filternet.weight"].shape[0] // F - 1
    pot, flat = _potential(SO3net(
        n_atom_basis=F, n_interactions=n_int, lmax=lmax,
        n_rbf=info["n_rbf"], cutoff=info["cutoff"], max_z=info["max_z"],
        generator=_generator()),
        info, energy_key, calc_forces, head_activation or "silu")
    rep = ("representation",)
    _set(flat, rep + ("embedding", "embedding"),
         sd["representation.embedding.weight"])
    for t in range(n_int):
        _set(flat, rep + (f"so3conv_{t}", "filternet", "linear", "kernel"),
             sd[f"representation.so3convs.{t}.filternet.weight"],
             transpose=True)
        _set(flat, rep + (f"so3conv_{t}", "filternet", "linear", "bias"),
             sd[f"representation.so3convs.{t}.filternet.bias"])
        for role, ours in (("mixings1", "mix1"), ("mixings2", "mix2"),
                           ("mixings3", "mix3")):
            _set(flat, rep + (f"{ours}_{t}", "linear", "kernel"),
                 sd[f"representation.{role}.{t}.weight"], transpose=True)
        _set(flat, rep + (f"gate_{t}", "scaling", "linear", "kernel"),
             sd[f"representation.gatings.{t}.scaling.weight"], transpose=True)
        _set(flat, rep + (f"gate_{t}", "scaling", "linear", "bias"),
             sd[f"representation.gatings.{t}.scaling.bias"])
    return _finish(pot, flat, sd, info, device)


def import_field_schnet(path: str, energy_key: str = "energy",
                        calc_forces: bool = True, activation=None,
                        response_properties=None, device="cuda"):
    """(model, state dict, info) of a reference-trained FieldSchNet
    potential: the representation (reference representation/
    field_schnet.py:19-247: interactions, field_interaction,
    dipole_interaction, dipole_update, initial_dipole_update,
    nmm_embedding) and the Atomwise head.  External fields are discovered
    from the state-dict keys."""
    from ..representation import FieldSchNet

    _check_activation(activation, "FieldSchNet")
    sd, info = load_torch_model(path)
    if info["representation"] != "FieldSchNet":
        raise ValueError(f"not a FieldSchNet model: {info['representation']}")
    F = info["n_atom_basis"]
    n_int = info["n_interactions"]
    fields = sorted({
        k.split(".")[3]
        for k in sd
        if k.startswith("representation.initial_dipole_update.transform.")
        and k.endswith(".weight")
    } | {
        k.split(".")[4]
        for k in sd
        if k.startswith("representation.dipole_update.")
        and ".transform." in k and k.endswith(".weight")
    })
    pot, flat = _potential(FieldSchNet(
        n_atom_basis=F, n_interactions=n_int, n_rbf=info["n_rbf"],
        cutoff=info["cutoff"], max_z=info["max_z"],
        external_fields=tuple(fields),
        response_properties=response_properties, generator=_generator()),
        info, energy_key, calc_forces, "silu")
    rep = ("representation",)
    _set(flat, rep + ("embedding", "embedding"),
         sd["representation.embedding.weight"])

    def tag(f):
        return f.strip("_")

    for f in fields:
        _set(flat, rep + ("initial_dipole_update", f"transform_{tag(f)}",
                          "linear", "kernel"),
             sd[f"representation.initial_dipole_update.transform.{f}.weight"],
             transpose=True)
    if "representation.nmm_embedding.gyromagnetic_ratio.weight" in sd:
        g = sd["representation.nmm_embedding.gyromagnetic_ratio.weight"]
        tgt = flat[rep + ("nmm_embedding", "gyromagnetic", "embedding")]
        gg = np.zeros_like(np.asarray(tgt))
        gg[: len(g)] = g
        flat[rep + ("nmm_embedding", "gyromagnetic", "embedding")] = gg
        _set(flat, rep + ("nmm_embedding", "delta", "linear", "kernel"),
             sd["representation.nmm_embedding.vector_mapping.weight"],
             transpose=True)
    _schnet_interactions(flat, sd, rep, n_int)
    for t in range(n_int):
        for f in fields:
            tg = tag(f)
            fb = f"representation.field_interaction.{t}.f2out.{f}"
            _set(flat, rep + (f"field_inter_{t}", f"f2out_{tg}", "linear",
                              "kernel"), sd[f"{fb}.weight"], transpose=True)
            _set(flat, rep + (f"field_inter_{t}", f"f2out_{tg}", "linear",
                              "bias"), sd[f"{fb}.bias"])
            db = f"representation.dipole_interaction.{t}"
            _set(flat, rep + (f"dipole_inter_{t}", f"filter_{tg}_0",
                              "linear", "kernel"),
                 sd[f"{db}.filter_network.{f}.0.weight"], transpose=True)
            _set(flat, rep + (f"dipole_inter_{t}", f"filter_{tg}_0",
                              "linear", "bias"),
                 sd[f"{db}.filter_network.{f}.0.bias"])
            _set(flat, rep + (f"dipole_inter_{t}", f"filter_{tg}_1",
                              "linear", "kernel"),
                 sd[f"{db}.filter_network.{f}.1.weight"], transpose=True)
            _set(flat, rep + (f"dipole_inter_{t}", f"filter_{tg}_1",
                              "linear", "bias"),
                 sd[f"{db}.filter_network.{f}.1.bias"])
            _set(flat, rep + (f"dipole_inter_{t}", f"transform_{tg}",
                              "linear", "kernel"),
                 sd[f"{db}.transform.{f}.weight"], transpose=True)
            _set(flat, rep + (f"dipole_inter_{t}", f"transform_{tg}",
                              "linear", "bias"),
                 sd[f"{db}.transform.{f}.bias"])
            _set(flat, rep + (f"dipole_update_{t}", f"transform_{tg}",
                              "linear", "kernel"),
                 sd[f"representation.dipole_update.{t}.transform.{f}.weight"],
                 transpose=True)
    info["external_fields"] = fields
    return _finish(pot, flat, sd, info, device)


def import_torch_model(path: str, **kwargs):
    """Dispatch on the representation class of the pickled model."""
    _, info = load_torch_model(path)
    if info["representation"] == "PaiNN":
        return import_painn(path, **kwargs)
    if info["representation"] == "SchNet":
        return import_schnet(path, **kwargs)
    if info["representation"] == "SO3net":
        return import_so3net(path, **kwargs)
    if info["representation"] == "FieldSchNet":
        return import_field_schnet(path, **kwargs)
    raise NotImplementedError(
        f"weight import for {info['representation']} is not supported yet"
    )
