"""PyTorch port, ``interfaces/torch_import.py`` on the CPU against the JAX
package's (``schnetpack_tpu/interfaces/torch_import.py``), on synthetic
reference-format pickles (no reference checkpoint is in the repo): random
weights under the state-dict names the import reads, in stand-in classes
named ``NeuralNetworkPotential``, ``PaiNN``, ``SchNet``, ``SO3net``,
``FieldSchNet`` and ``AddOffsets`` that pickle as ``schnetpack.*`` classes,
so loading goes through the stub finder:

* PaiNN (with ``AddOffsets``: atomref and mean), SchNet, SO3net (lmax 2)
  and FieldSchNet (the electric field), F = 16, 2 interactions, 8 radial
  functions;
* ``convert.params_to_jax`` of the port's imported weights equals the JAX
  ``import_torch_model``'s tree leaf for leaf, bit for bit, and ``info``
  is equal;
* the energies (within 1e-5 of the larger of |E| and the sum of the
  atoms' |E_i|: random weights can cancel the sum to ~0.1 of its terms)
  and forces (within 1e-4 of the largest |F|) of both on two molecules
  through each package's ``SpkCalculator``;
* both packages' stub finders in one process: loading with the port
  first or the JAX package first gives the same state dict;
* FieldSchNet with the magnetic field and the nuclear magnetic moment
  embedding: the port imports it (the embedding's weights as the
  reference's), the JAX import raises (its template's ``init`` batch
  carries no nuclear moments, so flax makes no ``nmm_embedding``
  parameters to write into: a reference-side fault, ROADMAP Queue 3).
"""
import copy
import inspect
import sys
import types

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn

from schnetpack_tpu.interfaces import ase_interface as jase
from schnetpack_tpu.interfaces import torch_import as jimport
from schnetpack_tpu_torch.convert import params_to_jax
from schnetpack_tpu_torch.interfaces import ase_interface as tase
from schnetpack_tpu_torch.interfaces import torch_import as timport

from test_torch_port_interfaces import E_RTOL, forces_close, molecule

F, NRBF, NINT, CUTOFF, MAXZ, LMAX = 16, 8, 2, 4.0, 20, 2
#: the reference pickles: (representation class, FieldSchNet's fields)
REFERENCES = {"PaiNN": ("PaiNN", ()), "SchNet": ("SchNet", ()),
              "SO3net": ("SO3net", ()),
              "FieldSchNet": ("FieldSchNet", ("electric_field",)),
              "FieldSchNetNMM": ("FieldSchNet", ("electric_field",
                                                 "magnetic_field"))}


def _stand_in(name, module):
    return type(name, (tnn.Module,), {"__module__": module})


CLASSES = {
    "NeuralNetworkPotential": _stand_in("NeuralNetworkPotential",
                                        "schnetpack.model"),
    "AddOffsets": _stand_in("AddOffsets", "schnetpack.transform"),
    **{n: _stand_in(n, "schnetpack.representation")
       for n in ("PaiNN", "SchNet", "SO3net", "FieldSchNet")},
}


def _lin(prefix, n_out, n_in, bias=True):
    out = {f"{prefix}.weight": (n_out, n_in)}
    if bias:
        out[f"{prefix}.bias"] = (n_out,)
    return out


def _schnet_blocks(n_int):
    keys = {}
    for t in range(n_int):
        b = f"representation.interactions.{t}"
        keys.update(_lin(f"{b}.filter_network.0", F, NRBF))
        keys.update(_lin(f"{b}.filter_network.1", F, F))
        keys.update(_lin(f"{b}.in2f", F, F, bias=False))
        keys.update(_lin(f"{b}.f2out.0", F, F))
        keys.update(_lin(f"{b}.f2out.1", F, F))
    return keys


def reference_keys(rep, fields=()):
    """{state-dict key: shape} of a reference model (the weights)."""
    keys = {"representation.embedding.weight": (MAXZ + 1, F)}
    if rep == "PaiNN":
        keys.update(_lin("representation.filter_net", NINT * 3 * F, NRBF))
        for t in range(NINT):
            b = f"representation.interactions.{t}.interatomic_context_net"
            keys.update(_lin(f"{b}.0", F, F))
            keys.update(_lin(f"{b}.1", 3 * F, F))
            m = f"representation.mixing.{t}"
            keys.update(_lin(f"{m}.mu_channel_mix", 2 * F, F, bias=False))
            keys.update(_lin(f"{m}.intraatomic_context_net.0", F, 2 * F))
            keys.update(_lin(f"{m}.intraatomic_context_net.1", 3 * F, F))
    elif rep == "SchNet":
        keys.update(_schnet_blocks(NINT))
    elif rep == "SO3net":
        for t in range(NINT):
            keys.update(_lin(f"representation.so3convs.{t}.filternet",
                             (LMAX + 1) * F, NRBF))
            for role in ("mixings1", "mixings2", "mixings3"):
                keys.update(_lin(f"representation.{role}.{t}", F, F,
                                 bias=False))
            keys.update(_lin(f"representation.gatings.{t}.scaling",
                             (LMAX + 1) * F, F))
    else:
        keys.update(_schnet_blocks(NINT))
        if "magnetic_field" in fields:
            keys["representation.nmm_embedding.gyromagnetic_ratio."
                 "weight"] = (MAXZ + 1, 1)
            keys.update(_lin("representation.nmm_embedding.vector_mapping",
                             F, 1, bias=False))
        for f in fields:
            keys.update(_lin(f"representation.initial_dipole_update."
                             f"transform.{f}", F, F, bias=False))
            for t in range(NINT):
                keys.update(_lin(f"representation.field_interaction.{t}."
                                 f"f2out.{f}", F, F))
                d = f"representation.dipole_interaction.{t}"
                keys.update(_lin(f"{d}.filter_network.{f}.0", F, NRBF))
                keys.update(_lin(f"{d}.filter_network.{f}.1", F, F))
                keys.update(_lin(f"{d}.transform.{f}", F, F))
                keys.update(_lin(f"representation.dipole_update.{t}."
                                 f"transform.{f}", F, F, bias=False))
    keys.update(_lin("output_modules.0.outnet.0", F // 2, F))
    keys.update(_lin("output_modules.0.outnet.1", 1, F // 2))
    return keys


def _child(root, path):
    mod = root
    for name in path:
        if name not in mod._modules:
            mod.add_module(name, tnn.Module())
        mod = mod._modules[name]
    return mod


def make_reference(name, seed, offsets=False):
    """A reference-format potential ``REFERENCES[name]`` with seeded
    weights."""
    rep, fields = REFERENCES[name]
    g = torch.Generator().manual_seed(seed)
    root = CLASSES["NeuralNetworkPotential"]()
    root.add_module("representation", CLASSES[rep]())
    for key, shape in reference_keys(rep, fields).items():
        *path, leaf = key.split(".")
        scale = 0.5 if leaf == "weight" else 0.1
        _child(root, path).register_parameter(leaf, tnn.Parameter(
            torch.randn(shape, generator=g) * scale))
    _child(root, ["representation", "cutoff_fn"]).register_buffer(
        "cutoff", torch.tensor([CUTOFF]))
    _child(root, ["representation", "radial_basis"]).register_buffer(
        "offsets", torch.linspace(0.0, CUTOFF, NRBF))
    if offsets:
        post = tnn.ModuleList([tnn.Module(), CLASSES["AddOffsets"]()])
        post[1].register_buffer("atomref", torch.randn(
            MAXZ + 1, generator=g, dtype=torch.float64))
        post[1].register_buffer("mean", torch.tensor(-0.7,
                                                     dtype=torch.float64))
        root.add_module("postprocessors", post)
    return root


def _forget_stubs():
    for name in [m for m in sys.modules
                 if m == "schnetpack" or m.startswith("schnetpack.")]:
        del sys.modules[name]


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """{representation: path} of the saved reference pickles, written with
    ``schnetpack.*`` modules that exist only while saving."""
    d = tmp_path_factory.mktemp("ref")
    fakes = {}
    for cls in CLASSES.values():
        mod = fakes.setdefault(cls.__module__, types.ModuleType(cls.__module__))
        setattr(mod, cls.__name__, cls)
    fakes["schnetpack"] = types.ModuleType("schnetpack")
    _forget_stubs()
    sys.modules.update(fakes)
    try:
        out = {}
        for seed, name in enumerate(REFERENCES):
            out[name] = str(d / f"{name}.model")
            torch.save(make_reference(name, seed, offsets=name == "PaiNN"),
                       out[name])
    finally:
        _forget_stubs()
    return out


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _same_info(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def atom_energy_scale(model, calc, mol):
    """The sum of the atoms' |E_i| of ``mol`` (the energy head's terms)."""
    m = copy.deepcopy(model)
    m.output_modules[0].per_atom_output_key = "energy_i"
    with torch.no_grad():
        out = m.energy_outputs(calc.converter(mol))
    return float(out["energy_i"].abs().sum())


@pytest.mark.parametrize("rep", ["PaiNN", "SchNet", "SO3net",
                                 "FieldSchNet"])
def test_import_matches_jax(pickles, rep):
    model, params, info = timport.import_torch_model(pickles[rep],
                                                     device="cpu")
    jmodel, jparams, jinfo = jimport.import_torch_model(pickles[rep])
    assert type(model.representation).__name__ == rep
    assert model.representation.n_atom_basis == F
    _same_info(info, jinfo)
    got = dict(_leaves(params_to_jax(model)))
    want = dict(_leaves(jax.device_get(jparams)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg="/".join(k))
    if rep == "PaiNN":
        assert len(model.postprocessors) == 1
        assert model.postprocessors[0].mean == pytest.approx(-0.7)
    for seed in (1, 2):
        mol = molecule(seed, n=6)
        mol["_atomic_numbers"] = np.array([1, 6, 8, 6, 1, 7])
        calc = tase.SpkCalculator(model, cutoff=info["cutoff"],
                                  device="cpu")
        g = calc.calculate(mol)
        w = jase.SpkCalculator(jmodel, jparams,
                               cutoff=info["cutoff"]).calculate(mol)
        scale = max(abs(w["energy"]), atom_energy_scale(model, calc, mol))
        assert abs(g["energy"] - w["energy"]) <= E_RTOL * scale
        forces_close(g["forces"], w["forces"])


@pytest.mark.parametrize("first", ["port", "jax"])
def test_stub_finders_in_either_order(pickles, first):
    _forget_stubs()
    loaders = {"port": timport.load_torch_model,
               "jax": jimport.load_torch_model}
    order = [first, "jax" if first == "port" else "port"]
    try:
        loaded = {name: loaders[name](pickles["PaiNN"]) for name in order}
        # the stubs the first finder made serve the second
        assert "schnetpack.representation" in sys.modules
    finally:
        _forget_stubs()
    (sd, info), (jsd, jinfo) = loaded["port"], loaded["jax"]
    assert sd.keys() == jsd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)
    _same_info(info, jinfo)
    assert info["representation"] == "PaiNN" and info["n_interactions"] == 2


def test_the_port_stubs_answer_no_dunder_attribute(pickles):
    """The stub modules that the port's finder leaves in ``sys.modules``
    have no ``__file__`` (a class in its place broke ``inspect.getmodule``,
    which walks every module and which torch's own imports call)."""
    _forget_stubs()
    try:
        timport.load_torch_model(pickles["PaiNN"])
        stubs = [m for k, m in sys.modules.items()
                 if k == "schnetpack" or k.startswith("schnetpack.")]
        assert stubs and not any(hasattr(m, "__file__") for m in stubs)
        assert inspect.getmodule(inspect.currentframe()) is not None
    finally:
        _forget_stubs()


def test_field_schnet_with_nuclear_moments(pickles):
    path = pickles["FieldSchNetNMM"]
    model, params, info = timport.import_torch_model(path, device="cpu")
    sd, _ = timport.load_torch_model(path)
    assert info["external_fields"] == ["electric_field", "magnetic_field"]
    nmm = model.representation.nmm_embedding
    np.testing.assert_array_equal(
        nmm.gyromagnetic.weight.detach().numpy(),
        sd["representation.nmm_embedding.gyromagnetic_ratio.weight"])
    np.testing.assert_array_equal(
        nmm.delta.weight.detach().numpy(),
        sd["representation.nmm_embedding.vector_mapping.weight"])
    out = tase.SpkCalculator(model, cutoff=CUTOFF, device="cpu").calculate(
        molecule(4, n=5))
    assert np.isfinite(out["forces"]).all()
    with pytest.raises(KeyError, match="nmm_embedding"):
        jimport.import_torch_model(path)


def test_import_refuses_a_wrong_class_and_an_activation(pickles):
    with pytest.raises(ValueError, match="not a SchNet model"):
        timport.import_schnet(pickles["PaiNN"], device="cpu")
    with pytest.raises(ValueError, match="shifted softplus"):
        timport.import_schnet(pickles["SchNet"], activation="silu",
                              device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            timport.import_torch_model(pickles["SchNet"])
