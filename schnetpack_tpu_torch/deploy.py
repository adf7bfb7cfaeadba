"""spkdeploy / spkconvert on the port (parity: ``schnetpack_tpu/deploy.py``).

The deployed artifact is the JAX package's format: one pickle with
``"format": "schnetpack_tpu.deploy/1"``, the model config with the JAX
package's target names, the flax parameter tree as numpy arrays (a run
directory's ``best_model``), ``cutoff`` and ``model_outputs``.  Run
directories are that format on both sides (the port's ``spktrain`` writes
them through ``convert.params_to_jax``), so an artifact deployed by
either package loads in the other.

``export_program=true`` (the counterpart of the JAX package's
``export_stablehlo=true``) adds a ``torch.export`` program of the
energy-and-forces function at the JAX export's two-atom example batch
(``deploy.py:61-80``), exported on ``device``, under ``torch_program``
(the bytes of ``torch.export.save``) with its example shapes
(``torch_program_example_shapes``); ``load_program`` reads it back.
``torch.export`` cannot trace ``torch.autograd.grad`` inside a forward,
so the function (energy, forces = -dE/dR of the weights' closure) is first
traced by ``make_fx``, which records the backward's operations, and the
traced graph is exported.

Usage:
    python -m schnetpack_tpu_torch.deploy deploy model_dir=<run dir> \\
        out=model.spk [per_atom_energy=true] [export_program=true] \\
        [device=cuda]
    python -m schnetpack_tpu_torch.deploy convert datapath=<db> \\
        distance_unit=Ang property_units="energy:eV,forces:eV/Ang"
"""
from __future__ import annotations

import io
import os
import pickle
import sys
from typing import Dict, Optional

import numpy as np
import torch

FORMAT = "schnetpack_tpu.deploy/1"


def _example_batch(cutoff: float, device) -> Dict[str, torch.Tensor]:
    """The JAX export's example: two H atoms 1 A apart, padded to
    ``PaddingSpec(16, 64, 2)``."""
    from . import properties as P
    from .data.loader import PaddingSpec, collate
    from .transform.neighborlist import NeighborListTransform

    sample = {
        P.Z: np.array([1, 1]), P.R: np.zeros((2, 3)),
        P.cell: np.zeros((3, 3)), P.pbc: np.zeros(3, bool),
    }
    sample[P.R][1, 0] = 1.0
    sample = NeighborListTransform(cutoff)(sample)
    batch = collate([sample], PaddingSpec(16, 64, 2))
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def energy_and_forces(model, energy_key: str = "energy"):
    """f(batch) -> (energy [M], forces [A, 3]) of a frozen ``model``:
    forces -dE/dR of the heads' energy (``energy_outputs``), masked to the
    real atoms."""
    from . import properties as P

    def f(batch):
        with torch.enable_grad():
            R = batch[P.R].detach().requires_grad_(True)
            out = model.energy_outputs({**batch, P.R: R})
            E = out[energy_key]
            (g,) = torch.autograd.grad(
                (E * batch[P.mol_mask]).sum(), R)
        return E.detach(), -g * batch[P.atom_mask][:, None]
    return f


def export_energy_program(model, cutoff: float, device,
                          energy_key: str = "energy"):
    """(bytes of ``torch.export.save``, example shapes) of the
    energy-and-forces function of ``model`` on ``device`` at the example
    batch (see the module's docstring)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    model = model.to(device).requires_grad_(False)
    batch = _example_batch(cutoff, device)
    traced = make_fx(energy_and_forces(model, energy_key))(batch)
    program = torch.export.export(traced, (batch,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue(), {k: tuple(v.shape) for k, v in batch.items()}


def load_program(artifact: Dict):
    """The exported program of an artifact (``export_program=true``) as a
    callable f(batch) -> (energy, forces)."""
    if "torch_program" not in artifact:
        raise KeyError("the artifact holds no torch_program: deploy it "
                       "with export_program=true")
    return torch.export.load(io.BytesIO(artifact["torch_program"])).module()


def deploy(
    model_dir: str,
    out: str,
    cutoff: Optional[float] = None,
    per_atom_energy: bool = True,
    export_program: bool = False,
    device="cuda",
):
    """Write the artifact of the run directory ``model_dir`` to ``out``
    (see the module's docstring); the model is built on ``device`` (the
    card unless the caller asks for the CPU) to check the config and, with
    ``export_program``, to export there."""
    from .cli import model_from_config
    from .convert import load_jax_params

    with open(os.path.join(model_dir, "model_config.pkl"), "rb") as f:
        model_cfg = pickle.load(f)

    # per-atom energies for spatial-decomposition consumers (LAMMPS)
    if per_atom_energy:
        for om in model_cfg.get("output_modules", []):
            if isinstance(om, dict) and om.get("_target_", "").endswith("Atomwise"):
                om.setdefault("per_atom_output_key", "energy_per_atom")

    params = load_jax_params(os.path.join(model_dir, "best_model"))
    model, _ = model_from_config(model_cfg, params, device)

    if cutoff is None:
        cutoff = float(model_cfg.get("representation", {}).get("cutoff", 5.0))

    artifact: Dict = {
        "format": FORMAT,
        "model_config": model_cfg,
        "params": params,
        "cutoff": cutoff,
        "model_outputs": model.model_outputs,
    }
    if export_program:
        (artifact["torch_program"],
         artifact["torch_program_example_shapes"]) = export_energy_program(
            model, cutoff, device)

    with open(out, "wb") as f:
        pickle.dump(artifact, f)
    print(f"deployed {model_dir} -> {out} (cutoff={cutoff})")


def load_deployed(path: str, device="cuda"):
    """(model on ``device``, state dict, artifact) of a deployed artifact;
    the card unless the caller asks for the CPU."""
    from .cli import model_from_config

    with open(path, "rb") as f:
        artifact = pickle.load(f)
    if artifact.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} artifact "
                         f"({artifact.get('format')!r})")
    model, params = model_from_config(artifact["model_config"],
                                      artifact["params"], device)
    return model, params, artifact


def convert(datapath: str, distance_unit: Optional[str] = None,
            property_units: Optional[str] = None, atomrefs_file: Optional[str] = None):
    """Set metadata on a legacy ASE DB (parity: spkconvert)."""
    from .data.atoms import ASEAtomsData

    ds = ASEAtomsData(datapath)
    md = {}
    if distance_unit:
        md["_distance_unit"] = distance_unit
    if property_units:
        units = dict(kv.split(":") for kv in property_units.split(","))
        old = ds.metadata.get("_property_unit_dict", {})
        old.update(units)
        md["_property_unit_dict"] = old
    if atomrefs_file:
        refs = dict(np.load(atomrefs_file))
        md["atomrefs"] = {k: np.asarray(v).tolist() for k, v in refs.items()}
    ds.update_metadata(**md)
    print(f"updated metadata of {datapath}: {list(md)}")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return
    command, kv = argv[0], dict(a.split("=", 1) for a in argv[1:])
    if command == "deploy":
        if kv.get("export_stablehlo", "false").lower() == "true":
            raise SystemExit(
                "export_stablehlo=true: the port exports no StableHLO; "
                "export_program=true stores a torch.export program")
        deploy(
            kv["model_dir"], kv.get("out", "deployed_model.spk"),
            cutoff=float(kv["cutoff"]) if "cutoff" in kv else None,
            per_atom_energy=kv.get("per_atom_energy", "true").lower() == "true",
            export_program=kv.get("export_program", "false").lower() == "true",
            device=kv.get("device", "cuda"),
        )
    elif command == "convert":
        convert(kv["datapath"], kv.get("distance_unit"),
                kv.get("property_units"), kv.get("atomrefs_file"))
    else:
        raise SystemExit(f"unknown command {command}; use deploy|convert")


if __name__ == "__main__":
    main()
