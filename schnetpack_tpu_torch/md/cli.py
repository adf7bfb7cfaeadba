"""spkmd on the port: config-driven MD (parity: ``schnetpack_tpu/md/cli.py``).

Builds the system from a structure file, the calculator (a trained run
directory of the JAX training CLI, an ensemble of them, or any other
``_target_``), the thermostat, barostat and integrator, the trajectory
file and checkpoint hooks, then runs the port's simulator.  The config
groups are the JAX package's (``md_configs/``, the same names, keys and
values, with ``_target_``s naming the port's classes) plus one key,
``device`` (``cuda``, the default, or ``cpu``).

Usage:
    python -m schnetpack_tpu_torch.md.cli system.molecule_file=argon.xyz \\
        calculator.model_dir=<run dir> dynamics=nvt thermostat=langevin \\
        dynamics.n_steps=1000

* The initial momenta draw from a ``torch.Generator`` seeded by ``seed``
  (``system.initializer=null`` keeps them zero).
* With a barostat (``dynamics=npt``, or ``barostat=<name>`` beside any
  dynamics) the integrator is built with it: an NPT integrator as
  configured, and ``VelocityVerlet``/``RingPolymer`` replaced by their
  NPT forms (``cli.py:136-152``).  The JAX CLI builds ``dynamics=npt``'s
  ``NPTVelocityVerlet`` before its barostat exists and fails there
  (``cli.py:103``).
* ``restart=<file>`` loads one of the port's ``Checkpoint`` pickles, and
  the trajectory file is appended to.
* The simulator logs the JAX package's eight keys and, with
  ``calculator=ensemble``, the ensemble's ``energy_uncertainty`` and
  ``forces_uncertainty`` (the JAX CLI logs the eight only).
* ``calculator.neighbor_list`` is the config's ``all_pairs`` (the flat
  layout: molecules, several in one system, or periodic boxes), ``dense``,
  ``cellblock`` (the column layout of one box or molecule, the fused
  kernels) or ``cellblock_atom`` (the 27-cell layout).
* ``dynamics=npt`` with a model calculator needs
  ``calculator.stress_key=stress`` and a run directory whose model has
  ``Forces(calc_stress=True)``, on ``calculator.neighbor_list=all_pairs``.
* ``calculator.precision=bf16`` or ``mixed`` (the reduced-precision
  feature mode, ``ops/precision.py``) runs PaiNN's ``full`` and ``hybrid``
  messages on ``calculator.neighbor_list=cellblock`` in the kernels' bf16
  or mixed instances; it changes nothing on ``all_pairs`` and ``dense``
  and for SchNet on ``cellblock``.  It is refused before the first step
  (``ReducedPrecisionPathError``) on ``cellblock_atom`` and for the other
  column models, where the JAX package's mode rounds the positions.
* ``calculator=orca`` runs the ORCA executable (``calculator.orca_path``)
  on every molecule and replica each step, in ``calculator.working_dir``
  (``md/calculators/orca.py``).
* Refused before the first step: a barostat with a model calculator
  without a stress or on a skin neighbor list.
"""
from __future__ import annotations

import importlib
import os
import pickle
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.compose import Composer, instantiate, save_config

_MD_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "md_configs")


def load_structures(path: str):
    """The structures of an (ext)xyz file as sample dicts; other formats
    need ase, which the port does not use."""
    from .. import properties as structure
    from ..datasets.xyz import read_extxyz_file

    if not path.endswith((".xyz", ".extxyz")):
        raise ValueError(
            f"cannot read structure file {path!r}: the port reads (ext)xyz "
            "only")
    return [{structure.Z: b["numbers"], structure.R: b["positions"],
             structure.cell: b.get("cell", np.zeros((3, 3))),
             structure.pbc: np.array([("cell" in b)] * 3)}
            for b in read_extxyz_file(path)]


def _model_dirs(value) -> List[str]:
    """An ensemble's run directories: a list, or a string ``'[a, b]'``
    whose entries are stripped (the JAX parse, ``md/cli.py:70``, keeps the
    space after a comma)."""
    if isinstance(value, str):
        return [d.strip() for d in value.strip().strip("[]").split(",")
                if d.strip()]
    return list(value)


def build_calculator(cfg: Dict, device="cuda"):
    """The calculator of a ``calculator`` config: ``SchNetPackCalculator``
    or ``EnsembleCalculator`` from run directories (``model_dir``,
    ``model_dirs``) loaded onto ``device``, anything else by
    ``instantiate``."""
    from ..cli import load_model
    from .calculators import EnsembleCalculator, SchNetPackCalculator

    cfg = dict(cfg)
    target = cfg.pop("_target_", "")
    if target.endswith("EnsembleCalculator"):
        return EnsembleCalculator(
            [load_model(d, device)[0]
             for d in _model_dirs(cfg.pop("model_dirs"))], **cfg)
    if target.endswith("SchNetPackCalculator"):
        model, _ = load_model(cfg.pop("model_dir"), device)
        return SchNetPackCalculator(model, **cfg)
    return instantiate(dict(cfg, _target_=target))


def _locate(target: str):
    module, _, name = target.rpartition(".")
    return getattr(importlib.import_module(module), name)


def build_integrator(cfg: Dict, barostat=None):
    """The integrator of ``cfg``, with ``barostat``: an NPT integrator as
    configured, a ``VelocityVerlet``/``RingPolymer`` replaced by its NPT
    form."""
    from .integrators import (
        NPTRingPolymer, NPTVelocityVerlet, RingPolymer, VelocityVerlet,
    )

    cfg = dict(cfg)
    cls = _locate(cfg["_target_"])
    if barostat is None:
        if getattr(cls, "pressure_control", False):
            raise ValueError(f"{cls.__name__} needs a barostat: set "
                             "barostat=<name> or dynamics.barostat")
        return instantiate(cfg)
    if not getattr(cls, "pressure_control", False):
        if issubclass(cls, RingPolymer):
            cfg["_target_"] = (f"{NPTRingPolymer.__module__}."
                               f"{NPTRingPolymer.__name__}")
        elif issubclass(cls, VelocityVerlet):
            cfg["_target_"] = (f"{NPTVelocityVerlet.__module__}."
                               f"{NPTVelocityVerlet.__name__}")
        else:
            raise ValueError(f"no NPT form of {cls.__name__}")
    return instantiate(cfg, barostat=barostat)


def simulate(config: Dict):
    """Run the MD of a composed config; returns the simulator."""
    from . import Simulator, load_molecules
    from .simulator import LOG_KEYS
    from .simulation_hooks import Checkpoint, FileLogger, TensorBoardLoggerMD

    device = config.get("device", "cuda")
    sim_dir = config["simulation_dir"]
    os.makedirs(sim_dir, exist_ok=True)
    save_config(config, os.path.join(sim_dir, "config.yaml"))

    sys_cfg = dict(config["system"])
    dyn = dict(config["dynamics"])
    # top-level groups (thermostat=langevin, barostat=nhc_iso,
    # initializer=uniform) override the dynamics and system presets
    for group, node in (("thermostat", dyn), ("barostat", dyn),
                        ("initializer", sys_cfg)):
        if config.get(group):
            node[group] = config[group]
    barostat = instantiate(dyn["barostat"]) if dyn.get("barostat") else None
    integrator = build_integrator(dyn["integrator"], barostat)
    n_replicas = int(sys_cfg.get("n_replicas", 1))
    if getattr(integrator, "ring_polymer", False):
        n_replicas = integrator.n_beads

    system = load_molecules(
        load_structures(sys_cfg["molecule_file"]), n_replicas=n_replicas,
        position_unit_input=sys_cfg.get("position_unit_input", "Ang"),
        mass_unit_input=sys_cfg.get("mass_unit_input", "Dalton"),
        device=device)
    seed = int(config.get("seed", 42))
    if sys_cfg.get("initializer"):
        system = instantiate(sys_cfg["initializer"]).initialize_system(
            system, torch.Generator().manual_seed(seed))

    calculator = build_calculator(config["calculator"], device)
    hooks: List = []
    if dyn.get("thermostat"):
        hooks.append(instantiate(dyn["thermostat"]))
    if barostat is not None:
        hooks.append(barostat)
    cb = config.get("callbacks") or {}
    if cb.get("file_logger"):
        hooks.append(FileLogger(
            os.path.join(sim_dir, "simulation.hdf5"),
            every_n_steps=int(cb["file_logger"].get("every_n_steps", 1)),
            restart=bool(config.get("restart"))))
    if cb.get("checkpoint"):
        hooks.append(Checkpoint(
            os.path.join(sim_dir, "checkpoint.pkl"),
            every_n_steps=int(cb["checkpoint"].get("every_n_steps", 1000))))
    if cb.get("tensorboard"):
        hooks.append(TensorBoardLoggerMD(os.path.join(sim_dir, "tb")))

    simulator = Simulator(
        system, integrator, calculator, simulator_hooks=hooks, seed=seed,
        log_keys=LOG_KEYS + tuple(getattr(calculator, "property_keys", ())),
        progress=True)
    if config.get("restart"):
        with open(config["restart"], "rb") as f:
            simulator.restart_simulation(pickle.load(f))
    simulator.simulate(int(dyn["n_steps"]),
                       chunk_size=int(dyn.get("chunk_size", 100)))
    return simulator


def main(argv: Optional[List[str]] = None):
    """``spkmd`` on the port; returns the simulator."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return None
    config = Composer([os.getcwd(), _MD_CONFIG_DIR]).compose("config", argv)
    return simulate(config)


if __name__ == "__main__":
    main()
