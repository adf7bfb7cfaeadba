"""Training and prediction CLIs on the port (parity:
``schnetpack_tpu/cli.py``), and the run directories they write.

``spktrain`` composes the config tree of ``configs/`` (the JAX package's
groups, keys and values, with ``_target_``s naming the port's classes,
and one more key, ``device``: ``cuda``, the default, or ``cpu``), with
``experiment=...`` overlays and dotted overrides; resumes from
``checkpoints/last.ckpt`` where the run directory has one; seeds numpy and
torch; builds the data module, the model, the task and the trainer; fits,
tests and writes the run directory.  ``spkpredict`` runs a run
directory's model over its data module's test split and writes the
predictions.  ``trainer.devices`` > 1 raises: the port trains on one card
(ROADMAP Queue 1 item 9).

Usage:
    python -m schnetpack_tpu_torch.cli train experiment=md17 \
        data.raw_dir=<dir holding md17_aspirin.npz> device=cuda
    python -m schnetpack_tpu_torch.cli predict model_dir=<run dir>

A run directory is the JAX training CLI's format (``cli.py:145-147``,
``train/callbacks.py:18-27``): ``model_config.pkl``, the resolved
``model`` config whose ``_target_``s name ``schnetpack_tpu`` classes, and
``best_model``, a pickle of the flax parameter tree as numpy arrays.  The
port writes its model config with the JAX names (``jax_targets``, the
reverse of ``TARGETS``) and its weights through
``convert.params_to_jax``, and builds the model it trains from that same
config, so that the port's ``load_model`` and the JAX package's read a
port-trained run directory, as ``spkmd`` does.

``load_model`` maps each JAX target to the port's class through
``TARGETS``, an explicit table (an unknown target raises with its name),
and loads the weights through ``convert.params_from_jax``.  A head
(``Atomwise``, ``DipoleMoment``, ``Polarizability``) without ``n_in``
takes the representation's width, which flax infers.  A
``PairwiseDistances`` skips the column layout where the representation
there reads the positions only (``reads_column_rij``), so a model from
the JAX configs, which list it for every representation, launches no
gather it does not need.
"""
from __future__ import annotations

import os
import pickle
import random
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .atomistic import (
    Aggregation, Atomwise, CoulombPotential, DampedCoulombPotential,
    DipoleMoment, EnergyCoulomb, EnergyEwald, FilterShortRange, Forces,
    PairwiseDistances, Polarizability, Response, StaticExternalFields,
    Strain, ZBLRepulsionEnergy,
)
from .config.compose import (
    Composer, _parse_value, _set_dotted, instantiate, save_config,
)
from .config import miniyaml
from .convert import load_jax_params, params_from_jax
from .model import NeuralNetworkPotential
from .nn import (
    BesselRBF, CosineCutoff, GaussianRBF, GaussianRBFCentered,
    MollifierCutoff,
)
from .representation import FieldSchNet, PaiNN, SchNet, SO3net
from .transform import AddOffsets, CastTo32, CastTo64

_PKG_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs")


def _potential(ctx, representation, input_modules=(), output_modules=(),
               postprocessors=(), do_postprocessing=True):
    rep = _build(representation, ctx)
    ctx = dict(ctx, n_in=getattr(rep, "n_atom_basis", None),
               columns=getattr(rep, "reads_column_rij", True))
    outputs = [m for m in (_build(c, ctx) for c in output_modules)
               if m is not None]
    return NeuralNetworkPotential(
        rep, outputs, input_modules=[_build(c, ctx) for c in input_modules],
        postprocessors=[_build(c, ctx) for c in postprocessors],
        do_postprocessing=do_postprocessing)


def _head(cls) -> Callable:
    """A head that takes the representation's width as ``n_in`` unless the
    config gives one (flax infers it)."""
    def make(ctx, **kwargs):
        kwargs.setdefault("n_in", ctx.get("n_in"))
        return cls(**kwargs)
    return make


def _forces(ctx, calc_forces=True, calc_stress=False, **kwargs):
    if not (calc_forces or calc_stress):
        return None
    return Forces(calc_forces=calc_forces, calc_stress=calc_stress, **kwargs)


def _distances(ctx, **kwargs):
    return PairwiseDistances(columns=ctx.get("columns", True), **kwargs)


def _plain(cls) -> Callable:
    return lambda ctx, **kwargs: cls(**kwargs)


def _targets() -> Dict[str, Callable]:
    table = {
        "model.NeuralNetworkPotential": _potential,
        "model.base.NeuralNetworkPotential": _potential,
        "atomistic.Forces": _forces,
        "atomistic.response.Forces": _forces,
        "atomistic.PairwiseDistances": _distances,
        "atomistic.distances.PairwiseDistances": _distances,
    }
    for name, cls in [("Atomwise", Atomwise), ("DipoleMoment", DipoleMoment),
                      ("Polarizability", Polarizability)]:
        for path in (f"atomistic.{name}", f"atomistic.atomwise.{name}"):
            table[path] = _head(cls)
    for name, module, cls in [
            ("Aggregation", "atomistic.atomwise", Aggregation),
            ("Response", "atomistic.response", Response),
            ("StaticExternalFields", "atomistic.response",
             StaticExternalFields),
            ("Strain", "atomistic.response", Strain),
            ("FilterShortRange", "atomistic.distances", FilterShortRange),
            ("CoulombPotential", "atomistic.electrostatic", CoulombPotential),
            ("DampedCoulombPotential", "atomistic.electrostatic",
             DampedCoulombPotential),
            ("EnergyCoulomb", "atomistic.electrostatic", EnergyCoulomb),
            ("EnergyEwald", "atomistic.electrostatic", EnergyEwald),
            ("ZBLRepulsionEnergy", "atomistic.nuclear_repulsion",
             ZBLRepulsionEnergy),
            ("PaiNN", "representation.painn", PaiNN),
            ("SchNet", "representation.schnet", SchNet),
            ("SO3net", "representation.so3net", SO3net),
            ("FieldSchNet", "representation.field_schnet", FieldSchNet),
            ("GaussianRBF", "nn.radial", GaussianRBF),
            ("GaussianRBFCentered", "nn.radial", GaussianRBFCentered),
            ("BesselRBF", "nn.radial", BesselRBF),
            ("CosineCutoff", "nn.cutoff", CosineCutoff),
            ("MollifierCutoff", "nn.cutoff", MollifierCutoff),
            ("AddOffsets", "transform.atomistic", AddOffsets),
            ("CastTo32", "transform.casting", CastTo32),
            ("CastTo64", "transform.casting", CastTo64)]:
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
    return model.to(_device(device)), params


def _device(device) -> torch.device:
    """``device`` as a torch device; ``cuda`` without a card raises (the
    CPU is used only where it is asked for)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device=cpu to "
            "run on the CPU")
    return device


def jax_targets(node: Any) -> Any:
    """A config with every ``schnetpack_tpu_torch.*`` target renamed to the
    JAX package's, each one checked against ``TARGETS`` (the model config
    of a run directory)."""
    if isinstance(node, list):
        return [jax_targets(v) for v in node]
    if not isinstance(node, dict):
        return node
    out = {k: jax_targets(v) for k, v in node.items()}
    target = out.get("_target_")
    if target is not None:
        if target.startswith("schnetpack_tpu_torch."):
            target = "schnetpack_tpu." + target[len("schnetpack_tpu_torch."):]
        if target not in TARGETS:
            raise ValueError(f"model config: no JAX counterpart of the "
                             f"target {node['_target_']!r}")
        out["_target_"] = target
    return out


def default_composer() -> Composer:
    """The search path: CWD, CWD/configs, the package's configs."""
    return Composer([os.getcwd(), os.path.join(os.getcwd(), "configs"),
                     _PKG_CONFIG_DIR])


def _seed_everything(seed: int):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def build_task(config: Dict, model):
    """(AtomisticTask, ReduceLROnPlateau or None) of the ``task`` config;
    the ``callbacks.ema`` group sets the EMA decay."""
    from .train import AtomisticTask, ReduceLROnPlateau

    task_cfg = dict(config.get("task", {}))
    scheduler_cfg = task_cfg.pop("scheduler", None)
    outputs = instantiate(task_cfg.pop("outputs", []))
    cb = config.get("callbacks", {}) or {}
    if isinstance(cb.get("ema"), dict) and task_cfg.get("ema_decay") is None:
        task_cfg["ema_decay"] = cb["ema"].get("decay", 0.995)
    task = AtomisticTask(model, outputs=outputs, **{
        k: v for k, v in task_cfg.items()
        if not isinstance(v, dict) or k == "optimizer_args"})
    scheduler = ReduceLROnPlateau(**scheduler_cfg) if scheduler_cfg else None
    return task, scheduler


def _n_devices(trainer_cfg: Dict, device: torch.device) -> int:
    n = int(trainer_cfg.get("devices", 1) or 1)
    if n == -1:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n > 1:
        raise NotImplementedError(
            f"trainer.devices={n}: the port trains on one card; data-parallel "
            "training is ROADMAP Queue 1 item 9")
    return n


def train(config: Dict) -> Dict[str, float]:
    """``spktrain``: fit, test with the final evaluation parameters, and
    write the run directory; returns the test metrics."""
    return fit(config)[0]


def fit(config: Dict):
    """``train``'s work; returns (test metrics, task, final state, data
    module), the trained model being ``task.model``."""
    from .train import ModelCheckpoint, Trainer
    from .train.loggers import build_logger

    device = _device(config.get("device", "cuda"))
    trainer_cfg = dict(config.get("trainer", {}))
    trainer_cfg.pop("_target_", None)
    _n_devices(trainer_cfg, device)
    run = config.get("run", {})
    run_dir = os.path.join(run.get("path", "runs"), str(run.get("id", "run")))
    os.makedirs(run_dir, exist_ok=True)
    cfg_path = os.path.join(run_dir, "config.yaml")
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    resume = os.path.exists(cfg_path) and os.path.exists(
        os.path.join(ckpt_dir, "last.ckpt"))
    save_config(config, cfg_path)

    seed = int(config.get("globals", {}).get("seed", 42))
    _seed_everything(seed)
    dm = instantiate(config["data"])
    dm.setup()
    model_cfg = jax_targets(config["model"])
    model = _build(model_cfg, {}).to(device)
    for t in list(dm.train_transforms):
        if hasattr(t, "datamodule"):
            t.datamodule(dm)
    task, scheduler = build_task(config, model)
    state = task.create_state()

    cb = config.get("callbacks", {}) or {}
    monitor = (cb.get("checkpoint") or {}).get("monitor", "val_loss")
    if isinstance(cb.get("early_stopping"), dict):
        trainer_cfg.setdefault("early_stopping_patience",
                               cb["early_stopping"].get("patience"))
    logger_cfg = config.get("logger")
    if isinstance(logger_cfg, dict) and logger_cfg:
        loggers = [build_logger(name, run_dir, lcfg)
                   for name, lcfg in logger_cfg.items()]
    else:
        loggers = [build_logger(name, run_dir)
                   for name in cb.get("loggers", ["csv"])]
    model_path = os.path.join(run_dir, config.get("globals", {}).get(
        "model_path", "best_model"))
    trainer = Trainer(
        log_dir=run_dir, scheduler=scheduler, scheduler_monitor=monitor,
        checkpoint=ModelCheckpoint(ckpt_dir, monitor=monitor,
                                   model_path=model_path),
        loggers=loggers,
        **{k: v for k, v in trainer_cfg.items() if k in (
            "max_epochs", "log_every_n_steps", "val_every_n_epochs",
            "early_stopping_patience", "progress")})
    state = trainer.fit(task, state, dm.train_dataloader(),
                        dm.val_dataloader(), resume=resume)
    metrics = trainer.test(task, state, dm.test_dataloader())
    print({k: round(v, 6) for k, v in metrics.items()})
    with open(os.path.join(run_dir, "model_config.pkl"), "wb") as f:
        pickle.dump(model_cfg, f)
    return metrics, task, state, dm


def predict(config: Dict) -> str:
    """``spkpredict``: the run directory's model over the test split of its
    data module; writes ``predictions/batch_<i>.pkl`` and returns that
    directory."""
    from .train import PredictionWriter, as_tensors

    device = _device(config.get("device", "cuda"))
    model_dir = config["model_dir"]
    model, _ = load_model(model_dir, device)
    dm = instantiate(config["data"])
    dm.setup()
    out_dir = os.path.join(model_dir, "predictions")
    writer = PredictionWriter(out_dir)
    with torch.no_grad():
        for i, batch in enumerate(dm.test_dataloader()):
            out = model(as_tensors(batch, device))
            keep = {k: out[k] for k in model.model_outputs if k in out}
            keep["_idx"] = batch.get("_idx")
            writer.write_batch(keep, i)
    print(f"predictions written to {out_dir}")
    return out_dir


def main(argv: Optional[List[str]] = None):
    """``spktrain`` (``train ...``) and ``spkpredict`` (``predict
    model_dir=... ...``); returns the test metrics or the predictions'
    directory."""
    argv = list(sys.argv[1:] if argv is None else argv)
    prog = os.path.basename(sys.argv[0]) if sys.argv else ""
    implied = {"spktrain": "train", "spkpredict": "predict"}.get(prog)
    if implied:
        argv = [implied] + argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return None
    command, overrides = argv[0], argv[1:]
    if command == "train":
        config = default_composer().compose("train", overrides)
        if config.get("print_config"):
            print(miniyaml.dumps(config))
        return train(config)
    if command == "predict":
        kv = dict(o.split("=", 1) for o in overrides)
        model_dir = kv.pop("model_dir")
        config = miniyaml.load(os.path.join(model_dir, "config.yaml"))
        for k, v in kv.items():
            _set_dotted(config, k, _parse_value(v))
        config["model_dir"] = model_dir
        return predict(config)
    raise SystemExit(f"unknown command {command!r}; use train|predict")


if __name__ == "__main__":
    main()
