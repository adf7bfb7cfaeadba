"""Training metric loggers (a copy of ``schnetpack_tpu/train/loggers.py``;
parity: the reference's Lightning logger configs,
``src/schnetpack/configs/logger/{csv,tensorboard,wandb,aim}.yaml``).

All loggers share one protocol: ``log(metrics: dict, step: int)``.  The
WandB and Aim adapters degrade gracefully when their packages are not
installed: they warn once and mirror the metrics into a local JSONL file
so runs keep a machine-readable record either way.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Optional

from .loop import CSVLogger, TensorBoardLogger  # noqa: F401  (re-export)


class _FallbackJSONL:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, metrics: Dict[str, float], step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **metrics}) + "\n")


class WandbLogger:
    """Weights & Biases adapter (reference logger/wandb.yaml).

    Falls back to ``<save_dir>/wandb_offline.jsonl`` when the ``wandb``
    package is unavailable.
    """

    def __init__(self, save_dir: str = ".", project: Optional[str] = None,
                 name: Optional[str] = None, **kwargs):
        try:
            import wandb

            self._run = wandb.init(
                dir=save_dir, project=project or "schnetpack_tpu",
                name=name, **kwargs,
            )
            self._fallback = None
        except ImportError as e:  # package missing -> offline fallback
            warnings.warn(
                f"wandb unavailable ({e!r}); logging metrics to "
                f"{save_dir}/wandb_offline.jsonl instead"
            )
            self._run = None
            self._fallback = _FallbackJSONL(
                os.path.join(save_dir, "wandb_offline.jsonl"))

    def log(self, metrics: Dict[str, float], step: int):
        if self._run is not None:
            self._run.log(dict(metrics), step=step)
        else:
            self._fallback.log(metrics, step)


class AimLogger:
    """Aim adapter (reference logger/aim.yaml).

    Falls back to ``<repo>/aim_offline.jsonl`` when ``aim`` is missing.
    """

    def __init__(self, repo: str = ".", experiment: Optional[str] = None,
                 **kwargs):
        try:
            from aim import Run

            self._run = Run(repo=repo, experiment=experiment, **kwargs)
            self._fallback = None
        except ImportError as e:
            warnings.warn(
                f"aim unavailable ({e!r}); logging metrics to "
                f"{repo}/aim_offline.jsonl instead"
            )
            self._run = None
            self._fallback = _FallbackJSONL(
                os.path.join(repo, "aim_offline.jsonl"))

    def log(self, metrics: Dict[str, float], step: int):
        if self._run is not None:
            for k, v in metrics.items():
                self._run.track(v, name=k, step=step)
        else:
            self._fallback.log(metrics, step)


def build_logger(name: str, run_dir: str, cfg: Optional[Dict] = None):
    """Instantiate a logger by config-group name (see configs/logger/)."""
    cfg = dict(cfg or {})
    cfg.pop("_target_", None)
    if name == "csv":
        return CSVLogger(cfg.get("path", os.path.join(run_dir, "metrics.csv")))
    if name == "tensorboard":
        return TensorBoardLogger(cfg.get("logdir", os.path.join(run_dir, "tb")))
    if name == "wandb":
        cfg.setdefault("save_dir", run_dir)
        return WandbLogger(**cfg)
    if name == "aim":
        cfg.setdefault("repo", run_dir)
        return AimLogger(**cfg)
    raise ValueError(f"unknown logger {name!r}")
