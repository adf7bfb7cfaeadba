"""Training callbacks: checkpoints, the best model's export and the
prediction writer (port of ``schnetpack_tpu/train/callbacks.py``).

``best_model`` is the JAX package's format, a pickle of the flax parameter
tree as numpy arrays (``callbacks.py:18-27``), made by
``convert.params_to_jax``: a run directory that the port trains loads in
the port's ``cli.load_model`` and in the JAX package's.  ``last.ckpt`` and
``best.ckpt`` are the port's own (``torch.save`` of the training state,
the best metric, the epoch and the scheduler); the JAX package's
checkpoints hold optax's state, which the port does not resume.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch


def save_pytree(path: str, tree: Any) -> None:
    """Pickle a tree of arrays (tensors become numpy arrays)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)
    with open(path, "wb") as f:
        pickle.dump(host(tree), f)


def load_pytree(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


class ModelCheckpoint:
    """Tracks a monitored metric; keeps the last and best training states
    and exports the evaluation parameters (the EMA copy where there is
    one) as ``best_model`` at every improvement (``callbacks.py:30-77``)."""

    def __init__(self, dirpath: str, monitor: str = "val_loss",
                 mode: str = "min", model_path: Optional[str] = None,
                 save_last: bool = True, writes: bool = True):
        self.dirpath = dirpath
        self.monitor = monitor
        self.mode = mode
        self.model_path = model_path or os.path.join(dirpath,
                                                     "best_inference_model")
        self.save_last = save_last
        #: False on the ranks of a data-parallel run but the first: they
        #: track the best metric and read checkpoints, and write nothing
        self.writes = writes
        self.best: Optional[float] = None
        if writes:
            os.makedirs(dirpath, exist_ok=True)

    def _is_better(self, v: float) -> bool:
        if self.best is None:
            return True
        return v < self.best if self.mode == "min" else v > self.best

    def on_validation_end(self, task, state, metrics: Dict[str, float],
                          extra: Optional[Dict] = None):
        if self.save_last and self.writes:
            self.save_checkpoint(task, state, "last.ckpt", extra)
        v = metrics.get(self.monitor)
        if v is not None and self._is_better(v):
            self.best = v
            if self.writes:
                self.save_checkpoint(task, state, "best.ckpt", extra)
                self.export(task, state)
        return self.best

    def export(self, task, state) -> None:
        """``best_model``: the evaluation parameters as the flax tree."""
        from ..convert import params_to_jax

        save_pytree(self.model_path,
                    params_to_jax(task.model, task.eval_params(state)))

    def save_checkpoint(self, task, state, name: str,
                        extra: Optional[Dict] = None):
        payload = {"state": state.state_dict(), "best": self.best}
        if extra:
            payload.update(extra)
        path = os.path.join(self.dirpath, name)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)

    def load_checkpoint(self, name: str = "last.ckpt"):
        path = os.path.join(self.dirpath, name)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location="cpu", weights_only=False)


class PredictionWriter:
    """Writes predictions per batch (or per epoch) as pickles of numpy
    arrays (``callbacks.py:80-102``)."""

    def __init__(self, output_dir: str, write_interval: str = "batch"):
        self.output_dir = output_dir
        self.write_interval = write_interval
        self._epoch_buffer = []
        os.makedirs(output_dir, exist_ok=True)

    def write_batch(self, predictions: Dict, batch_idx: int):
        host = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in predictions.items()}
        if self.write_interval == "batch":
            with open(os.path.join(self.output_dir,
                                   f"batch_{batch_idx}.pkl"), "wb") as f:
                pickle.dump(host, f)
        else:
            self._epoch_buffer.append(host)

    def write_epoch(self, epoch: int):
        if self._epoch_buffer:
            with open(os.path.join(self.output_dir, f"epoch_{epoch}.pkl"),
                      "wb") as f:
                pickle.dump(self._epoch_buffer, f)
            self._epoch_buffer = []
