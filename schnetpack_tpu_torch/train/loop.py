"""Training loop: epochs over loaders, validation, scheduling, logging
(port of ``schnetpack_tpu/train/loop.py``).

The hot path is ``AtomisticTask.train_step``; this loop moves host-side
numpy batches in and aggregated metrics out.  ``profile_dir`` records a
``torch.profiler`` trace (Chrome trace JSON) of the steps in
``profile_steps``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import torch

from .callbacks import ModelCheckpoint
from .lr_scheduler import ReduceLROnPlateau
from .task import AtomisticTask, TrainState, aggregate_metrics


class CSVLogger:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._keys: Optional[List[str]] = None

    def log(self, metrics: Dict[str, float], step: int):
        row = {"step": step, **metrics}
        new_keys = [k for k in row if self._keys is None or k not in self._keys]
        if new_keys:
            # schema grows: late-appearing metrics (val_* on the first
            # validation epoch, epoch_time_s, ...) get columns by rewriting
            # the header and back-filling prior rows with blanks
            old_keys = self._keys or []
            self._keys = old_keys + new_keys
            if old_keys and os.path.exists(self.path):
                with open(self.path) as f:
                    lines = f.read().splitlines()
                pad = "," * len(new_keys)
                with open(self.path, "w") as f:
                    f.write(",".join(self._keys) + "\n")
                    for line in lines[1:]:
                        f.write(line + pad + "\n")
            elif not os.path.exists(self.path):
                with open(self.path, "w") as f:
                    f.write(",".join(self._keys) + "\n")
            else:
                with open(self.path, "a") as f:
                    f.write(",".join(self._keys) + "\n")
        with open(self.path, "a") as f:
            f.write(",".join(str(row.get(k, "")) for k in self._keys) + "\n")


class TensorBoardLogger:
    """TensorBoard scalars through tensorboardX; a no-op where it is not
    installed."""

    def __init__(self, logdir: str):
        try:
            from tensorboardX import SummaryWriter

            self.writer = SummaryWriter(logdir)
        except ImportError:
            self.writer = None

    def log(self, metrics: Dict[str, float], step: int):
        if self.writer is None:
            return
        for k, v in metrics.items():
            self.writer.add_scalar(k, v, step)


class Trainer:
    """Minimal epoch-driven trainer with checkpointing/scheduling/logging."""

    def __init__(
        self,
        max_epochs: int = 100,
        log_dir: str = "runs/default",
        scheduler: Optional[ReduceLROnPlateau] = None,
        scheduler_monitor: str = "val_loss",
        checkpoint: Optional[ModelCheckpoint] = None,
        loggers: Optional[List] = None,
        log_every_n_steps: int = 50,
        val_every_n_epochs: int = 1,
        early_stopping_patience: Optional[int] = None,
        progress: bool = True,
        profile_dir: Optional[str] = None,
        profile_steps: tuple = (10, 20),
    ):
        self.max_epochs = max_epochs
        self.log_dir = log_dir
        self.scheduler = scheduler
        self.scheduler_monitor = scheduler_monitor
        self.checkpoint = checkpoint or ModelCheckpoint(os.path.join(log_dir, "checkpoints"))
        self.loggers = loggers if loggers is not None else [CSVLogger(os.path.join(log_dir, "metrics.csv"))]
        self.log_every_n_steps = log_every_n_steps
        self.val_every_n_epochs = val_every_n_epochs
        self.early_stopping_patience = early_stopping_patience
        self.progress = progress
        # torch.profiler trace window over the steps in profile_steps
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps

    def _log(self, metrics, step):
        for lg in self.loggers:
            lg.log(metrics, step)

    def fit(
        self,
        task: AtomisticTask,
        state: TrainState,
        train_loader,
        val_loader=None,
        resume: bool = False,
    ) -> TrainState:
        start_epoch = 0
        if resume:
            ckpt = self.checkpoint.load_checkpoint("last.ckpt")
            if ckpt is not None:
                state.load_state_dict(ckpt["state"])
                self.checkpoint.best = ckpt.get("best")
                start_epoch = int(ckpt.get("epoch", 0))
                if self.scheduler is not None and "scheduler" in ckpt:
                    self.scheduler.load_state_dict(ckpt["scheduler"])

        bad_epochs = 0
        best_val = None
        prof = None
        for epoch in range(start_epoch, self.max_epochs):
            t0 = time.time()
            train_metrics = []
            for batch in train_loader:
                state, m = task.train_step(state, batch)
                train_metrics.append(m)
                step = int(state.step)
                if self.profile_dir and step == self.profile_steps[0]:
                    prof = torch.profiler.profile()
                    prof.__enter__()
                elif prof is not None and step == self.profile_steps[1]:
                    prof.__exit__(None, None, None)
                    os.makedirs(self.profile_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(
                        self.profile_dir, f"trace_step{step}.json"))
                    prof = None
                if step % self.log_every_n_steps == 0:
                    self._log(aggregate_metrics(train_metrics[-self.log_every_n_steps:]), step)

            epoch_metrics = aggregate_metrics(train_metrics)

            if val_loader is not None and (epoch + 1) % self.val_every_n_epochs == 0:
                val_metrics = []
                params = task.eval_params(state)
                for batch in val_loader:
                    val_metrics.append(task.eval_step(params, batch, "val"))
                epoch_metrics.update(aggregate_metrics(val_metrics))

                monitored = epoch_metrics.get(self.scheduler_monitor)
                if self.scheduler is not None and monitored is not None:
                    state.lr_scale = self.scheduler.step(monitored,
                                                         task.learning_rate)
                extra = {
                    "epoch": epoch + 1,
                    "scheduler": self.scheduler.state_dict() if self.scheduler else None,
                }
                self.checkpoint.on_validation_end(task, state, epoch_metrics, extra)

                if self.early_stopping_patience and monitored is not None:
                    if best_val is None or monitored < best_val:
                        best_val = monitored
                        bad_epochs = 0
                    else:
                        bad_epochs += 1
                        if bad_epochs >= self.early_stopping_patience:
                            break

            epoch_metrics["epoch_time_s"] = time.time() - t0
            self._log(epoch_metrics, int(state.step))
            if self.progress:
                brief = {k: round(v, 6) for k, v in epoch_metrics.items() if "loss" in k or "mae" in k}
                print(f"epoch {epoch + 1}/{self.max_epochs} {json.dumps(brief)}", flush=True)
        return state

    def test(self, task: AtomisticTask, state: TrainState, test_loader) -> Dict[str, float]:
        params = task.eval_params(state)
        ms = [task.eval_step(params, b, "test") for b in test_loader]
        metrics = aggregate_metrics(ms)
        self._log(metrics, int(state.step))
        return metrics
