"""ReduceLROnPlateau with exponential smoothing of the monitored metric (a
copy of ``schnetpack_tpu/train/lr_scheduler.py``; parity:
``src/schnetpack/train/lr_scheduler.py:6-80``).

Host-side logic: call ``step(metric)`` once per validation epoch; apply the
returned factor to ``TrainState.lr_scale``.
"""
from __future__ import annotations

import math
from typing import Optional


class ReduceLROnPlateau:
    def __init__(
        self,
        factor: float = 0.5,
        patience: int = 10,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
        cooldown: int = 0,
        min_lr: float = 0.0,
        smoothing_factor: float = 0.0,
        mode: str = "min",
    ):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.smoothing_factor = smoothing_factor
        self.mode = mode

        self.best: Optional[float] = None
        self.smoothed: Optional[float] = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.scale = 1.0

    def _is_better(self, a: float, best: float) -> bool:
        if self.threshold_mode == "rel":
            eps = 1.0 - self.threshold if self.mode == "min" else 1.0 + self.threshold
            return a < best * eps if self.mode == "min" else a > best * eps
        delta = self.threshold
        return a < best - delta if self.mode == "min" else a > best + delta

    def step(self, metric: float, base_lr: float = 1.0) -> float:
        """Update with the epoch's monitored metric; returns the current
        multiplicative LR scale."""
        if self.smoothing_factor > 0.0 and self.smoothed is not None:
            metric = (
                self.smoothing_factor * self.smoothed
                + (1.0 - self.smoothing_factor) * metric
            )
        self.smoothed = metric

        if self.best is None or self._is_better(metric, self.best):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            new_scale = self.scale * self.factor
            if base_lr * new_scale >= self.min_lr:
                self.scale = new_scale
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.scale

    def state_dict(self):
        return {
            "best": self.best,
            "smoothed": self.smoothed,
            "num_bad_epochs": self.num_bad_epochs,
            "cooldown_counter": self.cooldown_counter,
            "scale": self.scale,
        }

    def load_state_dict(self, d):
        for k, v in d.items():
            setattr(self, k, v)
