"""Training task: model outputs, losses, and the train and eval steps (port
of ``schnetpack_tpu/train/task.py``).

``AtomisticTask.train_step`` takes the gradient of the weighted sum of the
outputs' losses with respect to every parameter of the model (through the
forces' graph, ``model/base.py``), then updates the parameters in place
with optax's semantics, written out in plain torch (``task.py:176-252``):

* the chain ``clip_by_global_norm`` (updates scaled by max_norm / ||g||
  where ||g|| >= max_norm; no epsilon) -> the optimizer -> the learning
  rate, as ``torch._foreach_*`` operations over all leaves at once;
* ``adamw`` (``scale_by_adam``, then ``weight_decay * params`` added, the
  task's default decay 0.0), ``adam``, ``sgd`` (``trace``: momentum
  accumulates g + momentum * trace, optional Nesterov) and ``adabelief``
  (``scale_by_belief``: nu tracks (g - mu)^2 plus eps_root, with eps =
  eps_root = 1e-16 by default);
* the learning rate of update n (counted from 0) is ``learning_rate *
  min(n / warmup_steps, 1)``: with a warm-up the first update is 0;
* the plateau multiplier ``lr_scale`` scales the whole update, weight
  decay included;
* the EMA copy follows the parameters after each update, and evaluation
  reads it (``eval_params``).

The step also sets ``requires_grad`` on every parameter, which undoes the
freeze of an MD calculator that held the model before
(``md/calculators/schnetpack_calculator.py``).  Batches arrive as numpy
dicts from the loader and move to the model's device in ``as_tensors``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import properties
from .metrics import METRICS, finalize_metric


def as_tensors(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: the one place where a batch
    moves to the device."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))).to(device, non_blocking=True)
        for k, v in batch.items()}


def _mask_for(pred: torch.Tensor, batch: Dict[str, torch.Tensor]):
    """The validity mask matching the leading axis of ``pred``."""
    A = batch[properties.Z].shape[0]
    M = batch[properties.n_atoms].shape[0]
    if pred.ndim >= 1 and pred.shape[0] == A:
        return batch[properties.atom_mask]
    if pred.ndim >= 1 and pred.shape[0] == M:
        return batch[properties.mol_mask]
    return pred.new_ones(pred.shape[:1])


def _masked(err: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor):
    m = mask.reshape(mask.shape + (1,) * (pred.ndim - mask.ndim))
    n = torch.clamp(m.sum() * float(pred.numel() // max(pred.shape[0], 1)),
                    min=1.0)
    return (err * m).sum() / n


def _huber(pred, target, delta: float = 1.0):
    """``optax.huber_loss``: 0.5 q^2 + delta (|e| - q) with q = min(|e|,
    delta)."""
    abs_err = (pred - target).abs()
    quadratic = torch.clamp(abs_err, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_err - quadratic)


LOSSES: Dict[str, Callable] = {
    "mse": lambda p, t, m: _masked((p - t).square(), p, m),
    "mae": lambda p, t, m: _masked((p - t).abs(), p, m),
    "huber": lambda p, t, m, delta=1.0: _masked(_huber(p, t, delta), p, m),
}


class ConsiderOnlySelectedAtoms:
    """Constraint restricting loss and metrics to selected atoms;
    ``selection_name`` keys a [A]-shaped 0/1 array in the batch."""

    def __init__(self, selection_name: str):
        self.selection_name = selection_name

    def __call__(self, pred, target, mask, batch):
        return pred, target, mask * batch[self.selection_name].to(mask.dtype)


@dataclasses.dataclass
class ModelOutput:
    """One supervised output head (``task.py:79-125``)."""

    name: str
    target_property: Optional[str] = None
    loss_fn: str = "mse"
    loss_weight: float = 1.0
    metrics: Sequence[str] = ("mae",)
    constraints: Sequence = ()

    @property
    def target(self) -> str:
        return self.target_property or self.name

    def _target(self, pred, batch):
        target = batch[self.target].to(pred.dtype)
        if target.shape != pred.shape:
            # never let pred and target broadcast: an [M, 1] target against
            # an [M] prediction forms an [M, M] error matrix
            raise ValueError(
                f"output '{self.name}': prediction shape {tuple(pred.shape)}"
                f" != target '{self.target}' shape {tuple(target.shape)}")
        return target

    def _selected(self, outputs, batch):
        pred = outputs[self.name]
        if pred is batch.get(self.target):
            # the outputs dict carries the batch's entries: a model without
            # this output would be scored on the label itself (loss 0)
            raise ValueError(
                f"output '{self.name}': the model does not compute it (its "
                "outputs hold the batch's own label)")
        target = self._target(pred, batch)
        mask = _mask_for(pred, batch)
        for c in self.constraints:
            pred, target, mask = c(pred, target, mask, batch)
        return pred, target, mask

    def loss(self, outputs, batch):
        return self.loss_weight * LOSSES[self.loss_fn](
            *self._selected(outputs, batch))

    def metric_sums(self, outputs, batch, prefix: str):
        pred, target, mask = self._selected(outputs, batch)
        return {f"{prefix}_{self.name}_{m}": METRICS[m](pred, target, mask)
                for m in self.metrics}


@dataclasses.dataclass
class UnsupervisedModelOutput(ModelOutput):
    """Label-free loss term, e.g. a regularizer (``task.py:127-145``)."""

    def _selected(self, outputs, batch):
        pred = outputs[self.name]
        return pred, torch.zeros_like(pred), _mask_for(pred, batch)


@dataclasses.dataclass
class TrainState:
    """The training state: ``params`` are the model's own parameters by
    name (updated in place), ``opt_state`` the optimizer's moments by
    name, ``ema_params`` the EMA copy, ``step`` the number of updates
    taken and ``lr_scale`` the plateau multiplier."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Dict[str, torch.Tensor]]
    ema_params: Optional[Dict[str, torch.Tensor]]
    lr_scale: float = 1.0

    def state_dict(self) -> Dict[str, Any]:
        """A host copy for a checkpoint."""
        def host(d):
            return None if d is None else {k: v.detach().cpu().clone()
                                           for k, v in d.items()}
        return {"step": self.step, "params": host(self.params),
                "opt_state": {k: host(v) for k, v in self.opt_state.items()},
                "ema_params": host(self.ema_params),
                "lr_scale": self.lr_scale}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        """Copies a ``state_dict`` into this state's tensors."""
        with torch.no_grad():
            for k, v in d["params"].items():
                self.params[k].copy_(v)
            for slot, moments in d["opt_state"].items():
                for k, v in moments.items():
                    self.opt_state[slot][k].copy_(v)
            if self.ema_params is not None and d["ema_params"] is not None:
                for k, v in d["ema_params"].items():
                    self.ema_params[k].copy_(v)
        self.step = int(d["step"])
        self.lr_scale = float(d["lr_scale"])


#: the optimizers' moment slots and their defaults (optax's)
_OPTIMIZERS = {
    "adamw": (("mu", "nu"), dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0)),
    "adam": (("mu", "nu"), dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0)),
    "adabelief": (("mu", "nu"), dict(b1=0.9, b2=0.999, eps=1e-16,
                                     eps_root=1e-16)),
    "sgd": (("trace",), dict(momentum=None, nesterov=False)),
}


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class AtomisticTask:
    """Owns the model, its outputs and the optimizer; ``train_step`` and
    ``eval_step`` run one batch (``task.py:156-277``)."""

    def __init__(self, model, outputs: Sequence[ModelOutput],
                 learning_rate: float = 1e-4, optimizer: str = "adamw",
                 optimizer_args: Optional[Dict] = None,
                 warmup_steps: int = 0, ema_decay: Optional[float] = None,
                 grad_clip: Optional[float] = None,
                 weight_decay: float = 0.0):
        if optimizer not in _OPTIMIZERS:
            raise ValueError(f"unknown optimizer {optimizer}")
        self.model = model
        self.outputs = list(outputs)
        self.learning_rate = learning_rate
        self.optimizer = optimizer
        self.warmup_steps = warmup_steps
        self.ema_decay = ema_decay
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay if optimizer == "adamw" else 0.0
        slots, defaults = _OPTIMIZERS[optimizer]
        unknown = set(optimizer_args or {}) - set(defaults)
        if unknown:
            raise TypeError(f"{optimizer}: unknown optimizer_args "
                            f"{sorted(unknown)}")
        self.slots = slots
        self.hyper = dict(defaults, **(optimizer_args or {}))
        if optimizer == "sgd" and self.hyper["momentum"] is None:
            self.slots = ()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ------------------------------------------------------------------
    def create_state(self) -> TrainState:
        """The state of the model's current parameters (the model
        initialises its weights when it is built): zero moments, the EMA
        copy a clone."""
        params = dict(self.model.named_parameters())
        opt_state = {s: {k: torch.zeros_like(p) for k, p in params.items()}
                     for s in self.slots}
        ema = ({k: p.detach().clone() for k, p in params.items()}
               if self.ema_decay else None)
        return TrainState(0, params, opt_state, ema, 1.0)

    def lr(self, step: int) -> float:
        """The learning rate of update ``step`` (counted from 0)."""
        warm = (min(float(np.float32(step) / np.float32(self.warmup_steps)),
                    1.0) if self.warmup_steps > 0 else 1.0)
        return self.learning_rate * warm

    # ------------------------------------------------------------------
    def loss_and_outputs(self, params: Optional[Dict[str, torch.Tensor]],
                         batch: Dict[str, torch.Tensor]):
        """(loss, outputs) of the model with ``params`` (name -> tensor;
        None: the model's own) on a batch of tensors."""
        if params is None:
            out = self.model(batch, do_postprocessing=False)
        else:
            out = torch.func.functional_call(
                self.model, params, (batch,), {"do_postprocessing": False})
        loss = 0.0
        for o in self.outputs:
            loss = loss + o.loss(out, batch)
        return loss, out

    def _metrics(self, loss, out, batch, prefix):
        out = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in out.items()}
        metrics = {f"{prefix}_loss": (loss.detach(), loss.new_ones(()))}
        for o in self.outputs:
            metrics.update(o.metric_sums(out, batch, prefix))
        return metrics

    def gradients(self, state: TrainState, batch) -> Tuple:
        """(loss, outputs, gradients by name) of one batch of tensors at
        the state's parameters; a parameter the loss does not reach gets
        a zero gradient."""
        names = list(state.params)
        for p in state.params.values():
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, out = self.loss_and_outputs(None, batch)
            grads = torch.autograd.grad(
                loss, [state.params[n] for n in names], allow_unused=True)
        return loss, out, {n: torch.zeros_like(state.params[n]) if g is None
                           else g for n, g in zip(names, grads)}

    def train_step(self, state: TrainState, batch,
                   reduce: Optional[Callable] = None
                   ) -> Tuple[TrainState, Dict]:
        """One update of the state's parameters in place on one batch; the
        metric sums stay on the device.  ``reduce(grads, metrics) ->
        (grads, metrics)`` sits between the gradient and the update, where
        given: the data-parallel step's all-reduce
        (``parallel/data_parallel.py``), so that one rank and many share
        the update."""
        batch = as_tensors(batch, self.device)
        loss, out, grads = self.gradients(state, batch)
        with torch.no_grad():
            metrics = self._metrics(loss, out, batch, "train")
            if reduce is not None:
                grads, metrics = reduce(grads, metrics)
            self.apply_gradients(state, grads)
        return state, metrics

    def apply_gradients(self, state: TrainState,
                        grads: Dict[str, torch.Tensor]) -> None:
        """The optimizer's update of ``state`` from ``grads``, in place,
        as ``torch._foreach_*`` operations over all leaves at once."""
        names = list(grads)
        g = [grads[n] for n in names]
        params = [state.params[n] for n in names]
        if self.grad_clip:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(g)))
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            g = torch._foreach_mul(g, scale)
        h = self.hyper
        if self.optimizer in ("adam", "adamw", "adabelief"):
            count = state.step + 1
            mu = [state.opt_state["mu"][n] for n in names]
            nu = [state.opt_state["nu"][n] for n in names]
            torch._foreach_mul_(mu, h["b1"])
            torch._foreach_add_(mu, g, alpha=1 - h["b1"])
            torch._foreach_mul_(nu, h["b2"])
            if self.optimizer == "adabelief":
                err = torch._foreach_sub(g, mu)
                torch._foreach_addcmul_(nu, err, err, value=1 - h["b2"])
                torch._foreach_add_(nu, h["eps_root"])
                den = torch._foreach_div(nu, _bias_correction(h["b2"], count))
            else:
                torch._foreach_addcmul_(nu, g, g, value=1 - h["b2"])
                den = torch._foreach_div(nu, _bias_correction(h["b2"], count))
                torch._foreach_add_(den, h["eps_root"])
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, h["eps"])
            upd = torch._foreach_div(mu, _bias_correction(h["b1"], count))
            torch._foreach_div_(upd, den)
            if self.weight_decay:
                torch._foreach_add_(upd, params, alpha=self.weight_decay)
        elif self.slots:
            trace = [state.opt_state["trace"][n] for n in names]
            torch._foreach_mul_(trace, h["momentum"])
            torch._foreach_add_(trace, g)
            upd = (torch._foreach_add(g, trace, alpha=h["momentum"])
                   if h["nesterov"] else trace)
        else:
            upd = g
        torch._foreach_add_(params, upd,
                            alpha=-self.lr(state.step) * state.lr_scale)
        if self.ema_decay:
            ema = [state.ema_params[n] for n in names]
            torch._foreach_mul_(ema, self.ema_decay)
            torch._foreach_add_(ema, params, alpha=1.0 - self.ema_decay)
        state.step += 1

    def eval_step(self, params: Dict[str, torch.Tensor], batch,
                  prefix: str = "val") -> Dict:
        """Metric sums of one batch with ``params`` (``eval_params``)."""
        batch = as_tensors(batch, self.device)
        with torch.no_grad():
            loss, out = self.loss_and_outputs(params, batch)
            return self._metrics(loss, out, batch, prefix)

    def eval_params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        return state.ema_params if self.ema_decay else state.params


def aggregate_metrics(batched: List[Dict[str, Tuple]]) -> Dict[str, float]:
    """Sum (value, count) pairs over batches and finalize."""
    totals: Dict[str, Tuple[float, float]] = {}
    for m in batched:
        for k, (v, c) in m.items():
            v, c = float(v), float(c)
            if k in totals:
                totals[k] = (totals[k][0] + v, totals[k][1] + c)
            else:
                totals[k] = (v, c)
    return {k: finalize_metric(k.rsplit("_", 1)[-1], v, c)
            for k, (v, c) in totals.items()}
