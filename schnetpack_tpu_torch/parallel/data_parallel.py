"""Data-parallel training over a mesh of ranks (port of
``schnetpack_tpu/parallel/data_parallel.py``).

The JAX package replicates the parameters, shards a stack of D batches
over a ``data`` mesh axis and averages the gradients with ``pmean``
inside one jitted step.  Here each rank holds a copy of the model and
takes its own batch: rank r takes the r-th batch of each group of D
consecutive loader batches (``GroupedLoader``), which is device r's batch
in JAX.  A step (``make_parallel_train_step``) takes the local gradients
(``AtomisticTask.gradients``: the force loss's double backward, which
``DistributedDataParallel``'s hooks do not follow), sums them and the
metric sums over the ranks in one all-reduce of a flat buffer, divides
the gradients and the loss by D (``pmean``) and keeps the metric sums
and counts summed (``psum`` of (value, count)), then runs the same
optimizer and EMA update on every rank (``AtomisticTask.train_step``'s
``reduce`` seam).  The parameters start as rank 0's (a broadcast).

Usage, on every rank of a joined group::

    mesh = make_mesh(D, axis_names=("data",), device="cuda")
    dp = DataParallelTask(task, mesh)      # broadcasts rank 0's weights
    state = dp.create_state()
    for batch in GroupedLoader(loader, D, mesh.rank):
        state, metrics = dp.train_step(state, batch)
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def stack_device_batches(batches: Sequence[Dict[str, np.ndarray]]
                         ) -> Dict[str, np.ndarray]:
    """Stack D same-shape padded batches into one global batch [D, ...]."""
    keys = batches[0].keys()
    return {k: np.stack([np.asarray(b[k]) for b in batches]) for k in keys}


def split_loader_for_mesh(loader, n_devices: int):
    """Group consecutive loader batches into stacks of ``n_devices``; a
    last group short of ``n_devices`` batches is dropped."""
    group = []
    for b in loader:
        group.append(b)
        if len(group) == n_devices:
            yield stack_device_batches(group)
            group = []


class GroupedLoader:
    """Re-iterable view of a loader for rank ``rank`` of ``n_devices``: the
    ``rank``-th batch of each group of ``n_devices`` consecutive batches
    (every rank iterates the same loader in the same order)."""

    def __init__(self, loader, n_devices: int, rank: int = 0):
        self.loader = loader
        self.n_devices = n_devices
        self.rank = rank

    def __len__(self) -> int:
        return len(self.loader) // self.n_devices

    def __iter__(self):
        group = []
        for b in self.loader:
            group.append(b)
            if len(group) == self.n_devices:
                yield group[self.rank]
                group = []


def _metric_sums(metrics: Dict[str, Tuple], dtype, dev) -> List:
    """The (value, count) pairs of ``metrics`` as a flat list of scalars."""
    return [torch.as_tensor(x, dtype=dtype, device=dev).reshape(1)
            for v, c in metrics.values() for x in (v, c)]


def _reduced_metrics(metrics: Dict[str, Tuple], summed: torch.Tensor,
                     n: int) -> Dict[str, Tuple]:
    """``metrics`` from their summed flat values: ``*_loss`` averaged with
    count 1 (``pmean``), the others' values and counts summed."""
    out = {}
    for i, (k, (v, c)) in enumerate(metrics.items()):
        value, count = summed[2 * i], summed[2 * i + 1]
        if k.endswith("_loss"):
            out[k] = ((value / n).to(v.dtype), torch.ones_like(c))
        else:
            out[k] = (value.to(v.dtype), count.to(torch.as_tensor(c).dtype))
    return out


def mean_over_ranks(mesh):
    """``reduce(grads, metrics) -> (grads, metrics)`` of the data-parallel
    step: one all-reduce of a flat buffer of every gradient and metric
    sum, the gradients and the loss divided by the ranks."""
    def reduce(grads: Dict[str, torch.Tensor], metrics: Dict[str, Tuple]):
        names = list(grads)
        first = grads[names[0]]
        flat = torch.cat([grads[k].reshape(-1).to(first.dtype)
                          for k in names]
                         + _metric_sums(metrics, first.dtype, first.device))
        flat = mesh.all_reduce(flat)
        n = mesh.size
        out, i = {}, 0
        for k in names:
            g = grads[k]
            out[k] = (flat[i:i + g.numel()] / n).reshape(g.shape).to(g.dtype)
            i += g.numel()
        return out, _reduced_metrics(metrics, flat[i:], n)
    return reduce


def make_parallel_train_step(task, mesh):
    """(state, local batch) -> (state, metrics): the data-parallel step
    (see the module's docstring); the state ends equal on every rank."""
    reduce = mean_over_ranks(mesh)

    def step(state, batch):
        return task.train_step(state, batch, reduce=reduce)

    return step


def make_parallel_eval_step(task, mesh, prefix: str = "val"):
    """(params, local batch) -> metrics summed over the ranks (the loss
    averaged, count 1), as the JAX package's ``psum``/``pmean``."""
    def step(params, batch):
        metrics = task.eval_step(params, batch, prefix)
        v = next(iter(metrics.values()))[0]
        flat = mesh.all_reduce(torch.cat(_metric_sums(
            metrics, torch.float64, v.device)))
        return _reduced_metrics(metrics, flat, mesh.size)

    return step


def broadcast_parameters(model, mesh, src: int = 0) -> None:
    """Every parameter and buffer of ``model`` set to rank ``src``'s."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            mesh.broadcast_(t, src)


class DataParallelTask:
    """``Trainer.fit`` on several ranks: wraps an ``AtomisticTask`` whose
    model every rank built, broadcasts rank 0's weights, and runs
    ``train_step`` data-parallel on the rank's batch of each group
    (``GroupedLoader``); evaluation and checkpoints delegate to the
    wrapped task (the parameters are equal on every rank, so each rank's
    evaluation is the single-rank one)."""

    def __init__(self, task, mesh):
        self.task = task
        self.mesh = mesh
        broadcast_parameters(task.model, mesh)
        self._step = make_parallel_train_step(task, mesh)

    def __getattr__(self, name):
        return getattr(self.task, name)

    def train_step(self, state, batch):
        return self._step(state, batch)

    def eval_step(self, params, batch, prefix: str = "val"):
        """The wrapped task's metric sums, rank 0's on every rank (a
        card's float atomics may change their last bits from rank to rank,
        and the scheduler and early stopping must decide alike)."""
        metrics = self.task.eval_step(params, batch, prefix)
        v = next(iter(metrics.values()))[0]
        flat = torch.cat(_metric_sums(metrics, torch.float64, v.device))
        self.mesh.broadcast_(flat)
        return {k: (flat[2 * i].to(v_.dtype), flat[2 * i + 1])
                for i, (k, (v_, _)) in enumerate(metrics.items())}
