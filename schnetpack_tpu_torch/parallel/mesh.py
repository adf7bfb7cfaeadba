"""Meshes of ranks (port of ``schnetpack_tpu/parallel/mesh.py``).

The JAX package's mesh is a ``jax.sharding.Mesh``: devices in a grid
with named axes, and XLA emits the collectives.  Here a mesh is a
``torch.distributed`` process group plus its shape and axis names: rank r
of the group sits at grid position ``np.unravel_index(r, shape)`` (row
major, as ``np.asarray(devices).reshape(shape)`` places JAX's devices)
and runs on one device.  Each rank uses ``cuda:<local rank>`` unless the
caller asks for the CPU; the backend follows the device (NCCL for
``cuda``, gloo for ``cpu``), and a caller may pass ``backend="gloo"`` on
``cuda`` to let several ranks share a card (gloo's collectives take the
card's tensors; only the halo exchange's point-to-point planes are staged
through host buffers, ``ops/colblock_shard.py``).  NCCL with more ranks than visible cards raises ``MeshError``; no
backend is switched quietly.

A mesh of one rank needs no process group.  More ranks join one first:
under ``torchrun`` from its environment (``init_from_env``), otherwise
``spawn_ranks`` starts them on this host with a file store.

Usage::

    def worker(rank, n):
        mesh = make_mesh(n, axis_names=("data",), device="cpu")
        ...
    spawn_ranks(worker, 2, (2,), store_dir="/tmp/run", backend="gloo")
"""
from __future__ import annotations

import datetime
import os
import pickle
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: how long a collective waits for the other ranks before it fails (a
#: rank that died or skipped a collective fails the run, not hangs it)
TIMEOUT = datetime.timedelta(seconds=300)


class MeshError(ValueError):
    """A mesh that the ranks, the cards or the layout cannot hold: NCCL
    with more ranks than visible cards, a group not joined, a grid that
    the mesh does not divide."""


@dataclass(frozen=True)
class Mesh:
    """A process group of the global ranks 0 .. size-1 in a grid of
    ``shape`` with named axes; ``rank`` is this process's rank, ``device``
    its device.  ``group`` is None on one rank."""

    group: Any
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    rank: int = 0
    backend: Optional[str] = None

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's position in the grid."""
        return tuple(int(c) for c in np.unravel_index(self.rank, self.shape))

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def axis_index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    def neighbour(self, name: str, step: int) -> int:
        """The global rank ``step`` places along axis ``name`` from this
        one, periodic."""
        a = self.axis_names.index(name)
        c = list(self.coords)
        c[a] = (c[a] + step) % self.shape[a]
        return int(np.ravel_multi_index(c, self.shape))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the mesh's ranks (a new tensor on ``t``'s
        device; ``t`` itself on one rank)."""
        if self.group is None:
            return t
        buf = t.detach().clone()
        dist.all_reduce(buf, group=self.group)
        return buf

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` of every rank, in rank order, on ``t``'s device."""
        if self.group is None:
            return [t]
        src = t.detach().contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return out

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        if self.group is not None:
            dist.barrier(group=self.group)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> None:
        """Overwrite ``t`` with rank ``src``'s, in place."""
        if self.group is not None:
            dist.broadcast(t.detach(), src, group=self.group)


def _backend(device: torch.device, backend: Optional[str]) -> str:
    if backend is None:
        return "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise MeshError(f"NCCL runs on cuda devices, not {device}")
    return backend


def local_rank() -> int:
    """This process's rank on its host (``LOCAL_RANK``, else its global
    rank)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device, backend: str, n: int) -> torch.device:
    """The device of this rank: ``cuda:<local rank>`` (modulo the visible
    cards under gloo; ``device`` itself on one rank) or the CPU.  NCCL with more ranks than visible cards
    raises ``MeshError``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    count = torch.cuda.device_count()
    if backend == "nccl" and n > count:
        raise MeshError(
            f"NCCL needs a card per rank: {n} ranks, {count} visible "
            "cards; pass backend='gloo' to let ranks share a card")
    if n == 1:
        return device
    if count == 0:
        raise MeshError("no CUDA device for a rank of the mesh: pass "
                        "device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank() % count)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, device="cuda",
              backend: Optional[str] = None) -> Mesh:
    """The mesh of the first ``n_devices`` ranks (all ranks of the joined
    group by default) in ``shape`` (``(n,)`` for one axis), on ``device``
    with ``backend`` (see the module's docstring)."""
    axis_names = tuple(axis_names)
    joined = dist.is_available() and dist.is_initialized()
    n = int(n_devices or (dist.get_world_size() if joined else 1))
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (n,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise MeshError(f"mesh shape {shape} holds {int(np.prod(shape))} "
                        f"ranks, not {n}")
    backend = _backend(torch.device(device), backend)
    dev = rank_device(device, backend, n)
    if n == 1:
        return Mesh(None, shape, axis_names, dev)
    if not joined:
        raise MeshError(
            f"a mesh of {n} ranks needs a joined process group: start the "
            "ranks with torchrun or parallel.mesh.spawn_ranks")
    world = dist.get_world_size()
    if n > world:
        raise MeshError(f"a mesh of {n} ranks in a group of {world}")
    if dist.get_backend() == backend and n == world:
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(range(n)), backend=backend,
                               timeout=TIMEOUT)
    if dist.get_rank() >= n:
        raise MeshError(f"rank {dist.get_rank()} is outside the mesh of "
                        f"{n} ranks")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group, shape, axis_names, dev, dist.get_rank(), backend)


# ----------------------------------------------------------- starting ranks
def init_from_env(backend: str) -> None:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), once."""
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)


def _rank_main(rank: int, payload: bytes, n: int, store: str, backend: str,
               result_dir: str) -> None:
    fn, args = pickle.loads(payload)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(n))
    # every rank is on this host: gloo talks over the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=n, timeout=TIMEOUT)
    try:
        out = fn(rank, *args)
        with open(os.path.join(result_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, n: int, args: tuple = (), store_dir: str = ".",
                backend: str = "gloo") -> List[Any]:
    """Run ``fn(rank, *args)`` in ``n`` fresh processes of this host that
    have joined one process group (a file store under ``store_dir``), and
    return their results in rank order.  ``fn`` must live in a module that
    a child can import (the children start with ``spawn``), and each rank
    gets its own copy of ``args``; a rank that raises fails the call, and
    the others stop."""
    import torch.multiprocessing as mp

    os.makedirs(store_dir, exist_ok=True)
    store = os.path.abspath(os.path.join(store_dir, "dist_store"))
    for path in [store] + [os.path.join(store_dir, f"rank{r}.pkl")
                           for r in range(n)]:
        if os.path.exists(path):
            os.remove(path)
    # plain pickle: each rank unpickles its own copy of the arguments
    # (torch.multiprocessing would share their tensors' memory between
    # the ranks, and a rank's in-place update would reach the others)
    payload = pickle.dumps((fn, args))
    mp.start_processes(_rank_main, args=(payload, n, store, backend,
                                         os.path.abspath(store_dir)),
                       nprocs=n, join=True, start_method="spawn")
    out = []
    for r in range(n):
        with open(os.path.join(store_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
