"""A/B of three training-path changes on one card: the train step of
``chip_smoke.py`` phase 11 (flat and dense), the host neighbor list of its
100 molecules, and ``spktrain`` of SchNet-128x3 on 1,000 synthetic aspirin
frames (3 epochs), each with the earlier code ("c1") and the tree's code
("new"), in the order c1, new, new, c1.

The earlier code, kept here as the comparison: ``NeighborGather``'s
backward by advanced indexing (whose own VJP, in a force loss's double
backward, is the sort-based ``index_put_``), the optimizer as a loop over
the leaves, and the numpy cell list for every molecule
(``cell_list_numpy``; the tree's code takes the native list).  Run from
the repository root on the card:

    python3 scripts/ab_train_step.py

``DEV=cpu FRAMES=40`` (with ``torch.cuda.Event`` and ``nvidia-smi``
stubbed) rehearses it on the CPU.
"""
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from schnetpack_tpu_torch import cli  # noqa: E402
from schnetpack_tpu_torch.ops import neighbor_gather as ng  # noqa: E402
from schnetpack_tpu_torch.train import as_tensors, task as task_mod  # noqa: E402
from schnetpack_tpu_torch.transform import neighborlist as nl  # noqa: E402

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip().splitlines()[0]
print(f"card: {smi}", flush=True)
dev = torch.device(os.environ.get("DEV", "cuda"))
FRAMES = int(os.environ.get("FRAMES", "1000"))
NEW = (ng.NeighborGather.backward, task_mod.AtomisticTask.apply_gradients,
       nl.cell_list_neighbor_list)


def old_backward(ctx, g):
    rev_flat, mask = ctx.saved_tensors
    A, K = rev_flat.shape
    picked = g.reshape((A * K,) + g.shape[2:])[rev_flat.reshape(-1)]
    picked = picked.reshape((A, K) + g.shape[2:])
    m = mask.to(g.dtype).reshape((A, K) + (1,) * (g.ndim - 2))
    return (picked * m).sum(1), None, None, None


def old_apply(self, state, grads):
    names = list(grads)
    g = [grads[n] for n in names]
    if self.grad_clip:
        norm = torch.sqrt(sum((x * x).sum() for x in g))
        g = [torch.where(norm < self.grad_clip, x,
                         (x / norm) * self.grad_clip) for x in g]
    count = state.step + 1
    h = self.hyper
    c1 = task_mod._bias_correction(h["b1"], count)
    c2 = task_mod._bias_correction(h["b2"], count)
    for n, x in zip(names, g):
        mu, nu = state.opt_state["mu"][n], state.opt_state["nu"][n]
        mu.mul_(h["b1"]).add_((1 - h["b1"]) * x)
        nu.mul_(h["b2"]).add_((1 - h["b2"]) * x ** 2)
        upd = (mu / c1) / (torch.sqrt(nu / c2 + h["eps_root"]) + h["eps"])
        if self.weight_decay:
            upd = upd + self.weight_decay * state.params[n]
        grads[n] = upd
    step_size = -self.lr(state.step) * state.lr_scale
    for n in names:
        state.params[n].add_(grads[n] * step_size)
    state.step += 1


def use(code):
    if code == "c1":
        ng.NeighborGather.backward = staticmethod(old_backward)
        task_mod.AtomisticTask.apply_gradients = old_apply
        nl.cell_list_neighbor_list = nl.cell_list_numpy
    else:
        ng.NeighborGather.backward = staticmethod(NEW[0])
        task_mod.AtomisticTask.apply_gradients = NEW[1]
        nl.cell_list_neighbor_list = NEW[2]


def step_ms(layout):
    task, batch = cs.train_task_and_batch(layout, dev)
    batch = as_tensors(batch, dev)
    state = task.create_state()
    for _ in range(5):
        state, _ = task.train_step(state, batch)
    out = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            state, _ = task.train_step(state, batch)
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / 20)
    return float(np.median(out))


for layout in ("flat", "dense"):
    for code in ("c1", "new", "new", "c1"):
        use(code)
        print(f"ab train step ({layout}, {code}): {step_ms(layout):.3f} "
              f"ms/step (median of 3 chunks of 20); {smi}", flush=True)

samples = cs.train_samples()
for code in ("c1", "new", "new", "c1"):
    use(code)
    t = time.perf_counter()
    nbl = nl.MatScipyNeighborList(cs.CUTOFF)
    for s in samples:
        nbl(dict(s))
    print(f"ab host list ({code}): {1e3 * (time.perf_counter() - t):.1f} ms "
          f"for {len(samples)} molecules of 21 atoms; {smi}", flush=True)

tmp = tempfile.mkdtemp(prefix="ab_spktrain_")
raw = os.path.join(tmp, "raw")
os.makedirs(raw)
cs.SPKTRAIN_FRAMES = FRAMES
cs.write_aspirin_npz(raw, 13)
for k, code in enumerate(("c1", "new", "new", "c1")):
    use(code)
    cfg = cli.default_composer().compose("train", [
        "experiment=md17", f"run.id=r{k}", f"run.path={tmp}/runs",
        f"run.data_dir={tmp}/data{k}", f"data.raw_dir={raw}",
        f"data.num_train={FRAMES * 9 // 10}", f"data.num_val={FRAMES // 20}",
        f"data.num_test={FRAMES // 20}", f"data.batch_size={FRAMES // 10}",
        "trainer.max_epochs=3", "trainer.progress=false", f"device={dev}",
        "print_config=false"])
    t = time.perf_counter()
    _, _, state, _ = cli.fit(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    print(f"ab spktrain (SchNet-128x3, {code}): {wall:.2f} s, {state.step} "
          f"steps, {1e3 * wall / state.step:.1f} ms/step with the database "
          f"build, validation and checkpoints; {smi}", flush=True)
shutil.rmtree(tmp, ignore_errors=True)
print("AB OK", flush=True)
