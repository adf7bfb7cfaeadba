"""PyTorch port, training: ``train/task.py``, ``train/lr_scheduler.py`` and
the second-order forces of ``model/base.py`` against the JAX package.

One ``AtomisticTask`` step of an energy (weight 0.01) and force (0.99) MSE
loss, for PaiNN and SchNet at F = 16, 2 interactions, 8 basis functions, on
the flat and the dense batch of three molecules (5, 8 and 12 atoms, the
molecules of ``test_torch_port_layouts.py``) with seeded energy and force
labels.  Weights are the flax init with its zero-initialised leaves
perturbed, carried across by ``convert.params_from_jax``; the port's
gradients and parameters go back through ``convert.params_to_jax`` and are
compared with the JAX trees leaf by leaf.  Also: three steps of each
optimizer (with warm-up, clip, weight decay and EMA), ``gradgradcheck`` in
float64 of the plain ops that the force loss differentiates twice, the
plateau scheduler and metric aggregation, a model that an MD calculator
froze, the refusal of second-order forces on the column layout, and the
first loss of ``tests/data/port_ref_painn_train.npz`` on the CPU.
"""
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.data.loader import PaddingSpec, collate
from schnetpack_tpu.train import AtomisticTask as JTask
from schnetpack_tpu.train import ModelOutput as JModelOutput
from schnetpack_tpu.train import ReduceLROnPlateau as JReduceLROnPlateau
from schnetpack_tpu.train import aggregate_metrics as jaggregate_metrics
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.convert import params_from_jax, params_to_jax
from schnetpack_tpu_torch.model.base import SecondOrderLayoutError
from schnetpack_tpu_torch.train import (
    AtomisticTask, ModelOutput, ReduceLROnPlateau, aggregate_metrics,
    as_tensors,
)
import test_torch_port_layouts as layouts
from torch_port_cases import column_inputs, fcc_argon

LOSS_RTOL = 1e-5         # loss and energies, relative
F_ATOL = 1e-4            # forces, eV/Ang elementwise
LEAF_TOL = 1e-4          # gradients and parameters: max |diff| per leaf
                         # over 1e-4 of that leaf's largest |entry|
OPTIMIZERS = {"adamw": {}, "adam": {}, "sgd": {"momentum": 0.9},
              "adabelief": {}}
TRAIN_KW = dict(learning_rate=1e-3, warmup_steps=2, grad_clip=1.0,
                ema_decay=0.9)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "port_ref_painn_train.npz")
sys.path.insert(0, ROOT)           # chip_smoke.py's training case


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _batch(layout):
    """The three molecules with seeded labels, collated by the JAX
    package on a layout (the dense batch also keeps the flat list, as the
    data module's is)."""
    rng = np.random.RandomState(5)
    samples = []
    for s in layouts._samples()[:3]:
        s = dict(s)
        s[P.energy] = np.array([rng.randn()])
        s[P.forces] = rng.randn(len(s[P.Z]), 3)
        samples.append(s)
    A = sum(len(s[P.Z]) for s in samples)
    n_pairs = sum(len(s[P.idx_i]) for s in samples)
    K = max(int(np.bincount(s[P.idx_i]).max()) for s in samples) + 2
    spec = PaddingSpec(A + 4, n_pairs + 8, len(samples) + 1,
                       n_neighbors=K if layout == "dense" else 0)
    return collate(samples, spec)


def _outputs(jax_package):
    cls = JModelOutput if jax_package else ModelOutput
    return [cls("energy", loss_weight=0.01),
            cls("forces", loss_weight=0.99, metrics=("mae", "rmse"))]


def _tasks(model, optimizer="adamw", **kw):
    """(JAX task and state, port task and state) at the perturbed flax
    weights."""
    jpot, pot = layouts._potentials(model)
    tree = layouts._tree(model)
    args = OPTIMIZERS[optimizer] or None
    wd = dict(weight_decay=0.01) if optimizer == "adamw" else {}
    jtask = JTask(jpot, _outputs(True), optimizer=optimizer,
                  optimizer_args=args, **wd, **kw)
    jstate = jtask.create_state(jax.random.PRNGKey(0), _batch("flat"))
    jstate = jstate.replace(
        params=tree, opt_state=jtask.optimizer.init(tree),
        ema_params=(jax.tree.map(np.copy, tree)
                    if kw.get("ema_decay") else None))
    pot.load_state_dict(params_from_jax(tree))
    task = AtomisticTask(pot, _outputs(False), optimizer=optimizer,
                         optimizer_args=args, **wd, **kw)
    return jtask, jstate, task, task.create_state()


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def _trees_close(got, want, tol=LEAF_TOL):
    """Every leaf of ``got`` within ``tol`` x its largest |entry| of the
    leaf of ``want``; returns the worst (leaf, error)."""
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want), set(got) ^ set(want)
    errs = {k: np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
            for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (worst, errs[worst])
    return worst, errs[worst]


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(model, layout):
    jtask, jstate, _, _ = _tasks(model)
    (loss, out), grads = jax.jit(jax.value_and_grad(
        jtask.loss_and_outputs, has_aux=True))(jstate.params, _batch(layout))
    return (float(loss), np.asarray(out[P.energy]), np.asarray(out[P.forces]),
            jax.device_get(grads))


@pytest.mark.parametrize("layout", ["flat", "dense"])
@pytest.mark.parametrize("model", ["painn", "schnet"])
def test_loss_outputs_and_gradients_match_jax(model, layout):
    """The loss (rtol 1e-5), the energies (rtol 1e-5) and forces (1e-4
    eV/Ang) and every parameter's gradient (``LEAF_TOL``) of the energy +
    force loss against ``jax.value_and_grad`` of ``loss_and_outputs``."""
    loss_j, E_j, F_j, grads_j = _jax_loss_and_grads(model, layout)
    _, _, task, state = _tasks(model)
    loss, out, grads = task.gradients(state, as_tensors(_batch(layout),
                                                        "cpu"))
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=LOSS_RTOL)
    np.testing.assert_allclose(out[TP.energy].detach().numpy(), E_j,
                               rtol=LOSS_RTOL, atol=1e-6)
    np.testing.assert_allclose(out[TP.forces].detach().numpy(), F_j,
                               rtol=0, atol=F_ATOL)
    assert out[TP.forces].requires_grad      # the force loss has a graph
    _trees_close(params_to_jax(task.model, grads), grads_j)


@pytest.mark.parametrize("optimizer", list(OPTIMIZERS))
@pytest.mark.parametrize("layout", ["flat", "dense"])
@pytest.mark.parametrize("model", ["painn", "schnet"])
def test_three_steps_match_jax(model, layout, optimizer):
    """Three steps with warm-up (2 steps: the first update is 0), a global
    norm clip of 1 (active here), weight decay 0.01 (adamw) and an EMA of
    0.9: each step's loss (rtol 1e-5), then the parameters and the EMA
    copy (``LEAF_TOL``) against the JAX task's ``train_step``."""
    jtask, jstate, task, state = _tasks(model, optimizer, **TRAIN_KW)
    batch = _batch(layout)
    grads = task.gradients(state, as_tensors(batch, "cpu"))[2]
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    assert norm > TRAIN_KW["grad_clip"]          # the clip acts
    for _ in range(3):
        jstate, jm = jtask.train_step(jstate, batch)
        state, m = task.train_step(state, batch)
        np.testing.assert_allclose(float(m["train_loss"][0]),
                                   float(jm["train_loss"][0]),
                                   rtol=LOSS_RTOL)
    assert state.step == int(jstate.step) == 3
    _trees_close(params_to_jax(task.model), jax.device_get(jstate.params))
    _trees_close(params_to_jax(task.model, state.ema_params),
                 jax.device_get(jstate.ema_params))
    assert jaggregate_metrics([jm]).keys() == aggregate_metrics([m]).keys()


def test_eval_step_reads_the_ema_copy():
    """``eval_step`` on the EMA parameters against the JAX task's."""
    jtask, jstate, task, state = _tasks("schnet", "adam", **TRAIN_KW)
    batch = _batch("flat")
    for _ in range(3):
        jstate, _ = jtask.train_step(jstate, batch)
        state, _ = task.train_step(state, batch)
    want = jaggregate_metrics([jtask.eval_step(jtask.eval_params(jstate),
                                               batch, "val")])
    got = aggregate_metrics([task.eval_step(task.eval_params(state),
                                            batch, "val")])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert task.eval_params(state) is state.ema_params


def _neighbor_case():
    """8 atoms in a 3 A cube with a 2.5 A full list: the flat pairs and
    the dense [A, K] list whose padded slots point to the atom itself with
    offset 0 (Rij = 0 there, exactly, however R moves)."""
    from schnetpack_tpu_torch.ops.neighbor_gather import build_reverse_map
    from schnetpack_tpu_torch.transform.neighborlist import neighbor_list

    rng = np.random.RandomState(3)
    R = rng.rand(8, 3) * 3.0
    i, j, _ = neighbor_list(R, 2.5)
    A, K = len(R), int(np.bincount(i).max()) + 2
    slots = np.arange(len(i)) - np.searchsorted(i, i)
    nbh = np.tile(np.arange(A)[:, None], (1, K))
    mask = np.zeros((A, K))
    nbh[i, slots] = j
    mask[i, slots] = 1.0
    rev = build_reverse_map(i, j, np.zeros((len(i), 3)), slots, A, K)
    t = torch.as_tensor
    return (t(R), t(i), t(j), t(nbh), t(rev).long(), t(mask))


def test_plain_ops_have_second_derivatives():
    """``gradcheck`` and ``gradgradcheck`` in float64 of ``NeighborGather``
    (its padded slots masked), ``segment_sum``
    (with an out-of-range padding index and its non-finite-zeroing branch),
    ``take`` and the safe-norm distances with Gaussian and Bessel bases
    and cosine and mollifier cutoffs on the dense list, padded slots at
    Rij = 0 included."""
    from torch.autograd import gradcheck, gradgradcheck

    from schnetpack_tpu_torch.atomistic import PairwiseDistances
    from schnetpack_tpu_torch.atomistic.distances import edge_geometry
    from schnetpack_tpu_torch.nn import (
        BesselRBF, CosineCutoff, GaussianRBF, MollifierCutoff,
    )
    from schnetpack_tpu_torch.ops.neighbor_gather import neighbor_gather
    from schnetpack_tpu_torch.ops.scatter import segment_sum, take

    R, i, j, nbh, rev, mask = _neighbor_case()
    A = R.shape[0]
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.randn(A, 3, 2), requires_grad=True)
    cases = {
        # the padded slots masked, as every use masks them (the reverse
        # map's VJP leaves them out)
        "neighbor_gather": (lambda x: (neighbor_gather(x, nbh, rev, mask)
                                       * mask[..., None, None]) ** 2, x),
        "take": (lambda x: take(x, j) ** 2, x),
        "segment_sum": (lambda e: segment_sum(
            e ** 3, torch.cat([i, torch.tensor([A])]), A),
            torch.tensor(rng.randn(len(i) + 1, 3), requires_grad=True)),
        "segment_sum_few": (lambda e: segment_sum(
            e ** 3, torch.cat([i % 3, torch.tensor([3])]), 3),
            torch.tensor(rng.randn(len(i) + 1, 3), requires_grad=True)),
    }
    inputs = {TP.R: R, TP.nbh_idx: nbh,
              TP.nbh_offsets: torch.zeros(A, nbh.shape[1], 3)}
    for rbf, fcut in ((GaussianRBF(4, 2.5), CosineCutoff(2.5)),
                      (BesselRBF(4, 2.5), MollifierCutoff(2.5))):
        rbf, fcut = rbf.double(), fcut.double()

        def geometry(R, rbf=rbf, fcut=fcut):
            Rij = PairwiseDistances()(dict(inputs, **{TP.R: R}))[TP.nbh_rij]
            d, dirs = edge_geometry(Rij)
            w = fcut(d) * mask
            return torch.cat([rbf(d) * w[..., None], dirs * w[..., None]],
                             -1)
        cases[f"distances_{type(rbf).__name__}"] = (
            geometry, R.clone().requires_grad_(True))
    for name, (fn, arg) in cases.items():
        assert gradcheck(fn, (arg,)), name
        assert gradgradcheck(fn, (arg,)), name
    # the padded slots' zero displacement: a finite zero gradient
    Rg = R.clone().requires_grad_(True)
    d = edge_geometry(PairwiseDistances()(
        dict(inputs, **{TP.R: Rg}))[TP.nbh_rij])[0]
    (g,) = torch.autograd.grad((d * (1 - mask)).sum(), Rg,
                               create_graph=True)
    assert (mask == 0).any() and torch.isfinite(g).all() and not g.any()


def test_plateau_scheduler_matches_jax():
    """The multiplier sequence and the state of ``ReduceLROnPlateau`` over
    a seeded noisy descent with plateaus, in both threshold modes."""
    rng = np.random.RandomState(7)
    metrics = np.concatenate([np.linspace(1, 0.5, 10), np.full(12, 0.5),
                              0.4 + 0.01 * rng.rand(20)])
    for kw in (dict(factor=0.5, patience=2, cooldown=1, min_lr=1e-5,
                    smoothing_factor=0.3),
               dict(factor=0.8, patience=3, threshold=1e-2,
                    threshold_mode="abs")):
        ours, ref = ReduceLROnPlateau(**kw), JReduceLROnPlateau(**kw)
        got = [ours.step(float(m), 1e-3) for m in metrics]
        want = [ref.step(float(m), 1e-3) for m in metrics]
        assert got == want and len(set(want)) > 2
        assert ours.state_dict() == ref.state_dict()


def test_aggregate_metrics_matches_jax():
    rng = np.random.RandomState(8)
    batches = [{f"val_{k}": (rng.rand() * 10, float(rng.randint(1, 9)))
                for k in ("loss", "energy_mae", "forces_rmse")}
               for _ in range(5)]
    want = jaggregate_metrics(batches)
    got = aggregate_metrics([{k: (torch.tensor(v), torch.tensor(c))
                              for k, (v, c) in b.items()} for b in batches])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_a_calculator_frozen_model_trains():
    """An MD calculator freezes the model's parameters; ``train_step``
    makes them require grad again and moves every one."""
    from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator

    _, _, task, state = _tasks("schnet", "adam")
    SchNetPackCalculator(task.model, cutoff=layouts.CUTOFF)
    assert not any(p.requires_grad for p in task.model.parameters())
    before = {k: v.detach().clone() for k, v in state.params.items()}
    state = task.train_step(state, _batch("flat"))[0]
    task.train_step(state, _batch("flat"))
    assert all(p.requires_grad for p in task.model.parameters())
    assert all((state.params[k] != v).any() for k, v in before.items())


def test_column_batch_refuses_second_order_forces():
    """A column batch in the second-order mode raises the named error;
    with frozen parameters (MD) it runs."""
    _, pot = layouts._potentials("painn")
    pot.load_state_dict(params_from_jax(layouts._tree("painn")))
    R, cell = fcc_argon(3, jitter=0.2, seed=1)
    _, inputs = column_inputs(R, cell, layouts.CUTOFF + 0.3)
    with pytest.raises(SecondOrderLayoutError, match="column or 27-cell"):
        pot(dict(inputs))
    out = pot.requires_grad_(False)(dict(inputs))
    assert torch.isfinite(out[TP.forces]).all()


def test_fixture_first_loss_on_the_cpu():
    """``port_ref_painn_train.npz``'s first loss (the JAX package's, PaiNN-
    128x3 on 100 molecules of 21 atoms) from the port's plain flat path on
    the CPU, rtol 1e-5."""
    import chip_smoke

    ref = np.load(FIXTURE)
    task, batch = chip_smoke.train_task_and_batch("flat", "cpu")
    with torch.no_grad():
        loss, _ = task.loss_and_outputs(None, as_tensors(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(ref["loss"][0]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("model", ["painn", "schnet", "so3net",
                                   "field_schnet", "painn_shared"])
def test_params_to_jax_inverts_params_from_jax(model):
    """``convert.params_to_jax`` of a port model loaded from a flax tree is
    that tree, leaf for leaf and bit for bit (a shared-interaction PaiNN's
    blocks named ``*_shared``)."""
    if model == "painn_shared":
        kw = {"shared_interactions": (True, True)}
        jpot, pot = layouts._potentials("painn", **kw)
        tree = jax.device_get(jax.jit(jpot.init)(
            jax.random.PRNGKey(1), layouts._batch("flat")[0]))
        assert "interaction_shared" in tree["params"]["representation"]
    else:
        _, pot = layouts._potentials(model)
        tree = jax.device_get(layouts._tree(model))
    pot.load_state_dict(params_from_jax(tree))
    got, want = _leaves(params_to_jax(pot)), _leaves(tree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
