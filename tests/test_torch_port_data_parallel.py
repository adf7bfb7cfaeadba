"""PyTorch port, data-parallel training and the pair-split flat layout on
two gloo ranks on the CPU (``parallel.mesh.spawn_ranks``; the workers are
``torch_parallel_workers.py``), and ``spktrain trainer.devices=2
device=cpu``.

* Three steps of ``DataParallelTask`` (rank 1 starts from other weights,
  which rank 0's broadcast replaces) with warm-up, clip, weight decay and
  EMA, PaiNN and SchNet at F = 16 on two flat batches of the three
  molecules of ``test_torch_port_train.py`` with other labels, against
  the JAX package's ``make_parallel_train_step`` on a 2-device mesh:
  every parameter and EMA leaf at that file's ``LEAF_TOL``, each step's
  loss at ``LOSS_RTOL`` and its metric sums; ``make_parallel_eval_step``
  against JAX's.
* ``parallel/spatial.py``: PaiNN and SchNet with the pair list split over
  the ranks against the replicated model (``tests/test_parallel.py:79``'s
  gates); PaiNN with ZBL, Coulomb on the long-range list of
  ``FilterShortRange``, Ewald and the stress on two periodic boxes, each
  energy term, the forces and the stress against the replicated model
  (every module that reads the pair list itself); the model's refusal to
  train there and an uneven split's; ``pad_batch_for_mesh`` and the
  loader groupings against the JAX package's.
* ``spktrain`` on two ranks (spawned by the CLI, a file store in the run
  directory): the run directory written once, by rank 0, and its test
  metrics equal to one rank's run on batches twice as large (the mean of
  two batches' mean losses is the mean loss of their union here: every
  frame has the same atoms).
"""
import csv
import functools
import os

import jax
import numpy as np
import pytest
import torch

import test_torch_port_layouts as layouts
import torch_parallel_workers as workers
from schnetpack_tpu import properties as P
from schnetpack_tpu.data.loader import PaddingSpec, collate
from schnetpack_tpu.parallel import (
    make_mesh as jmake_mesh, make_parallel_eval_step as jeval_step,
    make_parallel_train_step as jtrain_step, shard_global_batch,
    split_loader_for_mesh as jsplit, stack_device_batches as jstack,
)
from schnetpack_tpu.parallel.spatial import pad_batch_for_mesh as jpad
from schnetpack_tpu.transform.neighborlist import NeighborListTransform
from schnetpack_tpu_torch import atomistic as ta
from schnetpack_tpu_torch import cli
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.model.base import SecondOrderLayoutError
from schnetpack_tpu_torch.parallel import (
    GroupedLoader, spawn_ranks, split_loader_for_mesh, stack_device_batches,
)
from schnetpack_tpu_torch.parallel.mesh import Mesh, MeshError, make_mesh
from schnetpack_tpu_torch.parallel.spatial import (
    pad_batch_for_mesh, shard_batch_by_atoms,
)
from schnetpack_tpu_torch.representation import PaiNN
from schnetpack_tpu_torch.train import as_tensors
from test_torch_port_train import (
    LOSS_RTOL, TRAIN_KW, _leaves, _outputs, _tasks, _trees_close,
)
from test_torch_port_train_cli import _overrides, make_md17_npz
from torch_port_cases import fcc_argon

MODELS = ["painn", "schnet"]
N_STEPS = 3
# pair-split vs replicated (``tests/test_parallel.py:103-108``)
E_RTOL, E_ATOL = 1e-5, 1e-6
F_RTOL, F_ATOL = 1e-4, 1e-6
# the periodic model's outputs (per molecule, per atom)
BOX_MOL_KEYS = [TP.energy, "energy_nn", "energy_zbl", "energy_coulomb",
                "energy_ewald", TP.stress]
BOX_KEYS = BOX_MOL_KEYS + [TP.forces]
# spktrain on two ranks vs one rank on the union of their batches: f32
# sums of the gradient in another order, through 2 epochs of Adam
CLI_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


def _batch(seed):
    """The three molecules with labels of ``seed``, collated flat."""
    rng = np.random.RandomState(seed)
    samples = []
    for s in layouts._samples()[:3]:
        s = dict(s)
        s[P.energy] = np.array([rng.randn()])
        s[P.forces] = rng.randn(len(s[P.Z]), 3)
        samples.append(s)
    A = sum(len(s[P.Z]) for s in samples)
    n_pairs = sum(len(s[P.idx_i]) for s in samples)
    return collate(samples, PaddingSpec(A + 4, n_pairs + 8, len(samples) + 1))


BATCHES = [_batch(5), _batch(6)]


def _task_kw():
    return dict(optimizer="adamw", weight_decay=0.01, **TRAIN_KW)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on two ranks in one spawn: the data-parallel runs of
    ``MODELS``, then the pair-split models on the padded batch."""
    dp = []
    for model in MODELS:
        _, _, task, _ = _tasks(model, "adamw", **TRAIN_KW)
        dp.append((task.model, _outputs(False), _task_kw(), BATCHES,
                   N_STEPS))
    pairs = [(_pair_potential(m), _pair_batch(), [TP.energy, TP.forces])
             for m in MODELS]
    pairs.append((_box_potential(), _box_batch()[0], BOX_KEYS))
    res = spawn_ranks(workers.data_parallel, 2, (dp, pairs),
                      str(tmp_path_factory.mktemp("ranks")))
    return res


def _pair_batch():
    return pad_batch_for_mesh(layouts._batch("flat")[0], 2)


def _pair_potential(model):
    pot = layouts._potentials(model)[1]
    pot.load_state_dict(_pair_params(model))
    return pot


@functools.lru_cache(maxsize=None)
def _box_batch():
    """(flat batch of two jittered 108-atom argon boxes with seeded
    partial charges, padded for two ranks; real molecules)."""
    samples = []
    for seed in (1, 3):
        R, cell = fcc_argon(3, jitter=0.2, seed=seed)
        samples.append(NeighborListTransform(layouts.CUTOFF)(
            {P.Z: np.full(len(R), 18, np.int64), P.R: R, P.cell: cell,
             P.pbc: np.ones(3, bool)}))
    A = sum(len(s[P.Z]) for s in samples)
    n_pairs = sum(len(s[P.idx_i]) for s in samples)
    b = collate(samples, PaddingSpec(A + 4, n_pairs + 8, len(samples) + 1))
    q = np.random.RandomState(7).randn(len(b[P.Z])) * 0.3
    b[P.partial_charges] = (q * (np.arange(len(q)) < A)).astype(np.float32)
    return pad_batch_for_mesh(b, 2), len(samples)


def _box_potential():
    """PaiNN-16x2 with ZBL, Coulomb on the long-range list of
    ``FilterShortRange``, Ewald, their sum and the stress; seeded
    weights."""
    torch.manual_seed(3)
    terms = ["energy_nn", "energy_zbl", "energy_coulomb", "energy_ewald"]
    return NeuralNetworkPotential(
        PaiNN(n_atom_basis=layouts.F_, n_interactions=layouts.T_,
              n_rbf=layouts.B_, cutoff=layouts.CUTOFF),
        [ta.Atomwise(n_in=layouts.F_, output_key="energy_nn"),
         ta.ZBLRepulsionEnergy(cutoff=layouts.CUTOFF),
         ta.EnergyCoulomb(cutoff=layouts.CUTOFF, shielded=True),
         ta.EnergyEwald(alpha=0.4, k_max=2, use_long_range=True),
         ta.Aggregation(terms, TP.energy), ta.Forces(calc_stress=True)],
        input_modules=[ta.PairwiseDistances(), ta.FilterShortRange(3.5)])


def _pair_params(model):
    from schnetpack_tpu_torch.convert import params_from_jax

    return params_from_jax(layouts._tree(model))


@functools.lru_cache(maxsize=None)
def _jax_data_parallel(model):
    jtask, jstate, _, _ = _tasks(model, "adamw", **TRAIN_KW)
    mesh = jmake_mesh(2, axis_names=("data",))
    metrics = []
    with mesh:
        step = jtrain_step(jtask, mesh)
        gb = shard_global_batch(jstack(BATCHES), mesh)
        for _ in range(N_STEPS):
            jstate, m = step(jstate, gb)
            metrics.append({k: (float(v), float(c)) for k, (v, c) in
                            jax.device_get(m).items()})
        val = jax.device_get(jeval_step(jtask, mesh)(
            jtask.eval_params(jstate), gb))
    return jstate, metrics, {k: (float(v), float(c))
                             for k, (v, c) in val.items()}


@pytest.mark.parametrize("model", MODELS)
def test_data_parallel_steps_match_jax(ranks, model):
    """Three data-parallel steps on two ranks against the JAX package's
    ``make_parallel_train_step``: every parameter and EMA leaf, each
    step's loss (the mean over the ranks) and metric sums (summed), equal
    on both ranks."""
    i = MODELS.index(model)
    params, ema, metrics, _ = ranks[0][0][i]
    jstate, jmetrics, _ = _jax_data_parallel(model)
    _trees_close(params, jax.device_get(jstate.params))
    _trees_close(ema, jax.device_get(jstate.ema_params))
    assert len(metrics) == len(jmetrics) == N_STEPS
    for got, want in zip(metrics, jmetrics):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                       err_msg=k)
    other = ranks[1][0][i]
    for a, b in ((params, other[0]), (ema, other[1])):
        la, lb = _leaves(a), _leaves(b)
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    assert other[2] == metrics


@pytest.mark.parametrize("model", MODELS)
def test_parallel_eval_step_matches_jax(ranks, model):
    """``make_parallel_eval_step`` after the three steps (each rank on its
    batch, the EMA parameters) against the JAX package's: the loss the
    ranks' mean, every metric sum and count summed."""
    i = MODELS.index(model)
    _, _, jval = _jax_data_parallel(model)
    for r in range(2):
        val = ranks[r][0][i][3]
        assert val.keys() == jval.keys()
        for k in jval:
            np.testing.assert_allclose(val[k], jval[k], rtol=LOSS_RTOL,
                                       err_msg=k)


@pytest.mark.parametrize("model", MODELS)
def test_pair_split_forces_match_replicated(ranks, model):
    """The model with its pair list split over two ranks gives the
    replicated model's energies and forces on every rank; each rank holds
    half of the pairs."""
    i = MODELS.index(model)
    batch = _pair_batch()
    want = _pair_potential(model)(as_tensors(batch, "cpu"))
    E_ref = want[TP.energy].detach().double().numpy()
    F_ref = want[TP.forces].detach().double().numpy()
    n_pairs = batch[P.idx_i].shape[0]
    for r in range(2):
        out, local_pairs, axis = ranks[r][1][i]
        assert local_pairs == n_pairs // 2 and axis == "atoms"
        np.testing.assert_allclose(out[TP.energy], E_ref, rtol=E_RTOL,
                                   atol=E_ATOL)
        np.testing.assert_allclose(out[TP.forces], F_ref, rtol=F_RTOL,
                                   atol=F_ATOL)
    assert np.abs(F_ref).max() > 1e-3


@pytest.mark.parametrize("key", BOX_KEYS)
def test_pair_split_box_terms_and_stress_match_replicated(ranks, key):
    """Each energy term (ZBL, Coulomb on the long-range list, Ewald's
    real-space sum read the pair list themselves), the forces and the
    stress (``Strain`` strains the rank's offsets) of the periodic model
    with its pair list split over two ranks: the replicated model's on
    every rank, per real molecule."""
    batch, M = _box_batch()
    with torch.no_grad():
        want = _box_potential()(as_tensors(batch, "cpu"))
    ref = want[key].double().numpy()
    if key in BOX_MOL_KEYS:
        ref = ref[:M]
    rtol, atol = ((E_RTOL, E_ATOL) if key in BOX_MOL_KEYS[:-1]
                  else (F_RTOL, F_ATOL))
    for r in range(2):
        got = ranks[r][1][len(MODELS)][0][key]
        np.testing.assert_allclose(got[:len(ref)], ref, rtol=rtol, atol=atol,
                                   err_msg=f"rank {r}")
    assert np.abs(ref).max() > 1e-3


def test_pair_split_refuses_training_and_an_uneven_split():
    """On the pair-split layout the model refuses a call that could
    train (its parameter gradients would be a rank's share) and evaluates
    with frozen parameters; a pair array that the ranks do not divide
    raises."""
    batch = _pair_batch()
    local, _ = shard_batch_by_atoms(batch, make_mesh(1, ("atoms",),
                                                     device="cpu"))
    pot = _pair_potential("painn")
    with pytest.raises(SecondOrderLayoutError, match="pair-split"):
        pot(local)
    for p in pot.parameters():
        p.requires_grad_(False)
    got = pot(local)[TP.forces].double().numpy()
    want = pot(as_tensors(batch, "cpu"))[TP.forces].double().numpy()
    np.testing.assert_allclose(got, want, rtol=F_RTOL, atol=F_ATOL)
    uneven = {k: (v[:-1] if k in (P.idx_i, P.idx_j, P.offsets, P.pair_mask)
                  else v) for k, v in batch.items()}
    two = Mesh(None, (2,), ("atoms",), torch.device("cpu"))
    with pytest.raises(MeshError, match="pad_batch_for_mesh"):
        shard_batch_by_atoms(uneven, two)


def test_padding_and_loader_groups_match_jax():
    """``pad_batch_for_mesh`` equals the JAX package's array for array;
    ``stack_device_batches`` and ``split_loader_for_mesh`` likewise, and
    ``GroupedLoader`` gives rank r the r-th batch of each group (the last
    short group dropped)."""
    batch = layouts._batch("dense")[0]
    for n in (2, 3, 8):
        got, want = pad_batch_for_mesh(batch, n), jpad(batch, n)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    loader = [BATCHES[0], BATCHES[1], BATCHES[0], BATCHES[1], BATCHES[0]]
    got, want = list(split_loader_for_mesh(loader, 2)), list(jsplit(loader, 2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    for r in range(2):
        grouped = GroupedLoader(loader, 2, r)
        assert len(grouped) == 2
        for b, want in zip(grouped, (loader[r], loader[2 + r])):
            assert b is want
    stacked = stack_device_batches(loader[:2])
    for k in stacked:
        np.testing.assert_array_equal(stacked[k], jstack(loader[:2])[k])


def _metric_rows(run_dir):
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def test_spktrain_on_two_ranks(tmp_path):
    """``spktrain trainer.devices=2 device=cpu`` (the CLI starts the two
    ranks): the run directory complete and written by rank 0 alone, and
    its test metrics those of one rank on batches twice as large."""
    os.makedirs(tmp_path / "raw")
    make_md17_npz(tmp_path / "raw" / "md17_aspirin.npz", n_frames=24)

    def run(run_id, batch_size, devices):
        argv = [o for o in _overrides(tmp_path, False)
                if not o.startswith(("run.id=", "data.batch_size=",
                                     "data.num_train="))]
        argv += [f"run.id={run_id}", f"data.batch_size={batch_size}",
                 "data.num_train=16", "trainer.max_epochs=2",
                 f"+trainer.devices={devices}"]
        return cli.train(cli.default_composer().compose("train", argv))

    two = run("two", 4, 2)
    one = run("one", 8, 1)
    run_dir = str(tmp_path / "runs" / "two")
    for f in ("config.yaml", "best_model", "model_config.pkl",
              "checkpoints/last.ckpt", "checkpoints/best.ckpt"):
        assert os.path.exists(os.path.join(run_dir, f)), f
    rows = _metric_rows(run_dir)
    # one line per epoch and one of the test, from rank 0 alone
    assert len([r for r in rows if r.get("val_loss")]) == 2
    assert two.keys() == one.keys()
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=CLI_RTOL, err_msg=k)
    assert np.isfinite(two["test_loss"])
    model, _ = cli.load_model(run_dir, "cpu")
    assert model is not None
