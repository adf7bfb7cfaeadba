"""PyTorch port, ``spktrain`` and ``spkpredict`` (``schnetpack_tpu_torch.
cli``) on the CPU, and the run directory they write.

``experiment=md17`` with the overrides of ``tests/test_cli.py``'s CLI test
(SchNet at 16 features, 1 interaction, 8 basis functions, 2 epochs of 12
frames in batches of 4) on its synthetic MD17 file, on the flat and the
dense layout: the run directory is complete and the test loss finite; a
rerun with ``trainer.max_epochs=3`` resumes at epoch 2; ``spkpredict``
writes predictions; and the run directory, loaded by the JAX package's
``cli.load_model`` and by the port's, gives the trained model's energies
and forces on a held-out batch within 1e-5.
"""
import csv
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from schnetpack_tpu.cli import load_model as jax_load_model
from schnetpack_tpu_torch import cli
from schnetpack_tpu_torch.parallel import MeshError
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.train import as_tensors

ATOL = 1e-5          # energies and forces: run directory vs trained model


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


def make_md17_npz(path, n_frames=20, n_atoms=5, seed=0):
    """``tests/test_cli.py::make_md17_npz``."""
    rng = np.random.RandomState(seed)
    Z = rng.randint(1, 9, n_atoms)
    R = rng.rand(n_frames, n_atoms, 3) * 3
    E = rng.randn(n_frames)
    F = rng.randn(n_frames, n_atoms, 3) * 0.1
    np.savez(path, z=Z, R=R, E=E, F=F)


def _overrides(tmp_path, dense):
    return [
        "experiment=md17",
        f"run.path={tmp_path}/runs",
        "run.id=testrun",
        f"run.data_dir={tmp_path}/data",
        f"data.raw_dir={tmp_path}/raw",
        "data.num_train=12",
        "data.num_val=4",
        "data.num_test=4",
        "data.batch_size=4",
        "trainer.progress=false",
        "model.representation.n_atom_basis=16",
        "model.representation.n_interactions=1",
        "model.representation.n_rbf=8",
        f"data.dense_layout={str(dense).lower()}",
        "device=cpu",
        "print_config=false",
    ]


def _val_losses(run_dir):
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        return [float(r["val_loss"]) for r in csv.DictReader(f)
                if r.get("val_loss") not in (None, "", "val_loss")]


@pytest.mark.parametrize("dense", [False, True])
def test_spktrain_spkpredict_and_the_run_directory(tmp_path, dense):
    os.makedirs(tmp_path / "raw")
    make_md17_npz(tmp_path / "raw" / "md17_aspirin.npz")
    argv = _overrides(tmp_path, dense)
    cfg = cli.default_composer().compose("train",
                                         argv + ["trainer.max_epochs=2"])
    assert cfg["model"]["representation"]["_target_"] == (
        "schnetpack_tpu_torch.representation.SchNet")
    metrics, task, state, dm = cli.fit(cfg)
    run = str(tmp_path / "runs" / "testrun")
    for f in ("config.yaml", "best_model", "model_config.pkl",
              "checkpoints/last.ckpt", "checkpoints/best.ckpt"):
        assert os.path.exists(os.path.join(run, f)), f
    assert np.isfinite(metrics["test_loss"])
    assert bool(dm.padding.n_neighbors) == dense
    with open(os.path.join(run, "model_config.pkl"), "rb") as f:
        assert pickle.load(f)["_target_"] == (
            "schnetpack_tpu.model.NeuralNetworkPotential")
    first = _val_losses(run)
    assert len(first) == 2

    # the run directory against the trained model, at the best epoch's
    # weights (best_model is written at the best validation loss)
    best = torch.load(os.path.join(run, "checkpoints", "best.ckpt"),
                      weights_only=False)
    if first[-1] <= first[0]:
        for k, v in best["state"]["params"].items():
            np.testing.assert_array_equal(v.numpy(),
                                          state.params[k].detach().numpy())
    state.load_state_dict(best["state"])
    batch = next(iter(dm.test_dataloader()))
    M, A = int(batch[TP.mol_mask].sum()), int(batch[TP.atom_mask].sum())
    with torch.no_grad():
        want = task.model(as_tensors(batch, "cpu"))
        port, _ = cli.load_model(run, "cpu")
        got = port(as_tensors(batch, "cpu"))
    jmodel, jparams = jax_load_model(run)
    jout = jax.jit(jmodel.apply)(jparams, batch)
    for out in (got, {k: torch.as_tensor(np.array(v))
                      for k, v in jout.items()}):
        np.testing.assert_allclose(out[TP.energy][:M].numpy(),
                                   want[TP.energy][:M].numpy(), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(out[TP.forces][:A].numpy(),
                                   want[TP.forces][:A].numpy(), rtol=0,
                                   atol=ATOL)
    assert float(want[TP.forces][:A].abs().max()) > 1e-4

    # resume: the rerun trains epoch 3 only
    cfg = cli.default_composer().compose("train",
                                         argv + ["trainer.max_epochs=3"])
    _, _, state, dm = cli.fit(cfg)
    losses = _val_losses(run)
    assert len(losses) == 3 and losses[:2] == first
    assert state.step == 3 * len(dm.train_dataloader())
    assert torch.load(os.path.join(run, "checkpoints", "last.ckpt"),
                      weights_only=False)["epoch"] == 3

    pred = cli.main(["predict", f"model_dir={run}", "device=cpu"])
    files = sorted(os.listdir(pred))
    assert files == ["batch_0.pkl"]
    with open(os.path.join(pred, files[0]), "rb") as f:
        out = pickle.load(f)
    assert out[TP.energy].shape == (dm.padding.n_molecules,)
    assert np.isfinite(out[TP.forces]).all()


def test_spktrain_refuses_several_devices_and_a_missing_card(tmp_path):
    """``trainer.devices`` beyond the visible cards (NCCL takes a card per
    rank) raises ``MeshError`` before any rank starts; ``device=cuda``
    without a card raises."""
    cfg = cli.default_composer().compose("train", _overrides(
        tmp_path, False) + [
            f"+trainer.devices={max(2, torch.cuda.device_count() + 1)}",
            "device=cuda"])
    with pytest.raises(MeshError, match="visible cards"):
        cli.train(cfg)
    assert not os.path.exists(tmp_path / "runs")
    if not torch.cuda.is_available():
        cfg = cli.default_composer().compose("train", _overrides(
            tmp_path, False) + ["device=cuda"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.train(cfg)
