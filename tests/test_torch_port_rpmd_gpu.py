"""PyTorch port, ring-polymer MD on a card only (skipped without CUDA): the
replica-blocked calculator against a one-replica ``calculate`` per bead,
with the launches of K1-K4, a Langevin and a PILE application drawing
from a CUDA generator, and NHC applications on the card against the
CPU.  No jax import: on a machine without jax run
``python -m pytest --noconftest -m gpu tests/test_torch_port_rpmd_gpu.py``.
"""
import os

import numpy as np
import pytest
import torch

from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.md import CellBlockNeighborListMD, load_molecules
from schnetpack_tpu_torch.md import simulation_hooks as hooks
from schnetpack_tpu_torch.md.utils import NormalModeTransformer
from schnetpack_tpu_torch.ops import colblock_message as msg
from schnetpack_tpu_torch.ops import painn_mixing as mix
from schnetpack_tpu_torch.units import _parse_unit, md_units
from torch_port_cases import MSG_ATOL, MSG_RTOL, fcc_argon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "scripts", "assets", "bench_painn_argon.msgpack")
N_BEADS = 4
# the blocked path and a one-replica calculate run the same kernels on
# the same tables: equal up to the kernels' own run-to-run order
BEAD_ATOL = 1e-6     # eV/Ang


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def bead_system(device, n_beads=N_BEADS):
    R, cell = fcc_argon(3, jitter=0.1, seed=3)
    conv = _parse_unit("Ang") * md_units().length
    mol = {TP.Z: np.full(len(R), 18, np.int64), TP.R: R, TP.cell: cell,
           TP.pbc: np.ones(3, bool)}
    beads = (R[None] + 0.03 * np.random.RandomState(4).randn(
        n_beads, len(R), 3)) * conv
    system = load_molecules([mol], n_replicas=n_beads, device=device)
    return system.replace(positions=torch.as_tensor(
        beads, dtype=torch.float32, device=device))


def calculator():
    from schnetpack_tpu_torch.atomistic import Atomwise, Forces
    from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
    from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
    from schnetpack_tpu_torch.model import NeuralNetworkPotential
    from schnetpack_tpu_torch.representation import PaiNN

    pot = NeuralNetworkPotential(
        PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20, cutoff=5.0,
              fuse="full"), [Atomwise(n_in=128), Forces()])
    conv = _parse_unit("Ang") * md_units().length
    return SchNetPackCalculator(
        pot, params_from_jax(load_jax_params(ASSET)), cutoff=5.0,
        cutoff_shell=0.3,
        neighbor_list=CellBlockNeighborListMD(5.0 * conv, skin=0.3 * conv))


@pytest.mark.gpu
def test_blocked_calculator_on_the_card(cuda_device):
    """Each bead's forces from the blocked path equal a one-replica
    ``calculate`` of that bead within 1e-6 eV/Ang, the blocked path runs
    K1-K4 3 times per bead, and it agrees with the twins' route on the
    CPU within the message tolerances."""
    calc = calculator()
    system = bead_system(cuda_device)
    state = calc.init_state(system)
    before = {**msg.LAUNCHES, **mix.LAUNCHES}
    blocked = calc.calculate(system, state)
    after = {**msg.LAUNCHES, **mix.LAUNCHES}
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {k: 3 * N_BEADS for k in ("msg_fwd", "msg_bwd", "mix_fwd",
                                     "mix_bwd")}
    to_ev = 1.0 / calc.force_conversion
    for r in range(N_BEADS):
        one = calc.calculate(system.replace(
            positions=system.positions[r:r + 1],
            forces=system.forces[r:r + 1], energy=system.energy[r:r + 1]),
            state)
        err = float((blocked.forces[r] - one.forces[0]).abs().max()) * to_ev
        assert err <= BEAD_ATOL, (r, err)
        torch.testing.assert_close(blocked.energy[r], one.energy[0],
                                   rtol=1e-6, atol=0)
    cpu_calc = calculator()
    cpu_system = bead_system("cpu")
    want = cpu_calc.calculate(cpu_system, cpu_calc.init_state(cpu_system))
    torch.testing.assert_close(blocked.forces.cpu() * to_ev,
                               want.forces * to_ev, rtol=MSG_RTOL,
                               atol=MSG_ATOL)


def noise_moments(z: torch.Tensor):
    z = z.double().flatten()
    return float(z.mean()), float(z.var())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["langevin", "pile_local"])
def test_thermostat_draws_on_the_card(cuda_device, name):
    """From zero momenta one application leaves c2 sigma xi (in normal
    modes for PILE): the noise recovered from it has mean 0 and variance 1
    (within 6 standard errors over 324 samples a bead), and everything
    stays on the card."""
    n_beads = 1 if name == "langevin" else 8
    system = bead_system(cuda_device, n_beads)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    dt = 0.5 * _parse_unit("fs") * md_units().time
    sigma = torch.sqrt(system.masses * md_units().kB * 30.0
                       * n_beads)[None, :, None]
    if name == "langevin":
        hook = hooks.LangevinThermostat(30.0, time_constant=20.0)
        st, out = hook.apply(None, system, gen, dt)
        c1 = np.exp(-0.5 * dt / hook.time_constant)
        xi = out.momenta / (np.sqrt(1.0 - c1 ** 2) * sigma)
    else:
        hook = hooks.PILELocalThermostat(30.0, time_constant=20.0)
        st = hook.init_state(system, dt)
        st, out = hook.apply(st, system, gen, dt)
        pn = NormalModeTransformer(n_beads).beads2normal(out.momenta)
        xi = pn / (st["c2"][:, None, None] * sigma)
    assert out.momenta.device.type == "cuda"
    assert xi.device.type == "cuda"
    n = xi.numel()
    mean, var = noise_moments(xi)
    assert abs(mean) < 6.0 / np.sqrt(n), mean
    assert abs(var - 1.0) < 6.0 * np.sqrt(2.0 / n), var
    # the generator advanced: a second draw differs
    _, again = hook.apply(st, system, gen, dt)
    assert not torch.equal(again.momenta, out.momenta)


@pytest.mark.gpu
@pytest.mark.parametrize("massive", [False, True])
def test_nhc_on_the_card(cuda_device, massive):
    """Four NHC applications on the card (the per-molecule chain runs on
    the host in float64, the massive one on the card) leave the momenta
    and the chains' state on the card in f32, and agree with the same
    applications of a CPU copy within f32 sums' roundoff (rtol 1e-5)."""
    dt = 0.5 * _parse_unit("fs") * md_units().time
    p = torch.as_tensor(                                  # ~10 K
        np.random.RandomState(5).randn(1, 108, 3) * 1.9, dtype=torch.float32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        system = bead_system(dev, 1).replace(momenta=p.to(dev))
        hook = hooks.NHCThermostat(30.0, time_constant=20.0, massive=massive)
        st = hook.init_state(system, dt)
        for _ in range(4):
            st, system = hook.apply(st, system, None, dt)
        assert system.momenta.device.type == dev.type
        assert all(v.device.type == dev.type and v.dtype == torch.float32
                   for v in st.values())
        out[dev.type] = (system.momenta, st["p_xi"], st["xi"])
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-7)
