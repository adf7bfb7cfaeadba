"""PyTorch port, electrostatics and nuclear repulsion against the JAX
package: ``EnergyCoulomb`` (1/r, damped, shifted at a cutoff, on the
long-range list of ``FilterShortRange``), ``EnergyEwald`` on the flat and
dense layouts with the NaCl Madelung constant, and ``ZBLRepulsionEnergy``
with its parameter and position gradients.

The charges, positions and pair lists are made with numpy (the JAX
package's neighbor-list transform) and handed to both packages' modules;
the JAX modules run in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu import atomistic as ja
from schnetpack_tpu import properties as P
from schnetpack_tpu.data.loader import PaddingSpec, collate, padding_for
from schnetpack_tpu.transform.neighborlist import NeighborListTransform
from schnetpack_tpu_torch import atomistic as ta
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.atomistic.electrostatic import build_kgrid
from schnetpack_tpu_torch.convert import _tree
from schnetpack_tpu_torch.units import ke
from test_torch_port_heads import as_torch, molecules

# f32 sums in another order, relative to the largest energy
E_RTOL = 1e-5
#: NaCl's Madelung constant (rock salt, nearest-neighbour distance)
MADELUNG_NACL = 1.747564594633
MADELUNG_RTOL = 1e-4
NACL_A = 5.64            # Angstrom, the conventional cubic cell


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


def nacl(n_cells, a=NACL_A):
    """Rock salt of n_cells^3 conventional cells: (R [8 n^3, 3], cell,
    charges +1 on Na, -1 on Cl)."""
    fcc = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                    -1).reshape(-1, 1, 3)
    na = ((fcc[None] + grid) * a).reshape(-1, 3)
    cl = na + np.array([0.5 * a, 0.0, 0.0])
    R = np.concatenate([na, cl])
    q = np.concatenate([np.ones(len(na)), -np.ones(len(cl))])
    return R, np.eye(3) * a * n_cells, q


def _charged_molecules():
    """The heads' three molecules, collated, with seeded charges."""
    samples = molecules((5, 8, 12))
    rng = np.random.RandomState(11)
    b = collate(samples, padding_for(samples))
    A = sum(len(s[P.Z]) for s in samples)
    q = rng.randn(len(b[P.Z])) * (np.arange(len(b[P.Z])) < A)
    b[P.partial_charges] = q.astype(np.float32)
    return b


def _with_rij(b, jax_side, long_range_cutoff=None):
    """The batch with ``Rij`` (and the long-range list of
    ``FilterShortRange``) from each package's own modules."""
    if jax_side:
        ins = {k: jnp.asarray(v) for k, v in b.items()}
        ins = ja.PairwiseDistances().apply({}, ins)
        if long_range_cutoff:
            ins = ja.FilterShortRange(long_range_cutoff).apply({}, ins)
        return ins
    ins = ta.PairwiseDistances()(as_torch(b))
    if long_range_cutoff:
        ins = ta.FilterShortRange(long_range_cutoff)(ins)
    return ins


@pytest.mark.parametrize("kw", [
    dict(), dict(shielded=True), dict(cutoff=3.0),
    dict(cutoff=3.0, shielded=True, energy_unit=0.5)],
    ids=["plain", "shielded", "cutoff", "shielded_cutoff"])
@pytest.mark.parametrize("long_range", [False, True])
def test_coulomb_matches_jax(kw, long_range):
    b = _charged_molecules()
    lr = 2.5 if long_range else None
    jout = ja.EnergyCoulomb(**kw).apply({}, _with_rij(b, True, lr))
    out = ta.EnergyCoulomb(**kw)(_with_rij(b, False, lr))
    want = np.asarray(jout["energy_coulomb"])
    np.testing.assert_allclose(out["energy_coulomb"].numpy(), want,
                               rtol=0, atol=E_RTOL * np.abs(want).max())
    assert np.abs(want).max() > 1.0


def test_damped_coulomb_potential_matches_jax():
    d = np.linspace(0.05, 3.0, 50)
    for on, off in ((0.0, 1.0), (0.5, 2.0)):
        want = ja.DampedCoulombPotential(on, off).apply({}, jnp.asarray(d))
        got = ta.DampedCoulombPotential(on, off)(torch.tensor(d))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _nacl_batch(n_cells, cutoff, dense=False):
    R, cell, q = nacl(n_cells)
    s = NeighborListTransform(cutoff)({P.Z: np.where(q > 0, 11, 17),
                                       P.R: R, P.cell: cell,
                                       P.pbc: np.ones(3, bool)})
    spec = padding_for([s])
    if dense:
        K = int(np.bincount(s[P.idx_i]).max()) + 1
        spec = PaddingSpec(spec.n_atoms, spec.n_pairs, spec.n_molecules,
                           n_neighbors=K)
    b = collate([s], spec)
    b[P.partial_charges] = np.zeros(len(b[P.Z]), np.float32)
    b[P.partial_charges][:len(q)] = q
    if dense:
        b.update({P.idx_i: np.zeros(1, np.int32),
                  P.idx_j: np.zeros(1, np.int32),
                  P.offsets: np.full((1, 3), 1e3, np.float32),
                  P.pair_mask: np.zeros(1, np.float32)})
    return b, len(q)


def madelung(E, n_ions, a=NACL_A):
    """The Madelung constant of a rock-salt energy: E = -(N/2) M ke / r0."""
    return -2.0 * E * (0.5 * a) / (n_ions * ke)


EWALD = dict(alpha=0.3, k_max=5)    # converged at 13 A on the 11.28 A box
EWALD_CUTOFF = 13.0


def test_ewald_nacl_madelung_and_jax():
    """The Madelung constant of 64 ions (2^3 cells) from the port's Ewald
    sum in float64 within 1e-4, and its float32 energy against the JAX
    package's."""
    b, n = _nacl_batch(2, EWALD_CUTOFF)
    ins = _with_rij(b, False)
    ins64 = {k: (v.double() if v.is_floating_point() else v)
             for k, v in ins.items()}
    E64 = float(ta.EnergyEwald(**EWALD)(ins64)["energy_ewald"][0])
    assert abs(madelung(E64, n) / MADELUNG_NACL - 1) <= MADELUNG_RTOL
    want = float(ja.EnergyEwald(**EWALD).apply(
        {}, _with_rij(b, True))["energy_ewald"][0])
    got = float(ta.EnergyEwald(**EWALD)(ins)["energy_ewald"][0])
    np.testing.assert_allclose(got, want, rtol=E_RTOL)
    np.testing.assert_allclose(got, E64, rtol=E_RTOL)


def test_ewald_dense_layout_matches_flat_and_jax():
    b, _ = _nacl_batch(2, EWALD_CUTOFF)
    flat = float(ta.EnergyEwald(**EWALD)(_with_rij(b, False))[
        "energy_ewald"][0])
    bd, _ = _nacl_batch(2, EWALD_CUTOFF, dense=True)
    dense = float(ta.EnergyEwald(**EWALD)(_with_rij(bd, False))[
        "energy_ewald"][0])
    want = float(ja.EnergyEwald(**EWALD).apply(
        {}, _with_rij(bd, True))["energy_ewald"][0])
    np.testing.assert_allclose(dense, flat, rtol=E_RTOL)
    np.testing.assert_allclose(dense, want, rtol=E_RTOL)


def test_ewald_molecules_without_a_cell_get_the_real_space_sum():
    """Non-periodic molecules (zero cells): no reciprocal or self term,
    as in the JAX package, and its per-molecule energies."""
    b = _charged_molecules()
    kw = dict(alpha=0.4, k_max=2, screening_cutoff=4.0)
    want = np.asarray(ja.EnergyEwald(**kw).apply(
        {}, _with_rij(b, True))["energy_ewald"])
    got = ta.EnergyEwald(**kw)(_with_rij(b, False))["energy_ewald"].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=E_RTOL * np.abs(want).max())


def test_build_kgrid_matches_jax():
    from schnetpack_tpu.atomistic.electrostatic import build_kgrid as jkgrid

    np.testing.assert_array_equal(build_kgrid(3), jkgrid(3))


@pytest.mark.parametrize("trainable", [True, False])
def test_zbl_matches_jax(trainable):
    """ZBL energies on the molecules, with the raw parameters perturbed
    (trainable) or the constants, and their gradients with respect to the
    positions and (trainable) the parameters."""
    b = _charged_molecules()
    jmod = ja.ZBLRepulsionEnergy(trainable=trainable)
    ins = _with_rij(b, True)
    params = jmod.init(jax.random.PRNGKey(0), ins)
    if trainable:
        rng = np.random.RandomState(3)
        params = {"params": {k: np.asarray(v) + 0.05 * rng.randn(*v.shape)
                             .astype(np.float32)
                             for k, v in params["params"].items()}}

    def jE(p, R):
        i = dict(ins, **{P.R: R})
        i = ja.PairwiseDistances().apply({}, i)
        return jnp.sum(jmod.apply(p, i)["energy_zbl"])
    jR = jnp.asarray(b[P.R])
    want_E = np.asarray(jmod.apply(params, ins)["energy_zbl"])
    jgp, jgR = jax.grad(jE, argnums=(0, 1))(params, jR)
    mod = ta.ZBLRepulsionEnergy(trainable=trainable)
    if trainable:
        sd = {}
        _tree("m", params["params"], sd)
        mod.load_state_dict({k[2:]: torch.as_tensor(np.asarray(v))
                             for k, v in sd.items()})
    else:
        assert not list(mod.parameters()) and not mod.state_dict()
    tins = as_torch(b)
    tins[TP.R].requires_grad_(True)
    out = mod(ta.PairwiseDistances()(tins))
    E = out["energy_zbl"]
    grads = torch.autograd.grad(E.sum(), [tins[TP.R]]
                                + list(mod.parameters()))
    np.testing.assert_allclose(E.detach().numpy(), want_E, rtol=E_RTOL,
                               atol=E_RTOL * np.abs(want_E).max())
    assert np.abs(want_E).max() > 1.0
    scale = np.abs(np.asarray(jgR)).max()
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgR), rtol=0,
                               atol=1e-5 * scale)
    for (name, _), g in zip(mod.named_parameters(), grads[1:]):
        w = np.asarray(jgp["params"][name])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())
