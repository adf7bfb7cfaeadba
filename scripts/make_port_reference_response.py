"""Write the JAX reference of the port's response slice.

Runs the JAX package on the CPU (``IMPL="xla"``) and saves to
``tests/data/port_ref_response.npz``:

* ``box_{energy,forces,stress}``: PaiNN-128x3 with the trained bench asset
  and ``Forces(calc_stress=True)`` on the jittered 10,976-atom argon box of
  ``port_ref_painn_argon.npz`` (``box_R``, ``box_cell``), on the flat
  layout in f32: the stress of the flat layout, whose strained offsets
  make it exact (the JAX column layout's is not: ROADMAP Queue 3);
* ``heads_{energy,dipole_moment,partial_charges,polarizability}``:
  PaiNN-128x3 with an ``Atomwise``, a
  ``DipoleMoment(use_vector_representation=True)`` and a
  ``Polarizability``, every parameter drawn by
  ``chip_smoke.seeded_params`` from ``HEADS_SEED`` (the bench asset,
  trained on argon, gives features up to 5e5 on these C/H/O blobs), on
  ``bench.py::train_bench``'s batch (100 molecules of 21 atoms,
  ``chip_smoke.train_molecules``) in f32;
* ``field_*``: FieldSchNet-128x5 with both fields and every parameter
  from ``seeded_params(FIELD_SEED)``, with ``Response`` of forces, dipole,
  polarizability, partial charges and shielding at zero fields, on the
  100 synthetic molecules of ``chip_smoke.field_molecules`` (atoms at
  least 1 A apart: on the train_bench blobs, whose atoms come as close as
  0.04 A, its 1/d^5 dipole terms overflow f32) in f32;
* ``colfield_{energy,forces,dipole_moment}``: the trained FieldSchNet-128x5
  asset with ``Response`` of forces and dipole on the bench box (the flat
  layout, which the port's column layout must equal), in f32;
* ``freqs``: ``md/vibrations.normal_modes`` of the batch's first molecule
  with the heads' PaiNN-128x3 and energy head, in f32, as a user calls
  it;
* ``nacl_energy``: ``EnergyEwald`` (``chip_smoke.NACL_EWALD``) of rock salt
  of ``NACL_CELLS``^3 conventional cells (4,096 ions, +-1 e) with the real-
  space pairs within ``NACL_RC`` (``chip_smoke.nacl_pairs``), in float64,
  and the Madelung constant it gives.

``chip_smoke.py``'s phase 12 holds the port on the card to this file, and
``tests/test_torch_port_response_fixture.py`` checks the file itself on
the CPU.  Run from the repository root (a few minutes; the FieldSchNet
bench box takes ~10 GB):

    JAX_PLATFORMS=cpu python scripts/make_port_reference_response.py
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "tests", "data", "port_ref_response.npz")
BOX = os.path.join(ROOT, "tests", "data", "port_ref_painn_argon.npz")
ASSETS = os.path.join(ROOT, "scripts", "assets")
FIELD_RESPONSES = ["forces", "dipole_moment", "polarizability",
                   "partial_charges", "shielding"]


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as cs
    from schnetpack_tpu import properties as P
    from schnetpack_tpu.atomistic import (
        Atomwise, DipoleMoment, EnergyEwald, Forces, PairwiseDistances,
        Polarizability, Response,
    )
    from schnetpack_tpu.data.loader import collate, padding_for
    from schnetpack_tpu.md.vibrations import normal_modes
    from schnetpack_tpu.model import NeuralNetworkPotential
    from schnetpack_tpu.ops import cellblock
    from schnetpack_tpu.representation import FieldSchNet, PaiNN
    from schnetpack_tpu.train.callbacks import load_pytree
    from schnetpack_tpu.transform.neighborlist import NeighborListTransform

    cellblock.IMPL = "xla"
    out = {}
    painn = load_pytree(os.path.join(ASSETS, "bench_painn_argon.msgpack"))
    painn = jax.tree.map(np.asarray, painn)

    def rep_painn():
        return PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
                     cutoff=cs.CUTOFF)

    # the bench box: energy, forces and stress on the flat layout
    box = np.load(BOX)
    out["box_R"], out["box_cell"] = box["R"], box["cell"]
    sample = NeighborListTransform(cs.CUTOFF)(cs.molecule(
        box["R"].astype(np.float64), box["cell"]))
    batch = collate([sample], padding_for([sample]))
    pot = NeuralNetworkPotential(
        representation=rep_painn(), input_modules=[PairwiseDistances()],
        output_modules=[Atomwise(output_key=P.energy),
                        Forces(calc_stress=True)])
    res = jax.jit(pot.apply)(painn, batch)
    A = len(box["R"])
    out["box_energy"] = np.asarray(res[P.energy])[0]
    out["box_forces"] = np.asarray(res[P.forces])[:A]
    out["box_stress"] = np.asarray(res[P.stress])[0]
    print("box: E", out["box_energy"], "stress", out["box_stress"].ravel(),
          "force rms vs port_ref_painn_argon",
          np.sqrt(np.mean((out["box_forces"] - box["forces"]) ** 2)),
          flush=True)
    del res, batch, sample

    # the heads on train_bench's batch
    samples = [NeighborListTransform(cs.CUTOFF)(m)
               for m in cs.train_molecules()]
    tb = collate(samples, padding_for(samples))
    pot = NeuralNetworkPotential(
        representation=rep_painn(), input_modules=[PairwiseDistances()],
        output_modules=[Atomwise(output_key=P.energy),
                        DipoleMoment(use_vector_representation=True),
                        Polarizability()])
    tree = jax.tree.map(np.asarray, pot.init(jax.random.PRNGKey(0), tb))
    params_heads = {"params": cs.seeded_params(tree["params"],
                                               cs.HEADS_SEED)}
    res = jax.jit(pot.apply)(params_heads, tb)
    for k in (P.energy, P.dipole_moment, P.partial_charges,
              P.polarizability):
        out[f"heads_{k}"] = np.asarray(res[k])
    print("heads: |mu| max", np.abs(out["heads_dipole_moment"]).max(),
          "|alpha| max", np.abs(out["heads_polarizability"]).max(),
          flush=True)

    # FieldSchNet-128x5, seeded, both fields, on the batch
    pot = NeuralNetworkPotential(
        representation=FieldSchNet(n_atom_basis=128, n_interactions=5,
                                   n_rbf=20, cutoff=cs.CUTOFF,
                                   response_properties=FIELD_RESPONSES),
        input_modules=[PairwiseDistances()],
        output_modules=[Atomwise(output_key=P.energy),
                        Response(response_properties=FIELD_RESPONSES)])
    tree = jax.tree.map(np.asarray, pot.init(jax.random.PRNGKey(0), tb))
    params = {"params": cs.seeded_params(tree["params"], cs.FIELD_SEED)}
    samples = [NeighborListTransform(cs.CUTOFF)(m)
               for m in cs.field_molecules()]
    fb = collate(samples, padding_for(samples))
    res = jax.jit(pot.apply)(params, fb)
    for k in [P.energy] + FIELD_RESPONSES:
        out[f"field_{k}"] = np.asarray(res[k])
        print(f"field {k}: max |.|", np.abs(out[f"field_{k}"]).max(),
              flush=True)
    del res, tb, fb

    # the FieldSchNet asset's dipole on the bench box
    field = jax.tree.map(np.asarray, load_pytree(
        os.path.join(ASSETS, "bench_field_schnet_argon.msgpack")))
    sample = NeighborListTransform(cs.CUTOFF)(cs.molecule(
        box["R"].astype(np.float64), box["cell"]))
    batch = collate([sample], padding_for([sample]))
    pot = NeuralNetworkPotential(
        representation=FieldSchNet(n_atom_basis=128, n_interactions=5,
                                   n_rbf=20, cutoff=cs.CUTOFF),
        input_modules=[PairwiseDistances()],
        output_modules=[Atomwise(output_key=P.energy),
                        Response(response_properties=[P.forces,
                                                      P.dipole_moment])])
    res = jax.jit(pot.apply)(field, batch)
    out["colfield_energy"] = np.asarray(res[P.energy])[0]
    out["colfield_forces"] = np.asarray(res[P.forces])[:A]
    out["colfield_dipole_moment"] = np.asarray(res[P.dipole_moment])[0]
    print("colfield: dipole", out["colfield_dipole_moment"], flush=True)
    del res, batch, sample

    # normal modes of the first molecule, under the heads' seeded
    # representation and energy head
    mol = cs.train_molecules()[0]
    pot = NeuralNetworkPotential(
        representation=rep_painn(), input_modules=[PairwiseDistances()],
        output_modules=[Atomwise(output_key=P.energy)])
    out["freqs"], _ = normal_modes(pot, {"params": {
        k: v for k, v in params_heads["params"].items()
        if k in ("representation", "output_modules_0")}}, mol)
    print("freqs (cm^-1):", out["freqs"][[0, 1, -2, -1]], flush=True)

    # rock salt: Ewald in float64
    with jax.enable_x64(True):
        R, cell, q = cs.nacl(cs.NACL_CELLS)
        i, j, off = cs.nacl_pairs(R, cell, cs.NACL_RC)
        ins = {P.R: R, P.cell: cell[None], P.idx_i: i, P.idx_j: j,
               P.offsets: off, P.pair_mask: np.ones(len(i)),
               P.idx_m: np.zeros(len(R), np.int32),
               P.n_atoms: np.array([len(R)], np.int32),
               P.atom_mask: np.ones(len(R)), P.partial_charges: q}
        ins = PairwiseDistances().apply({}, {k: jax.numpy.asarray(v)
                                             for k, v in ins.items()})
        res = EnergyEwald(**cs.NACL_EWALD).apply({}, ins)
        out["nacl_energy"] = np.float64(res["energy_ewald"][0])
    out["nacl_madelung"] = cs.madelung(out["nacl_energy"], len(R))
    print(f"NaCl: {len(R)} ions, {len(i)} pairs, E {out['nacl_energy']!r} "
          f"eV, Madelung {out['nacl_madelung']!r}", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
