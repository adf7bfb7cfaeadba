"""Smoke run of the PyTorch/CUDA port on one GPU (run from the repo root):

    python3 chip_smoke.py [--seed 0] [--steps 300]

Phases (any failure exits non-zero before the last line is printed):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``schnetpack_tpu_torch/csrc`` (one nvcc per
   source, started together; sm_90a) and print ptxas's registers, stack
   frame and spills of every instance of the message, mixing and cfconv
   kernels;
3. hold each kernel K1-K21 against its plain PyTorch twin on the card at
   the shapes of the MD runs below (10,976-atom argon box in the layout the
   port's neighbor list builds, F=128, B=20, f32, random features and
   cotangents from --seed; K6/K7 on the geo that K5 computes there, K15 on
   K5's geo without the d channel, K9/K10 on the raw-phi geo of K5's raw
   form, with the trained SchNet's first filter network; K11-K14 at the
   positions' width D = 3 and SO3net's D = 9 x 64, and at FieldSchNet's
   D = 128 and 384 on the field_schnet run's layout (sub-rows "d128",
   "d384"); K1/K2 again at F = 256
   on the same layout (a sub-row); K2, K7 and K15 also in
   their wgrad instances, which return the filter-weight cotangent gFW, a
   sum over all ~200k edges: those are held to the twin evaluated in
   float64, since the f32 twin's own sum is off by ~1e-5 there, as are
   K4's wgrad instance (the mixing weights' cotangents, at 12,800 rows)
   and K10's (the SchNet filter weights', on the SchNet run's layout);
   K20/K21 (row 12) and K21's wgrad instance in the wrap, halo_x and
   halo_xy source-index modes on the painn_slab layout (the bench box on
   the slab path's own grid and capacities, F = 128, B = 20, on the box's
   own basis and directions), and K11/K12 in the halo modes at D = 3; K16-K19
   on the 27-cell atom layout of the painn_cell run, K16/K17 at D = 3,
   K18/K19 on the basis and directions of the box's own geometry, K19 also
   in its wgrad instance, and K3/K4 again at that layout's 16,000 rows),
   tolerance rtol 1e-4 / atol 1e-5 elementwise, the copies K11 and K13
   (every width and mode) bit for bit; time both per call (``ms``: CUDA
   events around 10 back-to-back calls, so the host's time where it is
   the longer), the kernel also on the device (``device_ms``: its kernels'
   durations in ``torch.profiler``'s CUDA trace of 10 calls), and the one
   PyTorch call that computes the same function where there is one
   (K11-K14, K16, K17: ``index_select`` and the mask, ``index_add_``) both
   ways (``library_ms``, ``library_device_ms``); and work
   out each kernel's bound from the bytes of its inputs and outputs at
   3.35 TB/s and its FP32 operations at 67 TFLOP/s (H100 SXM data sheet),
   the operations those this run's data needs (the filter and products
   of K1/K2, K6/K7, K18 and K20 only on the slots inside the cutoff);
4. hold the port's energy and forces on the card to the JAX references
   (force rms <= 1e-4 eV/Ang, energy within 1e-5 relative): PaiNN in both
   message forms (``fuse`` = hybrid and full) to
   ``tests/data/port_ref_painn_argon.npz``, printing the force rms between
   the two, SchNet to ``tests/data/port_ref_schnet_argon.npz``, SO3net
   to ``tests/data/port_ref_so3net_argon.npz``, and PaiNN on the row-9
   path with a trainable Gaussian basis (the fixture's centers and widths)
   and with a Bessel basis to ``tests/data/port_ref_painn_{trbf,bessel}_
   argon.npz``, and PaiNN on the 27-cell atom layout (``painn_cell``) and
   on the slab path (``painn_slab``, through ``make_sharded_column_eval``
   on one card) to ``port_ref_painn_argon.npz``, printing their force rms
   against ``full``, and FieldSchNet-128x5 to ``tests/data/
   port_ref_field_schnet_argon.npz``; then the gradient of the energy with
   respect to every parameter of PaiNN-128x3 (``fuse`` full and hybrid,
   and on the slab path) and SchNet-128x3 on that box, with the energy
   output only, against
   ``tests/data/port_ref_{painn,schnet}_grad_argon.npz``: per leaf
   ||g - g_jax|| <= 1e-4 ||g_jax||, a leaf under 1e-3 of the largest
   leaf's norm against 1e-7 of that norm; the launches of one evaluation
   (the mixing's, the cfconv's and row 12's wgrad instances, and K2/K7,
   whose wgrad instances count under their own names), and its time beside
   the frozen force evaluation;
5. the neighbor list's device rebuild at full size: jitter the lattice by
   a seeded uniform +-0.25 A (the 0.3 A skin check fires, the capacities
   hold), rebuild once on the device and once on the host, and require
   equal edge sets (original atom ids, periodic shifts) and forces within
   rms 1e-5 eV/Ang; time both;
6. run NVE velocity Verlet at 0.5 fs of the 10,976-atom periodic FCC argon
   box with the trained PaiNN-128x3 (``scripts/assets/
   bench_painn_argon.msgpack``), the trained SchNet-128x3
   (``scripts/assets/bench_schnet_argon.msgpack``), the trained
   SO3net-64x3 (lmax 2, ``scripts/assets/bench_so3net_argon.msgpack``) and
   the trained PaiNN with the trbf fixture's trainable Gaussian basis and
   the trained FieldSchNet-128x5 (``scripts/assets/
   bench_field_schnet_argon.msgpack``, no field),
   Maxwell-Boltzmann momenta at 30 K, the column neighbor list (5 A
   cutoff, 0.6 A skin): a warm-up, a retighten of the capacities, then
   --steps timed steps, on PaiNN's hybrid path, PaiNN's full path,
   SchNet's path, SO3net's path and PaiNN's row-9 path (``painn_trbf``),
   PaiNN on the 27-cell atom layout (``painn_cell``, the same cutoff
   and skin) and FieldSchNet's path (``field_schnet``);
   check finite positions, 0 < T < 300 K, total-energy drift <= 1e-4
   eV/atom, the launches per step of every kernel (hybrid: K5 1,
   K6/K7/K3/K4 3; full: K1/K2/K3/K4 3; SchNet: K5 raw 1, K9/K10 3, K8 1;
   SO3net: K11 4, K12 3, K13 4, K14 4; painn_trbf: K11-K14 1 each,
   K6/K15/K3/K4 3; painn_cell: K16/K17 1, K18/K19/K3/K4 3;
   field_schnet: K11 16, K12 14, K13 16, K14 16; every other kernel 0),
   that on the column paths every rebuild after the retighten went through
   the device unless it overflowed, and that painn_cell, whose
   layout has no device rebuild, rebuilt on the host only (printing the
   count and wall time of those builds and the ms/step without them);
   then 300 NVE steps of ``painn_slab`` through the port's
   ``SpatialColumnSimulator`` on one card (30 K Maxwell-Boltzmann momenta
   from --seed, dt 0.5 fs, chunks of 50 steps with a host re-bin before
   each): finite, 0 < T < 300 K, drift of the total energy at the chunk
   boundaries <= 1e-4 eV/atom, per force evaluation (one per step and one
   at each chunk's start) K11/K12 halo 1, K13/K14 1, K20/K21/K3/K4 3 and
   every other kernel 0, the chunks' ms/step (CUDA events) apart from the
   re-bin's host seconds;
7. thermostatted MD of the bench box with PaiNN-128x3 (``fuse="full"``,
   the column list rebuilt on the device, 0.5 fs, f32, Maxwell-Boltzmann
   momenta at 30 K), 300 steps each: ``painn_nvt_langevin``
   (``LangevinThermostat(30 K, time_constant=20 fs)``: the mean
   temperature of the last 100 steps within 30 +- 3 K), then
   ``painn_nvt_nhc`` (``NHCThermostat(30 K, time_constant=20 fs)``) from
   the Langevin run's last state: the mean within 30 +- 9 K, 0 < T < 300
   K at every step (from the cold lattice the chain's first trough falls
   in steps 200-300), the drift of its extended energy (kinetic and
   potential energy and the chains' ``chain_energy``, at the end of every
   25-step chunk) <= 1e-5 eV/atom, and its mean at least 5 K closer to
   the bath than that of 300 NVE steps from the same state (the control:
   the Langevin run leaves the lattice's potential energy short, which
   then drains the kinetic energy); K1-K4 3 a step (the control's too),
   every other kernel 0;
8. ring-polymer MD (``painn_rpmd``): the parity of the replica-blocked
   calculator on the card (8 beads: the fixture's positions and 7 copies
   offset by seeded +-0.02 A; each bead's forces within 1e-6 eV/Ang of a
   one-replica ``calculate`` of that bead, bead 0 within phase 4's gates
   of ``port_ref_painn_argon.npz``), then 8 beads of the bench box
   started as copies with Maxwell-Boltzmann momenta per bead at 30 K,
   ``RingPolymer(0.5 fs, 8 beads, 30 K)``: 100 NVE steps (the drift of
   the ring-polymer energy sum_k [KE_k + V_k] + 1/2 sum_k m w_k^2
   |q~_k|^2 in normal modes <= 1e-4 eV per atom per bead, recorded
   every step by a device hook inside the timed window; the total
   centroid momentum conserved within 1e-5 of sum |p_c|, f32 roundoff),
   then 100 steps under ``PILELocalThermostat(30 K)`` (finite positions,
   0 < centroid T < 300 K; its ms/step is the path's cost); K1-K4 24 a
   step, every other kernel 0.  Each
   path of 7 and 8 prints ms per step (CUDA events), atom-steps/s (RPMD:
   atoms x beads), T or centroid T, drift, rebuilds and peak device
   memory beside the card's name and power limit;
9. ``spkmd`` through the port's CLI (``schnetpack_tpu_torch.md.cli.main``)
   in a temporary directory, each run's launches counted from zero:
   ``build_calculator`` on a run directory written as the JAX training CLI
   writes one (``PAINN_RUN_CONFIG``, a copy of the PaiNN asset) within
   phase 4's gates of ``port_ref_painn_argon.npz``; ``spkmd_painn``, the
   bench box from extxyz under Langevin (30 K, 20 fs, 300 steps) with the
   trajectory file every step: 300 entries, the last frame equal to the
   final state, the mean T of the last 100 steps within 3 K, K1-K4 3 per
   force evaluation (one per step and the first); then its ms/step, a
   control without the file and phase 7's ``painn_nvt_langevin`` on one
   clock (each simulator's ``wall_seconds``), in ``SPKMD_REPEATS`` rounds
   whose order turns every other round, with the file's writes and a
   chunk's log copy timed; ``spkmd_ensemble``, the asset and
   a seeded +-1% copy on the fixture's positions, 50 NVE steps: mean
   forces within 1e-6 eV/Ang of two single calculators at the start, the
   file's ``forces_uncertainty`` within 1e-6 of their population std at
   the end, K1-K4 6 per evaluation; ``spkmd_water`` (gate 5: 8 SPC/Fw
   waters, NHC 600 steps: second-half mean T in 180-420 K, no O-H over
   1.6 A, the power spectrum's largest peak above 2,500 cm^-1 in
   3,000-4,000; 16-bead PIMD 300 steps: bead T in 0.5-1.7 x 16 x 300 K);
   ``spkmd_npt`` (32 LJ argon at 20 kbar, ``dynamics=npt``: NHC iso 300
   steps, 0.5 V0 < V < 0.995 V0; aniso 200 steps, V < V0, det > 0); no
   kernel launches in the water and NPT runs; ms/step of each beside the
   card's name and power limit;
10. the flat and dense layouts (``layout_phase``), each run's launches
   counted from zero: the four trained models (PaiNN-128x3, SchNet-128x3,
   SO3net-64x3, FieldSchNet-128x5) on each fixture's box on the flat
   layout (the host cell list's pairs within the cutoff, as the fixtures
   were made) and through the calculator on ``neighbor_list="dense"``
   (skin 0.5 A), SchNet and SO3net also on ``cellblock_atom``, held to
   their fixtures at phase 4's gates, with K16/K17 once each per 27-cell
   evaluation and no kernel on the flat and dense ones; PaiNN's and
   SchNet's parameter gradients on the flat layout against
   ``port_ref_{painn,schnet}_grad_argon.npz`` at phase 4's rule;
   ``painn_dense``: 300 NVE steps of the bench box on the dense list
   (drift <= 1e-4 eV/atom, 0 < T < 300 K, the host rebuilds counted,
   peak device memory), then 5 steps under ``torch.profiler`` (kernel
   time, idle share, the kernels with the most device time);
   ``painn_clusters``: 64 non-periodic 55-atom clusters (a seeded lattice
   site of the bench box with its first four FCC shells, jittered by
   +-0.1 A) as molecules of one system, 3,520 atoms and 190,080 ordered
   pairs: forces at the start on ``all_pairs`` within 1e-5 eV/Ang of the
   dense list's, 300 NVE steps on ``all_pairs`` (drift <= 1e-4 eV/atom),
   then 4 beads under PILE-L, 100 steps on each layout, forces equal at
   the start; ``spkmd_clusters``: ``spkmd`` on an extxyz of the clusters
   with the calculator config as shipped (``neighbor_list: all_pairs``),
   Langevin at 30 K, 300 steps, 300 trajectory entries; ms/step of each
   run beside the card's name and power limit;
11. training (``train_phase``), each part's launches counted from zero
   (none may run: the flat and dense layouts launch no kernel, as the JAX
   training step reaches no Pallas kernel): (a) PaiNN-128x3 with the
   asset's weights on ``bench.py::train_bench``'s batch (100 molecules of
   21 atoms, C9H8O4, ``RandomState(0)``; energy sum(R^2), forces -2R),
   collated by the port on the flat and the dense layout, an energy (0.01)
   and force (0.99) MSE loss, AdamW at lr 1e-4: the first loss within
   1e-5 relative, the gradient of every parameter per leaf at phase 4's
   rule and the losses before steps 2-4 within 1e-3 relative of
   ``tests/data/port_ref_painn_train.npz`` (the JAX package's in float64,
   written by ``scripts/make_port_reference_train.py``); (b) ms per train
   step on both layouts (CUDA events, a warm-up, the median of 3 chunks of
   20), the peak device memory, and 5 steps under ``torch.profiler``:
   kernel time, launches, idle share, the kernels and the operations with
   the most device time; (c) ``spktrain`` through ``cli.fit`` in a
   temporary directory on a seeded synthetic aspirin trajectory of 1,000
   frames (``write_aspirin_npz``; 900/50/50, batches of 100, 3 epochs),
   ``experiment=md17`` (SchNet-128x3) and ``experiment=rmd17``
   (PaiNN-128x3, on the rMD17 format of the same frames): the validation
   loss falls from the first epoch to the last, the run directory is
   complete, ``cli.load_model`` of it gives the trained model's energies
   (at the best epoch's weights) within 1e-6 eV and forces within 1e-5
   eV/A on a test batch, a rerun with one more epoch resumes from
   ``last.ckpt``, ``spkpredict`` writes the test split's predictions;
   then ``spkmd`` runs 100 NVE steps of one molecule from the PaiNN run
   directory on ``all_pairs`` (finite; the drift printed);
12. responses (``response_phase``), each part's launches counted from
   zero, against ``tests/data/port_ref_response.npz`` (the JAX package's,
   ``scripts/make_port_reference_response.py``): (a) the trained
   PaiNN-128x3 with ``Forces(calc_stress=True)`` on that file's bench box
   (phase 4's box) on the flat layout and on the 27-cell layout (K16/K17
   1, K18/K19 3, K3/K4 3 per evaluation): forces and energy at phase 4's
   gates, the stress within 1e-4 of the virial's scale (the largest entry
   of sum_i |r_i (x) F_i| / V; the stress itself is small near
   equilibrium); ms per evaluation with and without stress; (b) PaiNN-
   128x3 with an ``Atomwise``, ``DipoleMoment(use_vector_representation=
   True)`` and ``Polarizability``, every parameter seeded
   (``seeded_params``), on ``train_bench``'s batch: each output within
   1e-4 of the largest reference entry, no launches; (c) FieldSchNet-
   128x5 with both fields, seeded, on 100 synthetic molecules
   (``field_molecules``) with ``Response`` of forces, dipole,
   polarizability, partial charges and shielding (1e-4 of the largest
   entry, no launches), then the FieldSchNet asset on the bench box's
   column layout with forces (phase 4's gate) and the dipole dE/dF (within
   1e-5 of sum_a |dE/dF_a|, each atom's term from the flat layout with
   every atom a molecule; K11 16, K12 14, K13 16, K14 16); (d) ``md/vibrations.normal_modes`` of the batch's first
   molecule under (b)'s representation: the frequencies within 1e-3 of the
   largest |f|, the Hessian's ms; (e) ``EnergyEwald`` of rock salt (4,096
   ions, alpha 0.2/A, k_max 13, real space within 22 A) in f32: the
   Madelung constant within 1e-4 and the JAX float64 energy within 1e-5;
   (f) ``spktrain experiment=qm9_dipole`` (PaiNN-128x3) on a synthetic
   QM9 archive of 1,000 molecules and ``experiment=response``
   (FieldSchNet-128x5) on a synthetic database of 200, 3 epochs each: the
   validation loss falls, ``load_model`` of the run directory within 1e-5
   of the trained model's largest entry of each output; (g) ``spkmd dynamics=npt`` with a PaiNN-128x3
   run directory whose model has stress, ``calculator.stress_key=stress``
   on ``all_pairs``, NHC iso, a 500-atom FCC argon box: the step-0 stress
   equal to a one-off ``calculate``'s, 300 steps at 0 and at 2 kbar, V/V0
   in 0.8-1.1, the 2 kbar run's volume the smaller;
13. print the kernel table (every row and sub-row with ``ms`` and
   ``device_ms``, ``library_ms`` and ``library_device_ms``) and the card
   as JSON, then the result line.

The parameter gradients of phase 4 run before the device rebuild of phase
5, and the launches of row 12's, the mixing's and the cfconv's wgrad
instances in the table are those of phase 4's evaluations.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSET = {
    "painn": os.path.join(ROOT, "scripts", "assets",
                          "bench_painn_argon.msgpack"),
    "schnet": os.path.join(ROOT, "scripts", "assets",
                           "bench_schnet_argon.msgpack"),
    "so3net": os.path.join(ROOT, "scripts", "assets",
                           "bench_so3net_argon.msgpack"),
    "field_schnet": os.path.join(ROOT, "scripts", "assets",
                                 "bench_field_schnet_argon.msgpack"),
}
#: the JAX reference of each path (``scripts/make_port_reference*.py``)
REFERENCE = {
    path: os.path.join(ROOT, "tests", "data", f"port_ref_{name}_argon.npz")
    for path, name in [("hybrid", "painn"), ("full", "painn"),
                       ("schnet", "schnet"), ("so3net", "so3net"),
                       ("painn_trbf", "painn_trbf"),
                       ("painn_bessel", "painn_bessel"),
                       ("painn_cell", "painn"),
                       ("field_schnet", "field_schnet")]
}
CUTOFF, SKIN = 5.0, 0.6          # Angstrom
RTOL, ATOL = 1e-4, 1e-5          # kernel vs twin, elementwise
#: the mixing's and cfconv's weight cotangents vs the f64 twin, normwise
#: (||g - w|| <= NORM_RTOL ||w||): sums over 12,800 rows or ~200k edges of
#: products of the kernels' f32 factors, whose rounding (~1e-6 relative
#: after 128-long dot products) walks; f64 partials remove only the
#: summation order's error
NORM_RTOL = 1e-5
#: the sources of the ptxas report of the build (the message, mixing and
#: cfconv kernels) and their template kernels' parameters, per kernel name
PTXAS_SOURCES = {
    "colblock_message.cu": {"msg_fwd_kernel": ("kIn", "kB4")},
    "colblock_message_bwd.cu": {"msg_bwd_kernel": ("kMode", "kWgrad", "kB4")},
    "painn_mixing.cu": {"mix_fwd_kernel": ("ROWS", "NW")},
    "schnet_columns.cu": {"cf_fwd_kernel": ("F",),
                          "cf_bwd_kernel": ("kWgrad", "F")}}
#: the numbers of a kernel row that its sub-rows carry
SUB_KEYS = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "tf32x3_floor_ms", "library_ms", "library_device_ms",
            "wgrad")
FORCE_RMS_TOL = 1e-4             # eV/Ang vs the JAX reference
ENERGY_RTOL = 1e-5
GRAD_RTOL = 1e-4                 # per leaf, ||g - g_jax|| / ||g_jax||
GRAD_FLOOR = 1e-3                # leaves under this share of the largest norm
DRIFT_TOL = 1e-4                 # eV/atom, max |E_tot(t) - E_tot(0)|
REBUILD_FORCE_RMS_TOL = 1e-5     # eV/Ang, device vs host neighbor state
REBUILD_JITTER = 0.25            # Angstrom, per component
HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12          # FP32 outside the tensor cores, same
TF32_FLOP_PER_S = 495e12         # TF32 on the tensor cores, dense, same
#: kernel launches per MD step on each path (PaiNN's two message forms,
#: SchNet, SO3net: the positions' gather and expand, then per block the
#: feature gather and the message fold and, by autograd, their VJPs, with
#: no gather VJP for block 0, whose input carries no gradient;
#: FieldSchNet: the positions' 1 each, then 15 gathers and 15 folds at
#: D = 128 and 384 (the initial dipole update's, 3 a block, the last
#: block's dipole update not computed), the folds' 15 VJPs and 13 gather
#: VJPs (none for the initial update's and block 0's SchNet gathers, which
#: read the frozen embedding))
PER_STEP = {
    "hybrid": {"geo_fwd": 1, "msg_fwd_geo": 3, "msg_bwd_geores": 3,
               "mix_fwd": 3, "mix_bwd": 3},
    "full": {"msg_fwd": 3, "msg_bwd": 3, "mix_fwd": 3, "mix_bwd": 3},
    "schnet": {"geo_fwd_raw": 1, "cf_fwd": 3, "cf_bwd": 3, "geo_bwd": 1},
    "so3net": {"gather_fwd": 4, "gather_bwd": 3, "expand_fwd": 4,
               "fold_fwd": 4},
    "field_schnet": {"gather_fwd": 16, "gather_bwd": 14, "expand_fwd": 16,
                     "fold_fwd": 16},
    "painn_trbf": {"gather_fwd": 1, "gather_bwd": 1, "expand_fwd": 1,
                   "fold_fwd": 1, "msg_fwd_geo": 3, "msg_bwd_src": 3,
                   "mix_fwd": 3, "mix_bwd": 3},
    "painn_cell": {"cell_gather_fwd": 1, "cell_gather_bwd": 1,
                   "cell_msg_fwd": 3, "cell_msg_bwd": 3, "mix_fwd": 3,
                   "mix_bwd": 3},
    "painn_slab": {"gather_fwd": 1, "gather_bwd": 1, "expand_fwd": 1,
                   "fold_fwd": 1, "msg_fwd_edge": 3, "msg_bwd_edge": 3,
                   "mix_fwd": 3, "mix_bwd": 3},
    # 8 beads, each bead one "full" evaluation
    "rpmd": {"msg_fwd": 24, "msg_bwd": 24, "mix_fwd": 24, "mix_bwd": 24},
}
#: the energy parameter gradients of phase 4: their JAX fixture, and the
#: launches of one evaluation (the positions carry no gradient, so no
#: position VJP runs)
GRAD_REFERENCE = {path: os.path.join(ROOT, "tests", "data",
                                     f"port_ref_{name}_grad_argon.npz")
                  for path, name in [("full", "painn"), ("hybrid", "painn"),
                                     ("schnet", "schnet"),
                                     ("painn_slab", "painn")]}
GRAD_LAUNCHES = {
    "full": {"msg_fwd": 3, "msg_bwd": 3, "mix_fwd": 3, "mix_bwd_wgrad": 3},
    "hybrid": {"geo_fwd": 1, "msg_fwd_geo": 3, "msg_bwd_geores": 3,
               "mix_fwd": 3, "mix_bwd_wgrad": 3},
    "schnet": {"geo_fwd_raw": 1, "cf_fwd": 3, "cf_bwd_wgrad": 3},
    "painn_slab": {"gather_fwd": 1, "expand_fwd": 1, "msg_fwd_edge": 3,
                   "msg_bwd_edge_wgrad": 3, "mix_fwd": 3,
                   "mix_bwd_wgrad": 3},
}
#: the slab path's NVE run: time step (0.5 fs in the Angstrom/eV/amu frame,
#: whose time unit is 10.1805 fs), steps per chunk, start temperature
SLAB_DT = 0.5 / 10.180505
SLAB_CHUNK = 50
SLAB_T0 = 30.0                   # K
KB_EV = 8.617333262e-5           # eV / K

#: the MD paths of phase 6
PATHS = ("hybrid", "full", "schnet", "so3net", "painn_trbf", "painn_cell",
         "field_schnet")
#: the thermostatted and ring-polymer runs of phases 7 and 8: bath (K),
#: thermostat time constant (fs), steps, the last steps averaged, and the
#: gates on that mean temperature (K)
T_BATH, TAU_FS = 30.0, 20.0
NVT_STEPS, NVT_AVG = 300, 100
NVT_TOL = {"painn_nvt_langevin": 3.0, "painn_nvt_nhc": 9.0}
NVT_CHUNK = 25                   # NHC's extended energy at each chunk's end
NHC_DRIFT_TOL = 1e-5             # eV per atom
NHC_MARGIN = 5.0                 # K closer to the bath than the NVE control
N_BEADS = 8
RPMD_STEPS = 100                 # NVE, then as many under PILE-L
RPMD_DRIFT_TOL = 1e-4            # eV per atom per bead
CENTROID_P_RTOL = 1e-5           # of sum |p_c|: f32 roundoff
BEAD_OFFSET = 0.02               # Angstrom, the parity check's beads
BEAD_FORCE_ATOL = 1e-6           # eV/Ang, blocked vs one replica
#: phase 9, ``spkmd`` through the port's CLI: the trained PaiNN's run
#: directory as the JAX training CLI writes it (``model_config.pkl``, a
#: plain dict of the JAX package's targets, and ``best_model``), steps,
#: the ensemble's gates, SPC/Fw water and LJ argon under NPT
PAINN_RUN_CONFIG = {
    "_target_": "schnetpack_tpu.model.NeuralNetworkPotential",
    "representation": {"_target_": "schnetpack_tpu.representation.PaiNN",
                       "n_atom_basis": 128, "n_interactions": 3,
                       "n_rbf": 20, "cutoff": CUTOFF},
    "input_modules": [{"_target_":
                       "schnetpack_tpu.atomistic.PairwiseDistances"}],
    "output_modules": [{"_target_": "schnetpack_tpu.atomistic.Atomwise",
                        "output_key": "energy"},
                       {"_target_": "schnetpack_tpu.atomistic.Forces"}],
}
SPKMD_STEPS, SPKMD_CHUNK = 300, 100
SPKMD_REPEATS = 3                # rounds of the spkmd_painn timing A/B
ENSEMBLE_STEPS = 50
ENSEMBLE_SCALE = 0.01            # the second member: asset x (1 +- 1%)
ENSEMBLE_FORCE_ATOL = 1e-6       # eV/Ang, vs single calculators
WATER_NVT_STEPS, WATER_PIMD_STEPS, WATER_BEADS = 600, 300, 16
WATER_T = 300.0                  # K
WATER_NVT_T = (180.0, 420.0)     # K, the second half's mean (gate 5)
WATER_PIMD_T = (0.5, 1.7)        # x beads x 300 K, bead-kinetic T (gate 5)
OH_MAX = 1.6                     # Angstrom, no O-H bond broken at the end
OH_BAND = (3000.0, 4000.0)       # cm^-1, the largest peak above 2,500
NPT_STEPS = {"nhc_iso": 300, "nhc_aniso": 200}
NPT_ARGS = ["barostat.target_pressure=20000.0",
            "barostat.temperature_bath=20.0", "barostat.time_constant=20.0",
            "barostat.time_constant_barostat=50.0",
            "dynamics.integrator.time_step=1.0",
            "system.initializer.temperature=20.0"]
#: phase 10, the flat and dense layouts: the full-box models (their
#: fixtures are the JAX package's flat pair list), the 27-cell layout's
#: models and their launches per evaluation, the dense MD run, and the
#: clusters: a site of the bench lattice with its first four FCC shells
#: (12 + 6 + 24 + 12 atoms within 7.9 A), 64 of them as molecules of one
#: system, jittered by the fixtures' +-0.1 A
#: phase 11, training
TRAIN_REFERENCE = os.path.join(ROOT, "tests", "data",
                               "port_ref_painn_train.npz")
TRAIN_MOLECULES = 100            # bench.py::train_bench's batch
TRAIN_LOSS_RTOL = 1e-5           # the first loss vs the JAX fixture
TRAIN_STEP_LOSS_RTOL = 1e-3      # the losses before steps 2-4
TRAIN_WARMUP, TRAIN_CHUNK, TRAIN_CHUNKS = 5, 20, 3
TRAIN_PROFILE_STEPS = 5
SPKTRAIN_FRAMES = 1000
SPKTRAIN_SPLIT = (900, 50, 50)   # train, val, test frames
SPKTRAIN_BATCH = 100
SPKTRAIN_EPOCHS = 3
KCAL_MOL = 0.0433641             # eV per kcal/mol
SPKTRAIN_E_ATOL = 1e-6 / KCAL_MOL  # kcal/mol (1e-6 eV): load_model vs the
SPKTRAIN_F_ATOL = 1e-5 / KCAL_MOL  # trained model; kcal/mol/Ang (1e-5 eV/A)
SPKTRAIN_MD_STEPS = 100
#: phase 12, responses: the JAX fixture
#: (``scripts/make_port_reference_response.py``), the seeds of the heads'
#: and FieldSchNet's parameters (``seeded_tree``), the gates, rock salt's
#: Ewald sum, ``spktrain``'s synthetic sets and the NPT runs
RESPONSE_REFERENCE = os.path.join(ROOT, "tests", "data",
                                  "port_ref_response.npz")
HEADS_SEED = FIELD_SEED = 23
FIELD_RESPONSES = ("forces", "dipole_moment", "polarizability",
                   "partial_charges", "shielding")
#: the stress against the fixture: max |sigma - sigma_ref| over the
#: virial's scale, the largest entry of sum_i |r_i (x) F_i| / V
STRESS_VIRIAL_TOL = 1e-4
#: a response on molecules: max |got - ref| over max |ref| (f32 roundoff
#: of up to three nested derivatives on both sides)
RESPONSE_RTOL = 1e-4
#: the bench box's dipole: max |mu - mu_ref| over sum_a |dE/dF_a| (its
#: terms: the f32 sum over 10,976 atoms cancels to ~1e-4 of them)
DIPOLE_SCALE_TOL = 1e-5
#: harmonic frequencies: max |f - f_ref| over max |f_ref| (the f32
#: Hessians of both packages)
FREQ_RTOL = 1e-3
#: the 27-cell stress evaluation's launches (``PER_STEP["painn_cell"]``)
CELL_STRESS_LAUNCHES = {"cell_gather_fwd": 1, "cell_gather_bwd": 1,
                        "cell_msg_fwd": 3, "cell_msg_bwd": 3, "mix_fwd": 3,
                        "mix_bwd": 3}
NACL_CELLS, NACL_A = 8, 5.64     # 4,096 ions; Angstrom
NACL_EWALD = dict(alpha=0.2, k_max=13)
NACL_RC = 22.0                   # Angstrom, under half the 45.12 A box
MADELUNG_NACL = 1.747564594633
MADELUNG_RTOL = 1e-4
NACL_RTOL = 1e-5                 # the f32 energy vs the JAX float64 one
QM9_MOLECULES = 1000
QM9_SPLIT = (900, 50, 50)
RESPONSE_MOLECULES = 200
RESPONSE_SPLIT = (160, 20, 20)
RESPONSE_EPOCHS = 3
#: load_model vs the trained model, max |d| over the output's largest
#: entry (the f32 atomic sums' order differs from one call to the next)
RESPONSE_LOAD_RTOL = 1e-5
NPT_BOX = 500                    # 5^3 FCC cells, 26.3 A
NPT_MODEL_STEPS = 300
NPT_PRESSURES = (0.0, 2000.0)    # bar
NPT_VOLUME = (0.8, 1.1)          # V / V0 at the end
#: the model's 30 K crystal at the bench lattice holds ~2.6 kbar (the
#: fixture's stress), and its volume at 0 bar lies near 1.2 V0: under
#: ``NPT_ARGS``' 50 fs barostat (or one of 500 fs) it swings to 1.24 V0
#: within 50 steps (the CPU, 108 atoms); at 5,000 fs it expands
#: smoothly, to 1.07 V0 in 300 steps at 0 bar
NPT_MODEL_ARGS = ["barostat.temperature_bath=30.0",
                  "barostat.time_constant=100.0",
                  "barostat.time_constant_barostat=5000.0",
                  "dynamics.integrator.time_step=1.0",
                  "system.initializer.temperature=30.0"]
NPT_STRESS_RTOL = 1e-6           # step-0 stress vs a one-off calculate
LAYOUT_PATHS = {"painn": "painn_cell", "schnet": "schnet",
                "so3net": "so3net", "field_schnet": "field_schnet"}
CELL_LAUNCHES = {"cell_gather_fwd": 1, "cell_gather_bwd": 1}
LAYOUT_STEPS = 300
N_CLUSTERS, CLUSTER_RADIUS, CLUSTER_JITTER = 64, 7.9, 0.1   # Angstrom
CLUSTER_ATOMS = 55
CLUSTER_FORCE_ATOL = 1e-5        # eV/Ang, all_pairs vs dense
CLUSTER_BEADS, CLUSTER_RPMD_STEPS = 4, 100
PROFILE_STEPS = 5                # painn_dense steps under torch.profiler


def ptxas_report(log: str, params):
    """(instance, registers, stack frame, spill stores, spill loads) of
    each kernel in ptxas's -v report ``log``; the instance is the kernel's
    name with its template arguments, read from the mangled name and named
    by ``params`` (a tuple of parameter names per template kernel)."""
    out, name, frame = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            # a template kernel's arguments: I...EEv after its name
            k = re.search(r"\d([a-z_]+_kernel)(?:I(.*?)EEv)?", name)
            inst = k.group(1) if k else name
            if k and k.group(2):
                args = re.findall(r"L[a-z](\d+)E", k.group(2))
                inst += "<" + ", ".join(f"{p}={a}" for p, a in zip(
                    params.get(inst, ()), args)) + ">"
            out.append((inst, int(m.group(1)), *frame))
            name, frame = None, (0, 0, 0)
    return out


def fcc_box(n_target: int, a: float = 5.26):
    """FCC argon supercell with ~n_target atoms (``bench.py::fcc_box``)."""
    n = int(round((n_target / 4) ** (1 / 3)))
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                    -1).reshape(-1, 1, 3)
    return ((base[None] + grid) * a).reshape(-1, 3), np.eye(3) * a * n


def water_box_xyz(path, n_side=2, a=3.105):
    """n_side^3 bent waters (O, H, H) on a cubic lattice at ~1 g/cc, written
    as extxyz to ``path`` (``tests/test_gate5_water.py::_water_box_xyz``)."""
    rng = np.random.RandomState(2)
    L = n_side * a
    lines = [str(3 * n_side ** 3),
             f'Lattice="{L} 0 0 0 {L} 0 0 0 {L}" pbc="T T T"']
    for i in range(n_side):
        for j in range(n_side):
            for k in range(n_side):
                O = np.array([i, j, k], float) * a + a / 2 + rng.rand(3) * 0.05
                for el, p in (("O", O), ("H", O + [0.76, 0.67, 0.0]),
                              ("H", O + [-0.76, 0.67, 0.0])):
                    lines.append(f"{el} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return L


def cuda_ms(fn, reps=10):
    """Mean per-call time of ``fn`` after one warm-up call: one CUDA-event
    pair around ``reps`` back-to-back calls, so the host's work per call
    where it is longer than the device's."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: traces that ``device_ms`` took, and those it took again (lost kernels)
TRACES = {"taken": 0, "retaken": 0}


def device_ms(fn, reps=10, tries=5):
    """Mean device time of ``fn``: the durations of the kernels (and
    copies) that ``reps`` back-to-back calls ran on the card, summed from
    ``torch.profiler``'s CUDA trace, over ``reps``.  A first step of
    ``reps`` calls warms the tracer up and is dropped, and the measured
    calls start a few ms into their step (the trace can miss the first
    kernels of a window); a trace in which some kernel did not run a
    multiple of ``reps`` times lost kernels and is taken again.  The
    step's own range on the device (``ProfilerStep``) is no kernel."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(tries):
        TRACES["taken"] += 1
        traced = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: traced.extend(
                         e for e in p.key_averages()
                         if e.device_type == cuda
                         and not e.key.startswith("ProfilerStep"))) as prof:
            for _ in range(2):
                time.sleep(0.005)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        us = sum(e.device_time_total for e in traced)
        if us > 0 and all(e.count % reps == 0 for e in traced):
            return us / 1e3 / reps
        TRACES["retaken"] += 1
    raise AssertionError(
        f"the profiler's trace lost kernels in {tries} tries: "
        f"{[(e.key, e.count) for e in traced]}")


def in_f64(fn, *args):
    """``fn`` on float64 copies of its float32 tensor arguments, its outputs
    rounded to float32."""
    out = fn(*[a.double() if torch.is_tensor(a) and a.dtype == torch.float32
               else a for a in args])
    return tuple(o.float() for o in out)


def compare(name, got, want, norm_from=None, exact=False):
    """Max abs difference; elementwise rtol/atol (``exact``: equal), from
    output ``norm_from`` on normwise."""
    rtol, atol = (0.0, 0.0) if exact else (RTOL, ATOL)
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if norm_from is not None and i >= norm_from:
            d = float((g.double() - w.double()).norm())
            assert d <= NORM_RTOL * float(w.double().norm()), (
                f"{name}: output {i} off by {d} (norm {w.norm()})")
        else:
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{name}: {m}")
        err = max(err, float((g - w).abs().max()))
    return err


def molecule(R, cell):
    from schnetpack_tpu_torch import properties as P

    return {P.Z: np.full(len(R), 18, np.int64), P.R: R, P.cell: cell,
            P.pbc: np.ones(3, bool)}


def model_of(path):
    return path if path in ("schnet", "so3net", "field_schnet") else "painn"


def potential(path="full", forces=True):
    """The trained model of a path and its parameters: PaiNN-128x3 with the
    message form ``path`` ("hybrid" or "full", PaiNN's own default),
    SchNet-128x3 (``path`` "schnet"), SO3net-64x3, lmax 2, with its
    ``PairwiseDistances`` input module (``path`` "so3net"), or PaiNN-128x3
    on the row-9 path with ``PairwiseDistances``: with the trbf fixture's
    trainable Gaussian basis ("painn_trbf") or a Bessel basis
    ("painn_bessel"), or PaiNN-128x3 with ``PairwiseDistances`` for the
    27-cell atom layout ("painn_cell") and the slab path ("painn_slab"),
    or FieldSchNet-128x5 with ``PairwiseDistances`` ("field_schnet");
    without ``forces`` the energy output only (the parameter gradients'
    model)."""
    from schnetpack_tpu_torch.atomistic import (
        Atomwise, Forces, PairwiseDistances,
    )
    from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
    from schnetpack_tpu_torch.model import NeuralNetworkPotential
    from schnetpack_tpu_torch.nn import BesselRBF, GaussianRBF
    from schnetpack_tpu_torch.representation import (
        FieldSchNet, PaiNN, SchNet, SO3net,
    )

    inputs = []
    radial_from = None
    if path == "field_schnet":
        rep = FieldSchNet(n_atom_basis=128, n_interactions=5, n_rbf=20,
                          cutoff=CUTOFF)
        inputs = [PairwiseDistances()]
    elif path == "so3net":
        rep = SO3net(n_atom_basis=64, n_interactions=3, lmax=2, n_rbf=20,
                     cutoff=CUTOFF)
        inputs = [PairwiseDistances()]
    elif path == "schnet":
        rep = SchNet(n_atom_basis=128, n_interactions=3, n_rbf=20,
                     cutoff=CUTOFF)
    elif path in ("painn_trbf", "painn_bessel"):
        trbf = path == "painn_trbf"
        radial = (GaussianRBF(20, CUTOFF, trainable=True) if trbf
                  else BesselRBF(20, CUTOFF))
        rep = PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
                    cutoff=CUTOFF, radial_basis=radial)
        inputs = [PairwiseDistances()]
        radial_from = REFERENCE[path] if trbf else None
    elif path in ("painn_cell", "painn_slab"):
        rep = PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
                    cutoff=CUTOFF)
        inputs = [PairwiseDistances()]
    else:
        rep = PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
                    cutoff=CUTOFF, fuse=path)
    heads = [Atomwise(n_in=rep.n_atom_basis)] + ([Forces()] if forces else [])
    pot = NeuralNetworkPotential(rep, heads, input_modules=inputs)
    return pot, params_from_jax(load_jax_params(ASSET[model_of(path)],
                                                radial_from=radial_from))


def layout_str(state):
    from schnetpack_tpu_torch import properties as P

    if P.cell_qidx in state:
        return f"dims={tuple(state[P.cell_qidx].shape)}"
    nx, ny, Ktot = state[P.cell_qcol].shape
    return (f"dims=({nx}, {ny}, {state['cell_order'].shape[0] // (nx * ny)})"
            f" Ktot={Ktot}")


def calculator(pot, params, jitter=0.25, headroom=1.0 / 12.0,
               layout="column", wgrad=False):
    from schnetpack_tpu_torch.md import CellBlockNeighborListMD
    from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
    from schnetpack_tpu_torch.units import _parse_unit, md_units

    conv = _parse_unit("Ang") * md_units().length
    nbl = CellBlockNeighborListMD(CUTOFF * conv, skin=SKIN * conv,
                                  layout=layout, jitter_fraction=jitter,
                                  bucket_headroom=headroom)
    return SchNetPackCalculator(pot, params, cutoff=CUTOFF, cutoff_shell=SKIN,
                                neighbor_list=nbl, wgrad=wgrad)


def run_inputs(calc, system):
    """(R, coff_fm, refs) of the model's inputs for ``system``."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.ops.colblock import ColRefs

    st = calc.init_state(system)
    inputs = calc.model_inputs(system, st)
    R = inputs[P.R].contiguous()
    qcol = inputs[P.cell_qcol]
    refs = ColRefs(qcol, inputs[P.cell_dcol],
                   R.shape[0] // (qcol.shape[0] * qcol.shape[1]),
                   tuple(inputs[P.cell_ksz]))
    print(f"layout: {layout_str(st)} A'={R.shape[0]}", flush=True)
    return R, inputs[P.cell_coff_fm].contiguous(), refs


def nbytes(*tensors):
    """Bytes of the tensors (nested tuples allowed), each counted once; an
    int stands for that many bytes."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, int):
            total += t
    return total


def bound(n_bytes, flops):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes at the HBM rate and the FP32 operations at the
    FP32 peak."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def geo_flops(B):
    """FP32 operations of one edge's geometry: displacement, distance,
    direction, cosine cutoff and B Gaussians (a transcendental counts 1)."""
    return 4 * B + 30


def geo_bwd_bytes(ggeo, coff, refs, R, cw):
    """The inputs K8 needs: the cotangent's channels and the offsets of
    the real slots only (its slot pass tests qcol and returns at a padded
    slot before it reads anything else), qcol whole, dcol of the real
    slots, the positions and the basis table."""
    ne = real_edges(refs)
    per_slot = ggeo.shape[2] * ggeo.element_size() + 3 * coff.element_size()
    return (ne * (per_slot + refs.dcol.element_size()), refs.qcol, R, cw)


def check_kernels(cases):
    """Each kernel against its twin (rtol/atol elementwise, ``exact``:
    equal), both timed per call (``cuda_ms``), the kernel and ``library``
    (one PyTorch call that computes the same function, where there is one)
    also on the device (``device_ms``), with its bound (from the bytes of
    ``inputs`` and of the kernel's outputs, and ``flops``); returns the
    rows of the kernel table."""
    rows = []
    for c in cases:
        name, kern, plain = c["name"], c["kern"], c["plain"]
        got = kern()
        err = compare(name, got, (c.get("ref") or plain)(),
                      c.get("norm_from"), c.get("exact", False))
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        dev_ms = device_ms(kern)
        lib_ms = lib_dev_ms = None
        if c.get("library"):
            lib_ms = cuda_ms(c["library"])
            lib_dev_ms = device_ms(c["library"])
        bound_ms, bound_by = bound(nbytes(c["inputs"], got), c["flops"])
        lib = ("none" if lib_ms is None
               else f"{lib_ms:.4f} ms (device {lib_dev_ms:.4f})")
        floor = ""
        if c.get("tc_flops"):   # the kernel's own 3xTF32 work
            floor_ms = 1e3 * c["tc_flops"] / TF32_FLOP_PER_S
            floor = f", 3xTF32 floor {floor_ms:.4f} ms"
        print(f"kernel {name}{c.get('tag', '')}: max_abs_err={err:.3e} "
              f"{ms:.4f} ms (device {dev_ms:.4f}; plain twin {plain_ms:.4f} "
              f"ms, library {lib}, bound {bound_ms:.4f} ms by {bound_by}"
              f"{floor})", flush=True)
        row = {"name": name, "route": "cuda",
               "source": f"schnetpack_tpu_torch/csrc/{c['src']}",
               "replaces": f"schnetpack_tpu/ops/{c['replaces']}",
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "library_device_ms": lib_dev_ms}
        if floor:
            row["tf32x3_floor_ms"] = floor_ms
        if c.get("wgrad"):   # the kernel's wgrad instance, also gFW
            (w,) = check_kernels([dict(c, **{"tc_flops": None, **c["wgrad"]},
                                       wgrad=None,
                                       tag=c.get("tag", "") + " (wgrad)")])
            row["wgrad"] = sub_row(w)
        rows.append(row)
    return rows


def sub_row(row):
    """The numbers of a row, for a sub-row of another (a wgrad instance, a
    width, a source-index mode or a layout)."""
    return {k: row[k] for k in SUB_KEYS if k in row}


def case(name, src, replaces, kern, plain, inputs, flops, library=None,
         wgrad=None, exact=False, tc_flops=None):
    """One kernel of the table; ``wgrad`` (``kern``, ``plain``, ``flops``
    and ``ref``, what the kernel is held to, where that is not ``plain``)
    adds its wgrad instance as a sub-row; ``exact``: a copy, held to its
    twin bit for bit; ``tc_flops``: the operations of a kernel that runs
    its products as three TF32 passes on the tensor cores, whose time at
    the TF32 peak is printed beside the FP32 bound as its floor."""
    return {"name": name, "src": src, "replaces": replaces, "kern": kern,
            "plain": plain, "inputs": inputs, "flops": flops,
            "library": library, "wgrad": wgrad, "exact": exact,
            "tc_flops": tc_flops}


def real_edges(refs):
    return int((refs.qcol >= 0).sum())


def live_edges(refs, live):
    """Real slots where ``live`` ([nx, ny, Ktot] or its flat form) holds:
    the slots inside the cutoff, whose filter and message the kernels that
    skip fcut = 0 compute."""
    return int(((refs.qcol >= 0) & live.reshape(refs.qcol.shape)).sum())


def kernel_phase(calc, system, seed, dev):
    """K1-K7 and K15 against their twins at the MD run's shapes; returns
    rows.

    Operations per edge (an FMA counts 2): the filter (B+1) x 3F FMAs, 16F
    for the products and sums of the message, twice both for a backward,
    and the geometry where a kernel computes it, on every real slot; a
    wgrad instance adds the (B+1) x 3F FMAs of gFW.  The filter, message
    and gFW count only the slots inside the cutoff (``live_edges``) for
    K1/K2 and K6/K7, which skip the others (fcut = 0 adds exactly 0), and
    every real slot for K15, which returns each slot's geometry
    cotangent.  Per atom row the mixing's
    22 F^2 (42 F^2 backward: the input cotangents' 22 F^2 and the
    recomputed forward's 20 F^2, which skips the 2 F^2 of the output
    column whose cotangent is the incoming one; the wgrad instance
    another 22 F^2 for the weights' cotangents)."""
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op
    from schnetpack_tpu_torch.ops import colblock_message as msg
    from schnetpack_tpu_torch.ops import painn_mixing as mix

    R, coff, refs = run_inputs(calc, system)
    rep = calc.model.representation
    F, Ap = rep.n_atom_basis, R.shape[0]
    B = rep.cw.shape[0]
    ne = real_edges(refs)
    idx = (refs.qcol, refs.dcol)
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=0.3):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    x, mu = rnd(Ap, 3 * F), rnd(Ap, 3 * F)
    g_dq, g_dmu = rnd(Ap, F, scale=1.0), rnd(Ap, 3 * F, scale=1.0)
    FW = rep.FW_aug[0].contiguous()
    margs = (x, mu, R, FW, coff, rep.cw, refs, rep.cutoff)
    gargs = (R, coff, refs, rep.cw, rep.cutoff)
    geo = geo_op.geo_fwd_kernel(*gargs)
    geo4 = geo_op.geo_fwd_kernel(*gargs, with_d=False)
    hargs = (x, mu, geo, FW, refs)
    bargs = (x, mu, geo, FW, rep.cw, refs, rep.cutoff, g_dq, g_dmu)
    sargs = (x, mu, geo4, FW, refs, g_dq, g_dmu)
    m0 = rep.mixing[0]
    w = (m0.kmix, m0.k0, m0.b0, m0.k1, m0.b1)
    xargs = (rnd(Ap, F, scale=1.0), mu, g_dq * 0.3, g_dmu * 0.3, *w,
             m0.epsilon, m0.activation)
    ni = live_edges(refs, geo[:, :, B + 4] < rep.cutoff)
    print(f"slots: {ne} real, {ni} inside the cutoff", flush=True)
    per_edge, gfw_edge = 6 * F * (B + 1) + 16 * F, 6 * F * (B + 1)
    msg_fwd, gfw = ni * per_edge, ni * gfw_edge
    msg_bwd = 2 * msg_fwd
    src_bwd, src_gfw = 2 * ne * per_edge, ne * gfw_edge   # every slot

    cases = [
        case("msg_fwd", "colblock_message.cu", "colblock_pallas.py:1889",
             lambda: msg.msg_fwd_kernel(*margs),
             lambda: msg.msg_fwd_plain(*margs),
             (x, mu, R, FW, coff, rep.cw, idx), msg_fwd + ne * geo_flops(B)),
        case("msg_bwd", "colblock_message_bwd.cu", "colblock_pallas.py:1239",
             lambda: msg.msg_bwd_kernel(*margs, g_dq, g_dmu),
             lambda: msg.msg_bwd_plain(*margs, g_dq, g_dmu)[:3],
             (x, mu, R, FW, coff, rep.cw, idx, g_dq, g_dmu),
             msg_bwd + 2 * ne * geo_flops(B),
             wgrad={"kern": lambda: msg.msg_bwd_kernel(*margs, g_dq, g_dmu,
                                                       wgrad=True),
                    "plain": lambda: msg.msg_bwd_plain(*margs, g_dq, g_dmu),
                    "ref": lambda: in_f64(msg.msg_bwd_plain, *margs, g_dq,
                                          g_dmu),
                    "flops": msg_bwd + 2 * ne * geo_flops(B) + gfw}),
        case("mix_fwd", "painn_mixing.cu", "painn_mixing.py:73",
             lambda: mix.mix_fwd_kernel(*xargs),
             lambda: mix.painn_mixing_plain(*xargs), xargs[:9],
             22 * F * F * Ap, tc_flops=3 * 22 * F * F * Ap),
        case("mix_bwd", "painn_mixing.cu", "painn_mixing.py:83",
             lambda: mix.mix_bwd_kernel(*xargs, g_dq, g_dmu),
             lambda: mix.painn_mixing_bwd_plain(*xargs, g_dq, g_dmu),
             (xargs[:9], g_dq, g_dmu), 42 * F * F * Ap,
             tc_flops=3 * 42 * F * F * Ap,
             wgrad={"kern": lambda: mix.mix_bwd_kernel(*xargs, g_dq, g_dmu,
                                                       wgrad=True),
                    "plain": lambda: mix.painn_mixing_bwd_plain(
                        *xargs, g_dq, g_dmu, wgrad=True),
                    "ref": lambda: in_f64(
                        lambda *a: mix.painn_mixing_bwd_plain(*a, wgrad=True),
                        *xargs, g_dq, g_dmu),
                    "flops": 64 * F * F * Ap, "norm_from": 2}),
        case("geo_fwd", "colblock_geo.cu", "colblock_geo.py:202",
             lambda: (geo_op.geo_fwd_kernel(*gargs),),
             lambda: (geo_op.geo_fwd_plain(*gargs),),
             (R, coff, idx, rep.cw), ne * geo_flops(B)),
        case("msg_fwd_geo", "colblock_message.cu", "colblock_pallas.py:687",
             lambda: msg.msg_fwd_geo_kernel(*hargs),
             lambda: msg.msg_fwd_geo_plain(*hargs),
             (x, mu, geo, FW, idx), msg_fwd),
        case("msg_bwd_geores", "colblock_message_bwd.cu",
             "colblock_pallas.py:1570",
             lambda: msg.msg_bwd_geores_kernel(*bargs),
             lambda: msg.msg_bwd_geores_plain(*bargs)[:3],
             (x, mu, geo, FW, rep.cw, idx, g_dq, g_dmu),
             msg_bwd + ne * geo_flops(B),
             wgrad={"kern": lambda: msg.msg_bwd_geores_kernel(*bargs,
                                                              wgrad=True),
                    "plain": lambda: msg.msg_bwd_geores_plain(*bargs),
                    "ref": lambda: in_f64(msg.msg_bwd_geores_plain, *bargs),
                    "flops": msg_bwd + ne * geo_flops(B) + gfw}),
        case("msg_bwd_src", "colblock_message_bwd.cu",
             "colblock_pallas.py:834",
             lambda: msg.msg_bwd_src_kernel(*sargs),
             lambda: msg.msg_bwd_src_plain(*sargs)[:3],
             (x, mu, geo4, FW, idx, g_dq, g_dmu), src_bwd,
             wgrad={"kern": lambda: msg.msg_bwd_src_kernel(*sargs,
                                                           wgrad=True),
                    "plain": lambda: msg.msg_bwd_src_plain(*sargs),
                    "ref": lambda: in_f64(msg.msg_bwd_src_plain, *sargs),
                    "flops": src_bwd + src_gfw}),
    ]
    rows = check_kernels(cases)
    del cases
    # K1/K2 at F = 256 on the same layout (random features and weights):
    # sub-rows "F256" of their rows
    F2 = 256
    x2, mu2, FW2 = rnd(Ap, 3 * F2), rnd(Ap, 3 * F2), rnd(B + 1, 3 * F2)
    c2 = (rnd(Ap, F2, scale=1.0), rnd(Ap, 3 * F2, scale=1.0))
    a2 = (x2, mu2, R, FW2, coff, rep.cw, refs, rep.cutoff)
    fwd2 = ni * (6 * F2 * (B + 1) + 16 * F2)
    wide = [
        case("msg_fwd", "colblock_message.cu", "colblock_pallas.py:1889",
             lambda: msg.msg_fwd_kernel(*a2),
             lambda: msg.msg_fwd_plain(*a2),
             (x2, mu2, R, FW2, coff, rep.cw, idx), fwd2 + ne * geo_flops(B)),
        case("msg_bwd", "colblock_message_bwd.cu", "colblock_pallas.py:1239",
             lambda: msg.msg_bwd_kernel(*a2, *c2),
             lambda: msg.msg_bwd_plain(*a2, *c2)[:3],
             (x2, mu2, R, FW2, coff, rep.cw, idx, *c2),
             2 * fwd2 + 2 * ne * geo_flops(B)),
    ]
    for c in wide:
        c["tag"] = " (F = 256)"
    for row, r2 in zip(rows, check_kernels(wide)):
        row["F256"] = sub_row(r2)
    return rows


def schnet_kernel_phase(calc, system, seed, dev):
    """K5 raw, K8, K9 and K10 (and K10's wgrad instance) against their
    twins at the SchNet run's shapes, with the trained SchNet's first
    filter network; returns rows.  The filter network is B x F + F x F FMAs
    per edge, twice that in the backward, and the wgrad instance's
    filter-weight cotangents another B x F + F x F.  K9 needs them only on
    the slots inside the cutoff (``live_edges``: fcut = 0 adds exactly 0
    to its output), K10 on every real slot (its gfcut channel).  K9 and K10
    run these products in 3xTF32 on the tensor cores: their rows and K10's
    wgrad sub-row also carry that floor, three times their products at the
    TF32 peak.  K9 and K10 (both instances) again at F = 64 on the same
    layout, with random features, filter weights and cotangent: sub-rows
    "F64"."""
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op
    from schnetpack_tpu_torch.ops import schnet_columns as cf

    R, coff, refs = run_inputs(calc, system)
    rep = calc.model.representation
    F, Ap, B = rep.n_atom_basis, R.shape[0], rep.n_rbf
    ne = real_edges(refs)
    idx = (refs.qcol, refs.dcol)
    g = torch.Generator().manual_seed(seed + 10)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    gargs = (R, coff, refs, rep.cw, rep.cutoff)
    geo = geo_op.geo_fwd_kernel(*gargs, with_d=False, raw_phi=True)
    ggeo = rnd(*geo.shape)
    i0 = rep.interactions[0]
    assert geo.shape[2] == B + 4
    ni = live_edges(refs, geo[:, :, B] > 0)
    print(f"slots: {ne} real, {ni} inside the cutoff", flush=True)

    def cf_cases(cargs, g_out):
        """K9 and K10 on ``cargs`` (h, geo, W1, b1, W2, b2, refs)."""
        Fc = cargs[0].shape[1]
        filt, live = (2 * n * (B * Fc + Fc * Fc) for n in (ne, ni))
        return [
            case("cf_fwd", "schnet_columns.cu", "schnet_columns.py:79",
                 lambda: (cf.cf_fwd_kernel(*cargs),),
                 lambda: (cf.cf_fwd_plain(*cargs),), (cargs[:6], idx),
                 live + ni * 6 * Fc, tc_flops=3 * live),
            case("cf_bwd", "schnet_columns.cu", "schnet_columns.py:145",
                 lambda: cf.cf_bwd_kernel(*cargs, g_out),
                 lambda: cf.cf_bwd_plain(*cargs, g_out)[:2],
                 (cargs[:6], idx, g_out), 2 * filt + ne * 12 * Fc,
                 tc_flops=3 * 2 * filt,
                 wgrad={"kern": lambda: cf.cf_bwd_kernel(*cargs, g_out,
                                                         wgrad=True),
                        "plain": lambda: cf.cf_bwd_plain(*cargs, g_out),
                        "ref": lambda: in_f64(cf.cf_bwd_plain, *cargs,
                                              g_out),
                        "flops": 3 * filt + ne * 12 * Fc, "norm_from": 2,
                        "tc_flops": 3 * 3 * filt}),
        ]

    cargs = (rnd(Ap, F, scale=0.3), geo,
             i0.filter_0.weight.t().contiguous(), i0.filter_0.bias,
             i0.filter_1.weight.t().contiguous(), i0.filter_1.bias, refs)
    cases = [
        case("geo_fwd_raw", "colblock_geo.cu", "colblock_geo.py:202",
             lambda: (geo_op.geo_fwd_kernel(*gargs, with_d=False,
                                            raw_phi=True),),
             lambda: (geo_op.geo_fwd_plain(*gargs, with_d=False,
                                           raw_phi=True),),
             (R, coff, idx, rep.cw), ne * geo_flops(B)),
        case("geo_bwd", "colblock_geo.cu", "colblock_geo.py:230",
             lambda: (geo_op.geo_bwd_kernel(ggeo, *gargs),),
             lambda: (geo_op.geo_bwd_plain(ggeo, *gargs),),
             geo_bwd_bytes(ggeo, coff, refs, R, rep.cw),
             2 * ne * geo_flops(B)),
        *cf_cases(cargs, rnd(Ap, F)),
    ]
    rows = check_kernels(cases)
    del cases
    F2 = 64
    narrow = cf_cases((rnd(Ap, F2, scale=0.3), geo, rnd(B, F2, scale=0.3),
                       rnd(F2, scale=0.1), rnd(F2, F2, scale=F2 ** -0.5),
                       rnd(F2, scale=0.1), refs), rnd(Ap, F2))
    for c in narrow:
        c["tag"] = " (F = 64)"
    by_name = {row["name"]: row for row in rows}
    for r2 in check_kernels(narrow):
        by_name[r2["name"]]["F64"] = sub_row(r2)
    return rows


def select_kernel_phase(calc, system, seed, dev, widths, tag=""):
    """K11-K14 against their twins at the shapes of the MD run of ``calc``,
    at each width D of ``widths`` (D = 3: the positions, as the table), each
    beside its library call; returns the four rows of each width.  The sums
    are one add per real edge and feature and need only the real slots'
    rows of their input; the copies do no arithmetic."""
    from schnetpack_tpu_torch.ops import colblock_select as sel
    from schnetpack_tpu_torch.ops.colblock import decode_i, decode_j

    R, _, refs = run_inputs(calc, system)
    Ap = R.shape[0]
    ne = real_edges(refs)
    nx, ny, Ktot = refs.qcol.shape
    g = torch.Generator().manual_seed(seed + 20)
    j, jvalid = decode_j(refs)
    i, ivalid = decode_i(refs)
    jf, jm = j.reshape(-1), jvalid.reshape(-1, 1).float()
    if_, im = i.reshape(-1), ivalid.reshape(-1, 1).float()
    jpad = torch.where(jvalid, j, Ap).reshape(-1)
    ipad = torch.where(ivalid, i, Ap).reshape(-1)

    def cases(D, table, edges):
        flat = edges.reshape(-1, D)
        return [
            case("gather_fwd", "colblock_select.cu", "colblock_pallas.py:121",
                 lambda: (sel.gather_fwd_kernel(table, refs),),
                 lambda: (sel.gather_fwd_plain(table, refs),),
                 (table, refs.qcol), 0,
                 lambda: table.index_select(0, jf).mul_(jm), exact=True),
            case("gather_bwd", "colblock_select.cu", "colblock_pallas.py:148",
                 lambda: (sel.gather_bwd_kernel(edges, refs),),
                 lambda: (sel.gather_bwd_plain(edges, refs),),
                 (4 * ne * D, refs.qcol), ne * D,
                 lambda: table.new_zeros((Ap + 1, D)).index_add_(
                     0, jpad, flat)),
            case("expand_fwd", "colblock_select.cu", "colblock_pallas.py:211",
                 lambda: (sel.expand_fwd_kernel(table, refs),),
                 lambda: (sel.expand_fwd_plain(table, refs),),
                 (table, refs.dcol), 0,
                 lambda: table.index_select(0, if_).mul_(im), exact=True),
            case("fold_fwd", "colblock_select.cu", "colblock_pallas.py:244",
                 lambda: (sel.fold_fwd_kernel(edges, refs),),
                 lambda: (sel.fold_fwd_plain(edges, refs),),
                 (4 * ne * D, refs.dcol), ne * D,
                 lambda: table.new_zeros((Ap + 1, D)).index_add_(
                     0, ipad, flat)),
        ]

    out = []
    for D in widths:
        table = (R if D == 3
                 else torch.randn((Ap, D), generator=g).to(dev))
        width = cases(D, table,
                      torch.randn((nx, ny, Ktot, D), generator=g).to(dev))
        for c in width:
            c["tag"] = f" (D = {D}{tag})"
        out.append(check_kernels(width))
        del width
    return out


def cell_kernel_phase(calc, system, seed, dev):
    """K16-K19 against their twins at the painn_cell run's shapes (the
    27-cell layout of the bench box): K16/K17 at D = 3 on the positions and
    a random cotangent, K18/K19 on the rbf_aug and directions of the box's
    own geometry (the cell path's plain torch, zero at padded slots) with
    random features and cotangents from ``seed`` and the trained PaiNN's
    first filter weights; and K3/K4 at this layout's row count (16,000
    slots against the column layout's 12,800), built as in
    ``kernel_phase`` with the first mixing block's weights; returns rows.
    Operations per edge or row as in ``kernel_phase``: K18 counts the
    filter and message on the slots inside the cutoff (a zero basis row
    adds exactly 0), K19 on every real slot, since it returns each slot's
    basis and direction cotangents; K17 is one add per real edge and
    coordinate.  The library calls of K16/K17 take the
    source rows decoded once on the refs, while the kernels decode
    ``qidx`` themselves."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.atomistic.distances import cell_refs
    from schnetpack_tpu_torch.ops import cellblock_gather as cg
    from schnetpack_tpu_torch.ops import painn_fused as pf
    from schnetpack_tpu_torch.ops import painn_mixing as mix

    st = calc.init_state(system)
    inputs = calc.model_inputs(system, st)
    R = inputs[P.R].contiguous()
    refs = cell_refs(inputs)
    rep = calc.model.representation
    with torch.no_grad():
        rbf, dirs = rep._cell_geometry(calc.model.input_modules[0](inputs))
    rbf, dirs = rbf.contiguous(), dirs.contiguous()
    print(f"layout: {layout_str(st)} A'={R.shape[0]}", flush=True)
    F, Ap, K = rep.n_atom_basis, R.shape[0], refs.dims[4]
    B = rbf.shape[-1] - 1
    ne = int((refs.qidx >= 0).sum())
    live = (refs.qidx >= 0).reshape(rbf.shape[:-1]) & (rbf != 0).any(-1)
    ni = int(live.sum())
    g = torch.Generator().manual_seed(seed + 30)

    def rnd(*shape, scale=0.3):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    xmu, g3 = rnd(Ap, 6 * F), rnd(Ap, K, 3, scale=1.0)
    g_dq, g_dmu = rnd(Ap, F, scale=1.0), rnd(Ap, 3 * F, scale=1.0)
    margs = (xmu, rbf, dirs, rep.FW_aug[0].contiguous(), refs)
    j, valid = cg.decode_cell_j(refs)
    jf, jm = j.reshape(-1), valid.reshape(-1, 1).float()
    jpad = torch.where(valid, j, Ap).reshape(-1)
    msg_fwd = ni * (6 * F * (B + 1) + 16 * F)   # K18: live slots
    msg_bwd = 2 * ne * (6 * F * (B + 1) + 16 * F)   # K19: every slot
    gfw = ne * 6 * F * (B + 1)
    m0 = rep.mixing[0]
    xargs = (rnd(Ap, F, scale=1.0), rnd(Ap, 3 * F), g_dq * 0.3, g_dmu * 0.3,
             m0.kmix, m0.k0, m0.b0, m0.k1, m0.b1, m0.epsilon, m0.activation)
    cases = [
        case("mix_fwd", "painn_mixing.cu", "painn_mixing.py:73",
             lambda: mix.mix_fwd_kernel(*xargs),
             lambda: mix.painn_mixing_plain(*xargs), xargs[:9],
             22 * F * F * Ap, tc_flops=3 * 22 * F * F * Ap),
        case("mix_bwd", "painn_mixing.cu", "painn_mixing.py:83",
             lambda: mix.mix_bwd_kernel(*xargs, g_dq, g_dmu),
             lambda: mix.painn_mixing_bwd_plain(*xargs, g_dq, g_dmu),
             (xargs[:9], g_dq, g_dmu), 42 * F * F * Ap,
             tc_flops=3 * 42 * F * F * Ap),
        case("cell_gather_fwd", "colblock_select.cu",
             "cellblock_pallas.py:88",
             lambda: (cg.cell_gather_fwd_kernel(R, refs),),
             lambda: (cg.cell_gather_plain(R, refs),), (R, refs.qidx), 0,
             lambda: R.index_select(0, jf).mul_(jm)),
        case("cell_gather_bwd", "colblock_select.cu",
             "cellblock_pallas.py:143",
             lambda: (cg.cell_gather_bwd_kernel(g3, refs),),
             lambda: (cg.cell_gather_bwd_plain(g3, refs),),
             (4 * ne * 3, refs.qidx), ne * 3,
             lambda: R.new_zeros((Ap + 1, 3)).index_add_(
                 0, jpad, g3.reshape(-1, 3))),
        case("cell_msg_fwd", "colblock_message.cu", "painn_fused.py:116",
             lambda: pf.cell_msg_fwd_kernel(*margs),
             lambda: pf.cell_msg_fwd_plain(*margs),
             (margs[:4], refs.qidx), msg_fwd),
        case("cell_msg_bwd", "colblock_message_bwd.cu", "painn_fused.py:185",
             lambda: pf.cell_msg_bwd_kernel(*margs, g_dq, g_dmu),
             lambda: pf.cell_msg_bwd_plain(*margs, g_dq, g_dmu)[:3],
             (margs[:4], refs.qidx, g_dq, g_dmu), msg_bwd,
             wgrad={"kern": lambda: pf.cell_msg_bwd_kernel(
                        *margs, g_dq, g_dmu, wgrad=True),
                    "plain": lambda: pf.cell_msg_bwd_plain(*margs, g_dq,
                                                           g_dmu),
                    "ref": lambda: in_f64(pf.cell_msg_bwd_plain, *margs,
                                          g_dq, g_dmu),
                    "flops": msg_bwd + gfw}),
    ]
    for c in cases[:2]:
        c["tag"] = f" (27-cell, A' = {Ap})"
    return check_kernels(cases)


def slab_simulator(pos, cell, dev, pot=None, params=None):
    """The port's ``SpatialColumnSimulator`` of the bench box on one card
    (the trained PaiNN-128x3 unless ``pot`` is given)."""
    from schnetpack_tpu_torch.parallel import (
        SpatialColumnSimulator, make_column_mesh,
    )
    from schnetpack_tpu_torch.transform.atomistic import ATOMIC_MASSES

    if pot is None:
        pot, params = potential("painn_slab")
    pot.load_state_dict(params)
    n = len(pos)
    return SpatialColumnSimulator(
        pot, params, pos, np.full(n, 18), np.full(n, ATOMIC_MASSES[18]), cell,
        make_column_mesh(1, device=dev), cutoff=CUTOFF, skin=SKIN,
        dt=SLAB_DT)


def slab_temperature(masses, p):
    """The instantaneous temperature (K) of momenta p (amu Ang / 10.18 fs)."""
    return float((p ** 2 / masses[:, None]).sum() / (3 * len(p) * KB_EV))


def slab_momenta(sim, seed):
    """Maxwell-Boltzmann momenta at SLAB_T0 from ``seed`` (numpy), no net
    momentum, rescaled to SLAB_T0 exactly, into the simulator."""
    rng = np.random.RandomState(seed + 1)
    m = sim.masses[:, None]
    p = rng.standard_normal(sim.R.shape) * np.sqrt(m * KB_EV * SLAB_T0)
    p -= m * (p.sum(0) / m.sum())
    sim.p = p * np.sqrt(SLAB_T0 / slab_temperature(sim.masses, p))


def slab_inputs(sim, R, dev):
    """(layout, model inputs) of the slab path at positions ``R`` with the
    simulator's grid and sticky capacities."""
    from schnetpack_tpu_torch.parallel import column_inputs

    sim.R = np.asarray(R, np.float64)
    lay = sim.layout()
    return lay, column_inputs(lay, sim.R, sim.Z, device=dev)


def edge_kernel_phase(pos, cell, seed, dev):
    """K20, K21 (and K21's wgrad instance) in the three source-index modes
    and K11/K12 in the two halo modes (D = 3) against their twins on the
    painn_slab layout of the bench box: the basis and directions of the
    box's own geometry (the slab path's plain torch), random xmu over each
    mode's source table and random cotangents from ``seed``, the trained
    PaiNN's first filter weights; returns K20's and K21's rows in the
    path's mode (halo_x), the others under "modes", and K11's and K12's
    results per halo mode (for their rows' "modes").  Operations per
    edge as in ``kernel_phase``: K20 (and K6) counts the filter and
    message on the slots inside the cutoff, K21 (as K15) on every real
    slot; K12 is one add per real edge and
    coordinate, the library calls of K11/K12 take the decoded halo
    rows."""
    import dataclasses

    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.atomistic.distances import column_refs
    from schnetpack_tpu_torch.ops import colblock_edge as edge
    from schnetpack_tpu_torch.ops import colblock_select as sel
    from schnetpack_tpu_torch.ops.colblock import decode_src
    from schnetpack_tpu_torch.ops.colblock_shard import COLS_AXIS, COLS_AXIS_Y

    sim = slab_simulator(pos, cell, dev)
    lay, inputs = slab_inputs(sim, pos, dev)
    pot = sim.pot.to(dev)
    with torch.no_grad():
        rep = pot.representation
        inputs = pot.input_modules[0](inputs)
        rbf, dirs = rep._edge_geometry(inputs, P.col_rij,
                                       inputs[P.cell_emask])
    rbf, dirs = rbf.contiguous(), dirs.contiguous()
    refs0 = column_refs(inputs)
    nx, ny, Ktot = refs0.qcol.shape
    print(f"layout (painn_slab): dims=({nx}, {ny}, {refs0.P}) Ktot={Ktot} "
          f"A'={nx * ny * refs0.P}", flush=True)
    F, B = rep.n_atom_basis, rbf.shape[-1] - 1
    ne = real_edges(refs0)
    ni = live_edges(refs0, (rbf != 0).any(-1))
    FW = rep.FW_aug[0].detach().contiguous()
    g = torch.Generator().manual_seed(seed + 40)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    g_dq, g_dmu = rnd(nx * ny * refs0.P, F), rnd(nx * ny * refs0.P, 3 * F)
    msg_fwd = ni * (6 * F * (B + 1) + 16 * F)   # K20 skips fcut = 0
    msg_bwd = 2 * ne * (6 * F * (B + 1) + 16 * F)   # K21: every slot
    gfw = ne * 6 * F * (B + 1)
    idx = (refs0.qcol, refs0.dcol)
    rows, modes = {}, {}
    for mode, axis in [("halo_x", COLS_AXIS), ("wrap", None),
                       ("halo_xy", (COLS_AXIS, COLS_AXIS_Y))]:
        refs = dataclasses.replace(refs0, shard_axis=axis, cache={})
        n_src = refs.src_rows
        xmu = rnd(n_src, 6 * F, scale=0.3)
        margs = (xmu, rbf, dirs, FW, refs)
        cases = [
            case("msg_fwd_edge", "colblock_message.cu",
                 "colblock_pallas.py:322",
                 lambda: edge.msg_fwd_edge_kernel(*margs),
                 lambda: edge.msg_fwd_edge_plain(*margs),
                 (margs[:4], idx), msg_fwd),
            case("msg_bwd_edge", "colblock_message_bwd.cu",
                 "colblock_pallas.py:391",
                 lambda: edge.msg_bwd_edge_kernel(*margs, g_dq, g_dmu),
                 lambda: edge.msg_bwd_edge_plain(*margs, g_dq, g_dmu)[:3],
                 (margs[:4], idx, g_dq, g_dmu), msg_bwd,
                 wgrad={"kern": lambda: edge.msg_bwd_edge_kernel(
                            *margs, g_dq, g_dmu, wgrad=True),
                        "plain": lambda: edge.msg_bwd_edge_plain(
                            *margs, g_dq, g_dmu),
                        "ref": lambda: in_f64(edge.msg_bwd_edge_plain,
                                              *margs, g_dq, g_dmu),
                        "flops": msg_bwd + gfw}),
        ]
        if mode != "wrap":
            table = rnd(n_src, 3)
            g3 = rnd(nx, ny, Ktot, 3)
            j, valid = decode_src(refs)
            jf, jm = j.reshape(-1), valid.reshape(-1, 1).float()
            jpad = torch.where(valid, j, n_src).reshape(-1)
            cases += [
                case("gather_fwd", "colblock_select.cu",
                     "colblock_shard.py:131",
                     lambda: (sel.gather_fwd_kernel(table, refs),),
                     lambda: (sel.gather_fwd_plain(table, refs),),
                     (table, refs.qcol), 0,
                     lambda: table.index_select(0, jf).mul_(jm),
                     exact=True),
                case("gather_bwd", "colblock_select.cu",
                     "colblock_shard.py:154",
                     lambda: (sel.gather_bwd_kernel(g3, refs),),
                     lambda: (sel.gather_bwd_plain(g3, refs),),
                     (4 * ne * 3, refs.qcol), ne * 3,
                     lambda: table.new_zeros((n_src + 1, 3)).index_add_(
                         0, jpad, g3.reshape(-1, 3))),
            ]
        for c in cases:
            c["tag"] = f" ({mode})"
        for row in check_kernels(cases):
            if mode == "halo_x" and row["name"].startswith("msg"):
                rows[row["name"]] = row
            else:
                modes.setdefault(row["name"], {})[mode] = sub_row(row)
    for name, row in rows.items():
        row["modes"] = modes.pop(name)
    return list(rows.values()), modes


def slab_reference_phase(dev):
    """PaiNN on the slab path through ``make_sharded_column_eval`` on one
    card against ``port_ref_painn_argon.npz``; returns its forces in the
    original atom order."""
    from schnetpack_tpu_torch.parallel import make_sharded_column_eval

    ref = np.load(REFERENCE["full"])
    sim = slab_simulator(ref["R"].astype(np.float64), ref["cell"], dev)
    lay, inputs = slab_inputs(sim, ref["R"], dev)
    E, Fs = make_sharded_column_eval(sim.pot, sim.params, inputs,
                                     sim.mesh)(inputs)
    F = Fs.detach().cpu().numpy()[lay.rank]
    E = float(E[0])
    rms = float(np.sqrt(np.mean((F - ref["forces"]) ** 2)))
    dE = abs(E - float(ref["energy"])) / abs(float(ref["energy"]))
    nx, ny, _ = lay.qcol.shape
    print(f"reference (painn_slab, dims=({nx}, {ny}, {lay.dims[2]}) "
          f"Ktot={lay.qcol.shape[2]}): force rms err {rms:.3e} eV/Ang (max "
          f"{np.abs(F - ref['forces']).max():.3e}), energy {E:.6f} vs "
          f"{float(ref['energy']):.6f} eV (rel {dE:.2e})", flush=True)
    assert np.isfinite(F).all() and F.shape == ref["forces"].shape
    assert rms <= FORCE_RMS_TOL, f"painn_slab: force rms {rms}"
    assert dE <= ENERGY_RTOL, f"painn_slab: energy rel err {dE}"
    return F


def grad_phase(dev, launches):
    """The energy's gradient with respect to every parameter on each path
    of ``GRAD_REFERENCE`` against its JAX fixture, with the launches of one
    evaluation (counts set to 0 just before it, read just after); returns
    the launch counts summed over the paths."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.md import load_molecules

    total = {}
    for path, fixture in GRAD_REFERENCE.items():
        ref = np.load(fixture)
        pot, params = potential(path, forces=False)
        fpot, _ = potential(path)
        if path == "painn_slab":
            sim = slab_simulator(ref["R"].astype(np.float64), ref["cell"],
                                 dev, pot, params)
            _, inputs = slab_inputs(sim, ref["R"], dev)
            pot.to(dev)
        else:
            calc = calculator(pot, params, wgrad=True)
            system = load_molecules([molecule(ref["R"].astype(np.float64),
                                              ref["cell"])], device=dev)
            inputs = calc.model_inputs(system, calc.init_state(system))
        fpot.load_state_dict(params)
        fpot.to(dev).requires_grad_(False)
        names, leaves = zip(*pot.named_parameters())

        def evaluate():
            E = pot(dict(inputs))[P.energy][0]
            return E, torch.autograd.grad(E, leaves)

        for counts in launches:
            for k in counts:
                counts[k] = 0
        E, grads = evaluate()
        torch.cuda.synchronize()
        counts = {k: v for c in launches for k, v in c.items() if v}
        assert counts == GRAD_LAUNCHES[path], (
            f"{path} gradient: launches {counts}, want "
            f"{GRAD_LAUNCHES[path]}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        norms = {n: float(np.linalg.norm(ref[f"grad/{n}"])) for n in names}
        floor = GRAD_FLOOR * max(norms.values())
        errs = {n: float(np.linalg.norm(g.double().cpu().numpy()
                                        - ref[f"grad/{n}"]))
                / max(norms[n], floor) for n, g in zip(names, grads)}
        worst = max(errs, key=errs.get)
        dE = (abs(float(E.detach()) - float(ref["energy"]))
              / abs(float(ref["energy"])))
        grad_ms = cuda_ms(evaluate, reps=5)
        force_ms = cuda_ms(lambda: fpot(dict(inputs)), reps=5)
        print(f"gradient ({path}): {len(names)} leaves, worst {worst} "
              f"||dg||/||g|| {errs[worst]:.3e} (|g| {norms[worst]:.3e}), "
              f"energy rel err {dE:.2e}; energy + parameter gradient "
              f"{grad_ms:.3f} ms, frozen energy + forces {force_ms:.3f} ms",
              flush=True)
        assert set(f"grad/{n}" for n in names) == {
            k for k in ref.files if k.startswith("grad/")}
        assert all(np.isfinite(g.cpu().numpy()).all() for g in grads)
        assert errs[worst] <= GRAD_RTOL, f"{path}: {worst} {errs[worst]}"
        assert dE <= ENERGY_RTOL, f"{path}: energy rel err {dE}"
    return total


def slab_md_phase(pos, cell, steps, seed, dev, launches):
    """NVE on the slab path through ``SpatialColumnSimulator``; returns
    (launch counts, ms/step).  The counts are set to 0 before each chunk
    and read after it; the total energy is evaluated at the chunk
    boundaries, outside them.  The ms/step is the chunks' CUDA-event time
    over the steps, without the host re-bins (printed apart)."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.parallel import make_sharded_column_eval

    sim = slab_simulator(pos, cell, dev)
    slab_momenta(sim, seed)
    A = len(pos)

    def temperature(p_):
        return slab_temperature(sim.masses, p_)

    def total_energy():
        lay, inputs = slab_inputs(sim, sim.R, dev)
        E, _ = make_sharded_column_eval(sim.pot, None, inputs,
                                        sim.mesh)(inputs)
        return float(E[0]) + 1.5 * A * KB_EV * temperature(sim.p)

    E_tot = [total_energy()]
    counts = {}
    n_chunks = -(-steps // SLAB_CHUNK)
    for _ in range(n_chunks):
        for c in launches:
            for k in c:
                c[k] = 0
        sim.simulate(SLAB_CHUNK, chunk_size=SLAB_CHUNK)
        torch.cuda.synchronize()
        for c in launches:
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
        E_tot.append(total_energy())
    ms_step = sum(sim.chunk_ms) / (n_chunks * SLAB_CHUNK)
    T = temperature(sim.p)
    drift = float(np.abs(np.asarray(E_tot) - E_tot[0]).max()) / A
    lay = sim.layout()
    print(f"md (painn_slab): {n_chunks * SLAB_CHUNK} steps, {A} atoms, "
          f"dims={lay.dims[:3]} Ktot={lay.qcol.shape[2]}, ms/step (CUDA "
          f"events, chunks only) {ms_step:.3f}, {A / (ms_step * 1e-3):.4g} "
          f"atom-steps/s, host re-bins {sim.rebuilds} in "
          f"{sim.host_seconds:.3f} s wall, T_end={T:.2f} K, max |E_tot - "
          f"E_tot(0)| at the chunk boundaries = {drift:.3e} eV/atom",
          flush=True)
    assert np.isfinite(sim.R).all(), "non-finite positions"
    assert 0.0 < T < 300.0, f"temperature {T} K"
    assert drift <= DRIFT_TOL, f"energy drift {drift} eV/atom"
    evals = n_chunks * (SLAB_CHUNK + 1)
    for k, v in counts.items():
        want = PER_STEP["painn_slab"].get(k, 0) * evals
        assert v == want, f"painn_slab: {k} launched {v} times, want {want}"
    return counts, ms_step


def layout_of(path):
    """The neighbor-list layout of an MD path."""
    return "atom" if path == "painn_cell" else "column"


def reference_phase(dev):
    """Both PaiNN message forms, SchNet, SO3net, PaiNN's row-9 path with a
    trainable Gaussian and a Bessel basis, PaiNN on the 27-cell layout and
    on the slab path against their JAX references; forces per path."""
    from schnetpack_tpu_torch.md import load_molecules

    out = {}
    for path in REFERENCE:
        ref = np.load(REFERENCE[path])
        pot, params = potential(path)
        calc = calculator(pot, params, layout=layout_of(path))
        system = load_molecules([molecule(ref["R"].astype(np.float64),
                                          ref["cell"])], device=dev)
        system = calc.calculate(system, calc.init_state(system))
        F = (system.forces[0] / calc.force_conversion).cpu().numpy()
        E = float(system.energy[0, 0]) / calc.energy_conversion
        rms = float(np.sqrt(np.mean((F - ref["forces"]) ** 2)))
        dE = abs(E - float(ref["energy"])) / abs(float(ref["energy"]))
        print(f"reference ({path}): force rms err {rms:.3e} eV/Ang (max "
              f"{np.abs(F - ref['forces']).max():.3e}), energy {E:.6f} vs "
              f"{float(ref['energy']):.6f} eV (rel {dE:.2e})", flush=True)
        assert np.isfinite(F).all() and F.shape == ref["forces"].shape
        assert rms <= FORCE_RMS_TOL, f"{path}: force rms {rms}"
        assert dE <= ENERGY_RTOL, f"{path}: energy rel err {dE}"
        out[path] = F
    out["painn_slab"] = slab_reference_phase(dev)
    for other in ("hybrid", "painn_cell", "painn_slab"):
        d = out[other] - out["full"]
        print(f"{other} vs full forces: rms {np.sqrt(np.mean(d ** 2)):.3e}, "
              f"max {np.abs(d).max():.3e} eV/Ang", flush=True)


def edge_keys(state, A, inv_cell):
    """Sorted int64 keys (original i, original j, periodic shift) of every
    edge of a column neighbor state."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.ops.colblock import ColRefs, decode_i, decode_j

    qcol = state[P.cell_qcol]
    nx, ny, _ = qcol.shape
    refs = ColRefs(qcol, state[P.cell_dcol],
                   state["cell_order"].shape[0] // (nx * ny),
                   tuple(state[P.cell_ksz]))
    j, valid = decode_j(refs)
    i, _ = decode_i(refs)
    order = state["cell_order"]
    shift = torch.round(state[P.cell_coff_fm].movedim(2, 3) @ inv_cell)
    code = ((shift.long() + 1)
            * torch.tensor([9, 3, 1], device=shift.device)).sum(-1)
    keys = (order[i] * A + order[j]) * 27 + code
    return torch.sort(keys[valid]).values


def rebuild_phase(seed, dev):
    """Device rebuild against a host build on a jittered lattice."""
    from schnetpack_tpu_torch.md import load_molecules
    from schnetpack_tpu_torch.ops.colblock_rebuild import rebin_and_rebuild

    pos, cell = fcc_box(10_000)
    pot, params = potential("hybrid")
    calc = calculator(pot, params, jitter=0.5, headroom=1.0 / 6.0)
    nbl = calc.nbl
    system = load_molecules([molecule(pos, cell)], device=dev)
    calc.init_state(system)
    jit = np.random.RandomState(seed + 2).uniform(
        -REBUILD_JITTER, REBUILD_JITTER, pos.shape) * calc.position_conversion
    moved = system.replace(positions=system.positions + torch.as_tensor(
        jit[None], dtype=system.positions.dtype, device=dev))
    assert nbl._dev_rebuild is not None, "the bench box should be eligible"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assert nbl.maybe_rebuild(moved), "the skin check did not fire"
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    assert (nbl.n_builds, nbl.n_device_builds) == (1, 1), (
        f"host {nbl.n_builds}, device {nbl.n_device_builds}, overflows "
        f"{nbl.n_device_overflows}")
    st_dev = nbl.state()
    info = nbl._dev_rebuild
    dev_ms = cuda_ms(lambda: rebin_and_rebuild(
        moved.positions, st_dev["cell_order"], st_dev["cell_atom_mask"],
        st_dev["cell_Z"], st_dev["cell_idx_m"], info["cell"], info["nx"],
        info["ny"], info["P"], info["ks"], info["rc"]))
    F_dev = calc.calculate(moved, st_dev).forces[0]
    t0 = time.perf_counter()
    nbl.build(moved)
    host_s = time.perf_counter() - t0
    st_host = nbl.state()
    F_host = calc.calculate(moved, st_host).forces[0]

    inv_cell = torch.linalg.inv(info["cell"])
    keys = [edge_keys(st, pos.shape[0], inv_cell) for st in (st_dev, st_host)]
    rms = float(((F_dev - F_host) / calc.force_conversion).pow(2).mean()
                .sqrt())
    print(f"device rebuild: {keys[0].numel()} edges (host {keys[1].numel()}),"
          f" {layout_str(st_dev)}; first call {first_ms:.3f} ms wall, steady "
          f"{dev_ms:.3f} ms (CUDA events); host build {host_s:.3f} s; force "
          f"rms device vs host {rms:.3e} eV/Ang", flush=True)
    assert torch.equal(keys[0], keys[1]), "device and host edge sets differ"
    assert rms <= REBUILD_FORCE_RMS_TOL, f"force rms {rms}"


def md_phase(path, pos, cell, steps, seed, dev, launches):
    """NVE run on one path of ``PATHS``; returns (launch counts,
    ms/step).  The ms/step is the CUDA-event time of the run over the
    steps, host rebuilds included; for painn_cell, whose rebuilds all run
    on the host, it is also printed with their wall time subtracted."""
    from schnetpack_tpu_torch.md import (
        MaxwellBoltzmannInit, Simulator, VelocityVerlet, load_molecules,
    )
    from schnetpack_tpu_torch.units import md_units

    pot, params = potential(path)
    calc = calculator(pot, params, layout=layout_of(path))
    nbl = calc.nbl
    system = load_molecules([molecule(pos, cell)], device=dev)
    system = MaxwellBoltzmannInit(30.0).initialize_system(
        system, torch.Generator().manual_seed(seed + 1))
    sim = Simulator(system, VelocityVerlet(0.5), calc)
    sim.simulate(100, chunk_size=100)            # warm-up (equilibration)
    nbl.retighten(sim.system, jitter_fraction=0.05,
                  bucket_headroom=1.0 / 24.0)
    sim.calc_state = nbl.state()
    print(f"md ({path}) after retighten: {layout_str(sim.calc_state)}",
          flush=True)
    builds0 = (nbl.n_builds, nbl.n_device_builds, nbl.n_device_overflows)
    build_s0 = nbl.build_seconds
    for counts in launches:
        for k in counts:
            counts[k] = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    sim.simulate(steps, chunk_size=100)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms_step = start.elapsed_time(end) / steps
    counts = {k: v for c in launches for k, v in c.items()}
    host, device, overflows = (
        a - b for a, b in zip((nbl.n_builds, nbl.n_device_builds,
                               nbl.n_device_overflows), builds0))
    host_s = nbl.build_seconds - build_s0

    s = sim.system
    A = s.total_atoms
    R = s.positions.cpu().numpy()
    T = float(s.temperature.mean())
    logs = sim.logs[-(steps // 100):]
    E_pot = np.concatenate([lg["energy"][:, 0, 0] for lg in logs])
    T_log = np.concatenate([lg["temperature"][:, 0, 0] for lg in logs])
    E_kin = 1.5 * A * md_units().kB * T_log            # MD energy units
    E_tot = (E_pot + E_kin) / calc.energy_conversion   # eV
    drift = float(np.abs(E_tot - E_tot[0]).max()) / A
    print(f"md ({path}): {steps} steps, {A} atoms, ms/step (CUDA events) "
          f"{ms_step:.3f}, wall {1e3 * wall / steps:.3f} ms/step, "
          f"{A / (ms_step * 1e-3):.4g} atom-steps/s, T_end={T:.2f} K, "
          f"max |E_tot - E_tot(0)| = {drift:.3e} eV/atom, rebuilds: "
          f"{device} on the device, {host} on the host ({host_s:.3f} s "
          f"wall), {overflows} overflows; ms/step without the host builds "
          f"{ms_step - 1e3 * host_s / steps:.3f}", flush=True)
    assert np.isfinite(R).all(), "non-finite positions"
    assert 0.0 < T < 300.0, f"temperature {T} K"
    assert drift <= DRIFT_TOL, f"energy drift {drift} eV/atom"
    for k, v in counts.items():
        want = PER_STEP[path].get(k, 0) * steps
        assert v == want, f"{path}: {k} launched {v} times, want {want}"
    if layout_of(path) == "atom":
        assert device == 0, f"{device} device rebuilds on the atom layout"
    else:
        assert host == overflows, (
            f"{host} host rebuilds after the retighten, {overflows} "
            "overflows")
    return counts, ms_step


def reset(launches):
    for counts in launches:
        for k in counts:
            counts[k] = 0


def read_counts(launches):
    return {k: v for c in launches for k, v in c.items()}


def timed_run(sim, steps, chunk_size=100):
    """``sim.simulate(steps)`` between CUDA events; (ms/step, peak GiB)."""
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    sim.simulate(steps, chunk_size=chunk_size)
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / steps,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def check_launches(name, counts, per_step, evals):
    for k, v in counts.items():
        want = per_step.get(k, 0) * evals
        assert v == want, f"{name}: {k} launched {v} times, want {want}"


def nvt_phase(name, pos, cell, seed, dev, launches, smi, start=None):
    """PaiNN full under a thermostat (phase 7), from Maxwell-Boltzmann
    momenta or from the system ``start``; NHC also holds its extended
    energy and its mean temperature against an NVE run from ``start``.
    Returns (launch counts, the final system, ms/step on CUDA events,
    ms/step on the simulator's ``wall_seconds``)."""
    from schnetpack_tpu_torch.md import (
        MaxwellBoltzmannInit, Simulator, VelocityVerlet, load_molecules,
    )
    from schnetpack_tpu_torch.md.simulation_hooks import (
        LangevinThermostat, NHCThermostat,
    )

    calc = calculator(*potential("full"))
    nbl = calc.nbl
    system = start
    if system is None:
        system = MaxwellBoltzmannInit(T_BATH).initialize_system(
            load_molecules([molecule(pos, cell)], device=dev),
            torch.Generator().manual_seed(seed + 1))
    nhc = name == "painn_nvt_nhc"
    hook = (NHCThermostat if nhc else LangevinThermostat)(
        T_BATH, time_constant=TAU_FS)
    ext = ExtendedEnergy(hook) if nhc else None
    sim = Simulator(system, VelocityVerlet(0.5), calc,
                    simulator_hooks=[hook] + ([ext] if nhc else []),
                    seed=seed)
    sim.simulate(0)                              # first forces, hook state
    reset(launches)
    builds0 = (nbl.n_builds, nbl.n_device_builds)
    ms_step, peak = timed_run(sim, NVT_STEPS, NVT_CHUNK)
    wall_ms = 1e3 * sim.wall_seconds / NVT_STEPS
    counts = read_counts(launches)
    A = sim.system.total_atoms
    T = np.concatenate([lg["temperature"][:, 0, 0] for lg in sim.logs])
    T_mean = float(T[-NVT_AVG:].mean())
    line = (f"md ({name}): {NVT_STEPS} steps, {A} atoms, ms/step (CUDA "
            f"events) {ms_step:.3f} (wall_seconds {wall_ms:.3f}), "
            f"{A / (ms_step * 1e-3):.4g} "
            f"atom-steps/s, mean T of the last {NVT_AVG} steps {T_mean:.3f} "
            f"K (bath {T_BATH} K; T from {T.min():.2f} to {T.max():.2f} K), "
            f"rebuilds: {nbl.n_device_builds - builds0[1]} on the device, "
            f"{nbl.n_builds - builds0[0]} on the host, peak device memory "
            f"{peak:.2f} GiB")
    assert np.isfinite(sim.system.positions.cpu().numpy()).all()
    assert abs(T_mean - T_BATH) <= NVT_TOL[name], f"{name}: mean T {T_mean}"
    assert 0.0 < T.min() and T.max() < 300.0, f"{name}: T {T.min()} {T.max()}"
    check_launches(name, counts, PER_STEP["full"], NVT_STEPS)
    if nhc:
        H = np.asarray(ext.values) / calc.energy_conversion
        drift = float(np.abs(H - H[0]).max()) / A
        # the control: no thermostat, from the same state
        ctl = Simulator(system, VelocityVerlet(0.5), calc, seed=seed)
        ctl.simulate(0)
        reset(launches)
        ctl_ms, _ = timed_run(ctl, NVT_STEPS, NVT_CHUNK)
        check_launches(f"{name} (NVE control)", read_counts(launches),
                       PER_STEP["full"], NVT_STEPS)
        T_nve = float(np.concatenate([lg["temperature"][:, 0, 0]
                                      for lg in ctl.logs])[-NVT_AVG:].mean())
        line += (f", extended-energy drift {drift:.3e} eV/atom at the "
                 f"{NVT_CHUNK}-step chunks' ends; NVE control from the same "
                 f"state: mean T {T_nve:.3f} K, ms/step {ctl_ms:.3f}")
        assert drift <= NHC_DRIFT_TOL, f"NHC extended-energy drift {drift}"
        assert (abs(T_mean - T_BATH) + NHC_MARGIN
                <= abs(T_nve - T_BATH)), f"NHC {T_mean} K vs NVE {T_nve} K"
    print(f"{line}; {smi}", flush=True)
    return counts, sim.system, ms_step, wall_ms


class ExtendedEnergy:
    """A host hook that records an NHC run's conserved energy, the kinetic
    and potential energy plus the chains' share (``chain_energy``), in
    float64 MD units, at the start and at the end of every chunk."""

    def __init__(self, thermostat):
        self.thermostat = thermostat
        self.values = []

    def _record(self, sim):
        s = sim.system
        state = sim.hook_states[sim.device_hooks.index(self.thermostat)]
        self.values.append(float(
            s.kinetic_energy.double().sum() + s.energy.double().sum()
            + self.thermostat.chain_energy(state, s)))

    def on_simulation_start(self, sim):
        if not self.values:
            self._record(sim)

    def process_chunk(self, sim, logs, start_step):
        self._record(sim)

    def on_simulation_end(self, sim):
        pass


class RingEnergy:
    """A device hook that records the ring-polymer energy sum_k [KE_k +
    V_k] + 1/2 sum_k m w_k^2 |q~_k|^2 (float64, MD units) before the first
    step and after every step, as device scalars."""

    def __init__(self, integrator):
        from schnetpack_tpu_torch.md.utils import normal_mode_frequencies

        self.nm = integrator.transformer
        self.w2 = normal_mode_frequencies(
            integrator.n_beads, integrator.omega_P) ** 2
        self.values = []

    def init_state(self, system, dt):
        return 0

    def apply(self, state, system, generator, dt):
        if state == 0 or state % 2 == 1:
            p = system.momenta.double()
            m = system.masses.double()[None, :, None]
            qn = self.nm.beads2normal(system.positions.double())
            w2 = torch.as_tensor(self.w2, device=qn.device)[:, None, None]
            self.values.append((0.5 * p * p / m).sum()
                               + system.energy.double().sum()
                               + 0.5 * (m * w2 * qn * qn).sum())
        return state + 1, system


def blocked_parity_phase(dev):
    """The replica-blocked calculator against one-replica evaluations, bead
    0 against the JAX fixture (phase 8)."""
    from schnetpack_tpu_torch.md import load_molecules

    ref = np.load(REFERENCE["full"])
    calc = calculator(*potential("full"))
    R = ref["R"].astype(np.float64)
    offsets = np.random.RandomState(7).uniform(
        -BEAD_OFFSET, BEAD_OFFSET, (N_BEADS,) + R.shape)
    offsets[0] = 0.0
    system = load_molecules([molecule(R, ref["cell"])], n_replicas=N_BEADS,
                            device=dev)
    system = system.replace(positions=torch.as_tensor(
        (R[None] + offsets) * calc.position_conversion,
        dtype=system.positions.dtype, device=dev))
    state = calc.init_state(system)
    blocked = calc.calculate(system, state)
    to_ev = 1.0 / calc.force_conversion
    err = 0.0
    for r in range(N_BEADS):
        one = calc.calculate(system.replace(
            positions=system.positions[r:r + 1],
            forces=system.forces[r:r + 1], energy=system.energy[r:r + 1]),
            state)
        err = max(err, float((blocked.forces[r] - one.forces[0]).abs().max())
                  * to_ev)
    F0 = (blocked.forces[0] * to_ev).cpu().numpy()
    E0 = float(blocked.energy[0, 0]) / calc.energy_conversion
    rms = float(np.sqrt(np.mean((F0 - ref["forces"]) ** 2)))
    dE = abs(E0 - float(ref["energy"])) / abs(float(ref["energy"]))
    print(f"blocked calculator ({N_BEADS} beads, {layout_str(state)}): max "
          f"|F_blocked - F_one| {err:.3e} eV/Ang; bead 0 vs the fixture: "
          f"force rms {rms:.3e} eV/Ang, energy rel {dE:.2e}", flush=True)
    assert err <= BEAD_FORCE_ATOL, f"blocked vs one replica {err}"
    assert rms <= FORCE_RMS_TOL, f"bead 0 force rms {rms}"
    assert dE <= ENERGY_RTOL, f"bead 0 energy rel err {dE}"


def rpmd_phase(pos, cell, seed, dev, launches, smi):
    """8-bead ring-polymer MD of the bench box (phase 8): NVE, then under
    PILE-L; returns launch counts."""
    from schnetpack_tpu_torch.md import (
        MaxwellBoltzmannInit, RingPolymer, Simulator, load_molecules,
    )
    from schnetpack_tpu_torch.md.simulation_hooks import PILELocalThermostat

    blocked_parity_phase(dev)
    calc = calculator(*potential("full"))
    nbl = calc.nbl
    system = load_molecules([molecule(pos, cell)], n_replicas=N_BEADS,
                            device=dev)
    system = MaxwellBoltzmannInit(T_BATH).initialize_system(
        system, torch.Generator().manual_seed(seed + 3))
    integrator = RingPolymer(0.5, n_beads=N_BEADS, temperature=T_BATH)
    ring = RingEnergy(integrator)
    A = system.total_atoms
    total = {}
    for part in ("nve", "pile"):
        hooks = ([ring] if part == "nve"
                 else [PILELocalThermostat(T_BATH)])
        sim = Simulator(system, integrator, calc, simulator_hooks=hooks,
                        seed=seed, log_keys=("energy", "centroid_temperature"))
        sim.simulate(0)
        reset(launches)
        p_c0 = sim.system.centroid_momenta[0].double().sum(0)
        builds0 = (nbl.n_builds, nbl.n_device_builds, nbl.n_device_overflows)
        ms_step, peak = timed_run(sim, RPMD_STEPS)
        counts = read_counts(launches)
        check_launches(f"painn_rpmd ({part})", counts, PER_STEP["rpmd"],
                       RPMD_STEPS)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        system = sim.system
        T_c = np.concatenate([lg["centroid_temperature"][:, 0, 0]
                              for lg in sim.logs])
        host, device, overflows = (
            a - b for a, b in zip((nbl.n_builds, nbl.n_device_builds,
                                   nbl.n_device_overflows), builds0))
        window = ", the ring-energy hook inside" if part == "nve" else ""
        line = (f"md (painn_rpmd, {part}): {RPMD_STEPS} steps, {A} atoms x "
                f"{N_BEADS} beads, ms/step (CUDA events{window}) "
                f"{ms_step:.3f}, "
                f"{A * N_BEADS / (ms_step * 1e-3):.4g} atom-steps/s, centroid "
                f"T_end {T_c[-1]:.3f} K (from {T_c.min():.3f} to "
                f"{T_c.max():.3f}), rebuilds: {device} on the device, {host} "
                f"on the host, {overflows} overflows, peak device memory "
                f"{peak:.2f} GiB")
        assert np.isfinite(system.positions.cpu().numpy()).all()
        assert 0.0 < T_c.min() and T_c.max() < 300.0, (
            f"centroid T {T_c.min()} {T_c.max()}")
        assert host == overflows, f"{host} host rebuilds, {overflows} overflows"
        if part == "nve":
            H = torch.stack(ring.values).cpu().numpy() / calc.energy_conversion
            drift = float(np.abs(H - H[0]).max()) / (A * N_BEADS)
            p_c = sim.system.centroid_momenta[0].double()
            dp = float((p_c.sum(0) - p_c0).abs().max())
            scale = float(p_c.abs().sum())
            line += (f", ring-polymer energy drift {drift:.3e} eV per atom "
                     f"per bead, centroid momentum change {dp:.3e} of sum "
                     f"|p_c| {scale:.4g} (MD units)")
            assert drift <= RPMD_DRIFT_TOL, f"ring-polymer drift {drift}"
            assert dp <= CENTROID_P_RTOL * scale, f"centroid momentum {dp}"
        print(f"{line}; {smi}", flush=True)
    return total


def write_run_dir(path, tree_file=None, tree=None):
    """A run directory as the JAX training CLI writes one: the model's
    config (``PAINN_RUN_CONFIG``, names only: nothing of JAX is imported)
    and the parameters, a copy of ``tree_file`` or a pickle of ``tree``."""
    import pickle
    import shutil

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model_config.pkl"), "wb") as f:
        pickle.dump(PAINN_RUN_CONFIG, f)
    if tree_file is not None:
        shutil.copy(tree_file, os.path.join(path, "best_model"))
    else:
        with open(os.path.join(path, "best_model"), "wb") as f:
            pickle.dump(tree, f)
    return path


def perturbed_tree(path, seed, scale):
    """The parameter tree in ``path`` with every array scaled by a seeded
    1 +- ``scale``."""
    from schnetpack_tpu_torch.convert import load_jax_params

    rng = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        node = np.asarray(node, np.float32)
        return node * (1 + scale * rng.uniform(-1, 1, node.shape)).astype(
            np.float32)
    return walk(load_jax_params(path))


def write_xyz(path, R, cell):
    from schnetpack_tpu_torch.datasets import write_extxyz

    write_extxyz(path, [{"numbers": np.full(len(R), 18), "positions": R,
                         "cell": cell}])
    return path


def spkmd_run(name, argv, launches, smi):
    """``spkmd`` (``schnetpack_tpu_torch.md.cli.main``) on ``argv``, its
    launch counts from zero; returns (simulator, counts, the trajectory's
    loader)."""
    from schnetpack_tpu_torch.md import cli
    from schnetpack_tpu_torch.md.data import HDF5Loader, open_store
    from schnetpack_tpu_torch.md.simulation_hooks import FileLogger

    reset(launches)
    torch.cuda.reset_peak_memory_stats()
    writes = []                 # the trajectory file's host seconds a chunk
    process_chunk = FileLogger.process_chunk

    def timed(self, *args):
        t = time.perf_counter()
        process_chunk(self, *args)
        writes.append(time.perf_counter() - t)
    FileLogger.process_chunk = timed
    try:
        t0 = time.perf_counter()
        sim = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        FileLogger.process_chunk = process_chunk
    counts = read_counts(launches)
    files = [h.filename for h in sim.host_hooks if isinstance(h, FileLogger)]
    data = HDF5Loader(files[0]) if files else None
    steps = sim.n_simulated
    kind = (f"{open_store(files[0], 'r').kind} store, {data.entries} "
            f"entries, written in {1e3 * sum(writes) / steps:.3f} ms/step "
            f"({1e3 * max(writes):.1f} ms for the longest chunk)"
            if files else "no file")
    print(f"spkmd ({name}): {steps} steps, {sim.system.total_atoms} atoms x "
          f"{sim.system.n_replicas} replicas, ms/step "
          f"{1e3 * sim.wall_seconds / steps:.3f} (the simulator's steps, "
          f"logging and file included; wall of the whole CLI "
          f"{1e3 * wall / steps:.3f}, {wall:.2f} s), trajectory: {kind}, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; {smi}",
          flush=True)
    return sim, counts, data


def log_copy_ms(sim, steps):
    """Host ms of one chunk's log: ``steps`` steps of the simulator's log
    record stacked on the device and copied to the host, as ``simulate``
    does once a chunk."""
    rec = sim._log_record(sim.system)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = {k: torch.stack([v] * steps).cpu().numpy() for k, v in rec.items()}
    ms = 1e3 * (time.perf_counter() - t0)
    return ms, sum(a.nbytes for a in logs.values())


def spkmd_phase(pos, cell, seed, dev, launches, smi):
    """Phase 9: ``spkmd`` through the port's CLI in a temporary directory:
    PaiNN-128x3 from a run directory on the bench box under Langevin with
    a trajectory file written every step (``spkmd_painn``), a two-member
    ensemble (``spkmd_ensemble``), SPC/Fw water under NHC and as 16-bead
    PIMD (``spkmd_water``), LJ argon under NPT (``spkmd_npt``); returns
    the launch counts."""
    import shutil
    import tempfile

    from schnetpack_tpu_torch.config.compose import Composer
    from schnetpack_tpu_torch.md import cli, load_molecules
    from schnetpack_tpu_torch.md.data import PowerSpectrum

    tmp = tempfile.mkdtemp(prefix="spkmd_")
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    try:
        box = write_xyz(os.path.join(tmp, "box.xyz"), pos, cell)
        run = write_run_dir(os.path.join(tmp, "run"), ASSET["painn"])
        common = [f"device={dev}", "calculator.neighbor_list=cellblock",
                  f"calculator.cutoff_shell={SKIN}", f"seed={seed}"]

        # build_calculator on the run directory against the fixture
        ref = np.load(REFERENCE["full"])
        cfg = Composer([cli._MD_CONFIG_DIR]).compose("config", [
            f"calculator.model_dir={run}"] + common)
        calc = cli.build_calculator(cfg["calculator"], dev)
        system = load_molecules([molecule(ref["R"].astype(np.float64),
                                          ref["cell"])], device=dev)
        system = calc.calculate(system, calc.init_state(system))
        F = (system.forces[0] / calc.force_conversion).cpu().numpy()
        E = float(system.energy[0, 0]) / calc.energy_conversion
        rms = float(np.sqrt(np.mean((F - ref["forces"]) ** 2)))
        dE = abs(E - float(ref["energy"])) / abs(float(ref["energy"]))
        print(f"spkmd: build_calculator on the run directory vs the "
              f"fixture: force rms {rms:.3e} eV/Ang, energy rel {dE:.2e}",
              flush=True)
        assert rms <= FORCE_RMS_TOL, f"run directory force rms {rms}"
        assert dE <= ENERGY_RTOL, f"run directory energy rel err {dE}"

        # spkmd_painn: Langevin at 30 K, the trajectory every step
        nvt = [f"system.molecule_file={box}", f"calculator.model_dir={run}",
               "dynamics=nvt", "thermostat=langevin",
               f"thermostat.temperature_bath={T_BATH}",
               f"thermostat.time_constant={TAU_FS}",
               f"system.initializer.temperature={T_BATH}",
               f"dynamics.n_steps={SPKMD_STEPS}",
               f"dynamics.chunk_size={SPKMD_CHUNK}"] + common
        sim, counts, data = spkmd_run(
            "spkmd_painn", nvt + ["callbacks=hdf5",
                                  f"simulation_dir={tmp}/painn"],
            launches, smi)
        check_launches("spkmd_painn", counts, PER_STEP["full"],
                       SPKMD_STEPS + 1)
        add(counts)
        assert data.entries == SPKMD_STEPS, data.entries
        s = sim.system
        for k in ("positions", "momenta"):
            last = data.get(k, replica_idx=0)[-1]
            want = getattr(s, k)[0].float().cpu().numpy()
            assert np.array_equal(last, want), f"spkmd_painn: last {k}"
        T = data.get_temperature().reshape(-1)
        T_mean = float(T[-NVT_AVG:].mean())
        copy_ms, copy_bytes = log_copy_ms(sim, SPKMD_CHUNK)
        print(f"spkmd (spkmd_painn): {layout_str(sim.calc_state)}, mean T of "
              f"the last {NVT_AVG} steps {T_mean:.3f} K (bath {T_BATH} K); a "
              f"{SPKMD_CHUNK}-step chunk's log ({copy_bytes / 1e6:.1f} MB) "
              f"stacked and copied to the host in {copy_ms:.2f} ms; {smi}",
              flush=True)
        assert abs(T_mean - T_BATH) <= NVT_TOL["painn_nvt_langevin"], (
            f"spkmd_painn: mean T {T_mean}")

        # one clock (wall_seconds) for spkmd_painn, the same run without
        # the file and phase 7's Langevin run, interleaved
        walls = {"spkmd_painn": [], "spkmd_painn, no file": [],
                 "painn_nvt_langevin": []}
        for r in range(SPKMD_REPEATS):
            for name in list(walls)[::1 if r % 2 == 0 else -1]:
                if name == "painn_nvt_langevin":
                    walls[name].append(nvt_phase(
                        name, pos, cell, seed, dev, launches, smi)[3])
                    continue
                cb, tag = ((["callbacks=hdf5"], "file")
                           if name == "spkmd_painn" else
                           (["callbacks=checkpoint",
                             "callbacks.checkpoint=false"], "nofile"))
                sim, counts, _ = spkmd_run(name, nvt + cb + [
                    f"simulation_dir={tmp}/painn_{tag}_{r}"], launches, smi)
                check_launches(name, counts, PER_STEP["full"],
                               SPKMD_STEPS + 1)
                add(counts)
                walls[name].append(1e3 * sim.wall_seconds / SPKMD_STEPS)
        mean = {k: float(np.mean(v)) for k, v in walls.items()}
        spread = max(max(v) - min(v) for v in walls.values())
        file_cost = mean["spkmd_painn"] - mean["spkmd_painn, no file"]
        cli_cost = mean["spkmd_painn"] - mean["painn_nvt_langevin"]
        print("spkmd (spkmd_painn timing, wall_seconds ms/step, "
              f"{SPKMD_REPEATS} interleaved rounds): " + "; ".join(
                  f"{k} " + ", ".join(f"{x:.3f}" for x in v)
                  + f" (mean {mean[k]:.3f})" for k, v in walls.items())
              + f"; file - no file {file_cost:+.3f}, spkmd_painn - "
              f"painn_nvt_langevin {cli_cost:+.3f}, "
              f"largest spread within one run kind {spread:.3f}; {smi}",
              flush=True)

        # spkmd_ensemble: the asset and a perturbed copy, NVE
        run2 = write_run_dir(os.path.join(tmp, "run2"), tree=perturbed_tree(
            ASSET["painn"], seed + 7, ENSEMBLE_SCALE))
        fixture = write_xyz(os.path.join(tmp, "fixture.xyz"),
                            ref["R"].astype(np.float64), ref["cell"])
        ens = ["calculator=ensemble", f"calculator.model_dirs=[{run},{run2}]"]
        cfg = Composer([cli._MD_CONFIG_DIR]).compose("config", ens + common)
        ecalc = cli.build_calculator(cfg["calculator"], dev)
        singles = []
        for d in (run, run2):
            c = cli.build_calculator(Composer([cli._MD_CONFIG_DIR]).compose(
                "config", [f"calculator.model_dir={d}"] + common)
                ["calculator"], dev)
            singles.append(c)

        def forces(c, system):
            out = c.calculate(system, c.init_state(system))
            return out, out.forces / c.force_conversion

        system = load_molecules([molecule(ref["R"].astype(np.float64),
                                          ref["cell"])], device=dev)
        out, F_ens = forces(ecalc, system)
        F1 = torch.stack([forces(c, system)[1] for c in singles])
        err = float((F_ens - F1.mean(0)).abs().max())
        spread = float(F1.std(0, correction=0).max())
        print(f"spkmd (spkmd_ensemble): start: max |F_ens - mean of two "
              f"single calculators| {err:.3e} eV/Ang (largest member std "
              f"{spread:.3e})", flush=True)
        assert err <= ENSEMBLE_FORCE_ATOL, f"ensemble mean forces {err}"
        sim, counts, data = spkmd_run("spkmd_ensemble", ens + common + [
            f"system.molecule_file={fixture}", "dynamics=nve",
            f"system.initializer.temperature={T_BATH}",
            f"dynamics.n_steps={ENSEMBLE_STEPS}",
            f"dynamics.chunk_size={ENSEMBLE_STEPS}", "callbacks=hdf5",
            f"simulation_dir={tmp}/ensemble"], launches, smi)
        check_launches("spkmd_ensemble", counts,
                       {k: 2 * v for k, v in PER_STEP["full"].items()},
                       ENSEMBLE_STEPS + 1)
        add(counts)
        last = system.replace(positions=sim.system.positions.clone())
        F1 = torch.stack([forces(c, last)[1] for c in singles])
        std = F1.std(0, correction=0)[0].float().cpu().numpy()
        unc = data.get("forces_uncertainty", replica_idx=0)[-1] / (
            ecalc.force_conversion)
        err = float(np.abs(unc - std).max())
        print(f"spkmd (spkmd_ensemble): {data.entries} entries, last frame: "
              f"max |forces_uncertainty - population std of the singles| "
              f"{err:.3e} eV/Ang (largest std {std.max():.3e}); {smi}",
              flush=True)
        assert data.entries == ENSEMBLE_STEPS
        assert err <= ENSEMBLE_FORCE_ATOL, f"forces_uncertainty {err}"

        # spkmd_water: gate 5 through calculator=spcfw
        water = os.path.join(tmp, "water.xyz")
        water_box_xyz(water)
        wargs = [f"system.molecule_file={water}", "calculator=spcfw",
                 f"device={dev}", f"seed={seed}",
                 f"system.initializer.temperature={WATER_T}",
                 f"dynamics.thermostat.temperature_bath={WATER_T}",
                 "dynamics.thermostat.time_constant=20.0"]
        sim, counts, data = spkmd_run("spkmd_water, NVT", wargs + [
            "dynamics=nvt", f"dynamics.n_steps={WATER_NVT_STEPS}",
            "dynamics.integrator.time_step=0.5",
            f"simulation_dir={tmp}/water_nvt"], launches, smi)
        check_launches("spkmd_water", counts, {}, 1)
        T = data.get_temperature().reshape(-1)
        T_mean = float(T[len(T) // 2:].mean())
        R_last = data.convert_to_atoms(-1)["_positions"]
        oh = max(float(np.linalg.norm(R_last[3 * w + h] - R_last[3 * w]))
                 for w in range(len(R_last) // 3) for h in (1, 2))
        spec = PowerSpectrum(data, resolution=4096)
        spec.compute_spectrum(0)
        (freq, inten), = spec.get_spectrum()
        hi = freq > 2500.0
        peak = float(freq[hi][np.argmax(inten[hi])])
        print(f"spkmd (spkmd_water, NVT): mean T of the second half "
              f"{T_mean:.2f} K, largest O-H at the end {oh:.3f} A, largest "
              f"peak above 2,500 cm^-1 at {peak:.1f} cm^-1 (bins of "
              f"{freq[1]:.1f})", flush=True)
        assert WATER_NVT_T[0] < T_mean < WATER_NVT_T[1], f"water T {T_mean}"
        assert oh < OH_MAX, f"water O-H {oh}"
        assert OH_BAND[0] <= peak <= OH_BAND[1], f"O-H stretch at {peak}"
        sim, counts, data = spkmd_run("spkmd_water, PIMD", wargs + [
            "dynamics=rpmd", f"dynamics.integrator.n_beads={WATER_BEADS}",
            "dynamics.integrator.time_step=0.2",
            f"dynamics.integrator.temperature={WATER_T}",
            f"dynamics.n_steps={WATER_PIMD_STEPS}",
            f"simulation_dir={tmp}/water_pimd"], launches, smi)
        check_launches("spkmd_water (PIMD)", counts, {}, 1)
        T = data.get_temperature().reshape(-1)
        ratio = float(T[len(T) // 2:].mean()) / (WATER_BEADS * WATER_T)
        print(f"spkmd (spkmd_water, PIMD): {WATER_BEADS} beads, mean "
              f"bead-kinetic T of the second half {ratio:.3f} x "
              f"{WATER_BEADS} x {WATER_T} K", flush=True)
        assert WATER_PIMD_T[0] < ratio < WATER_PIMD_T[1], f"PIMD T {ratio}"

        # spkmd_npt: LJ argon at 20 kbar (test_npt_gle.py's gates)
        base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                         [0, 0.5, 0.5]])
        argon = write_xyz(os.path.join(tmp, "argon.xyz"), np.concatenate(
            [(base + [i, j, k]) * 5.26 for i in range(2) for j in range(2)
             for k in range(2)]), np.eye(3) * 10.52)
        v0 = 10.52 ** 3
        for baro, steps in NPT_STEPS.items():
            sim, counts, _ = spkmd_run(f"spkmd_npt, {baro}", NPT_ARGS + [
                f"system.molecule_file={argon}", "calculator=lj",
                "calculator.calc_stress=true", "calculator.cutoff=5.0",
                "dynamics=npt", f"barostat={baro}", f"device={dev}",
                f"seed={seed}", f"dynamics.n_steps={steps}",
                f"simulation_dir={tmp}/npt_{baro}"], launches, smi)
            check_launches(f"spkmd_npt ({baro})", counts, {}, 1)
            s = sim.system
            cells = s.cells[0, 0].double().cpu() * 10.0      # nm -> A
            v1, det = float(s.volume[0, 0]) * 1e3, float(torch.det(cells))
            print(f"spkmd (spkmd_npt, {baro}): V/V0 {v1 / v0:.4f}, "
                  f"det(cell) {det:.2f} A^3", flush=True)
            assert torch.isfinite(s.positions).all()
            assert torch.isfinite(s.cells).all()
            assert v1 < v0 and det > 0, f"{baro}: V {v1} det {det}"
            if baro == "nhc_iso":
                assert 0.5 * v0 < v1 < 0.995 * v0, f"{baro}: V/V0 {v1 / v0}"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total


def layout_potential(model, forces=True):
    """The trained model ``model`` of ``LAYOUT_PATHS`` (``potential``) with
    a ``PairwiseDistances`` input module, which the flat, dense and
    27-cell layouts read, and its parameters."""
    from schnetpack_tpu_torch.atomistic import PairwiseDistances

    pot, params = potential(LAYOUT_PATHS[model], forces)
    if not len(pot.input_modules):
        pot.input_modules.append(PairwiseDistances(columns=False))
    return pot, params


def flat_inputs(R, cell, dev):
    """The model inputs of the periodic box (R, cell) on the flat layout:
    the host cell list's pairs within the cutoff, as the JAX fixtures'
    ``NeighborListTransform`` makes them (Angstrom)."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.transform.neighborlist import (
        cell_list_neighbor_list,
    )

    i, j, S = cell_list_neighbor_list(R, CUTOFF, cell, np.ones(3, bool))
    A = len(R)

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    return {P.R: t(R, torch.float32), P.Z: t(np.full(A, 18)),
            P.idx_m: t(np.zeros(A, np.int64)),
            P.atom_mask: t(np.ones(A), torch.float32),
            P.n_atoms: t([A]), P.idx_i: t(i), P.idx_j: t(j),
            P.offsets: t(S @ cell, torch.float32),
            P.pair_mask: t(np.ones(len(i)), torch.float32)}


def layout_force_phase(dev, launches, smi):
    """Phase 10, forces: each model on the fixture's box on the flat layout
    (``flat_inputs``) and through the calculator on the dense layout
    (``neighbor_list="dense"``), and SchNet and SO3net on the 27-cell
    layout (K16/K17 once each per evaluation), against the JAX
    fixtures; the flat and dense evaluations launch no kernel."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.md import load_molecules
    from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator

    for model, path in LAYOUT_PATHS.items():
        ref = np.load(REFERENCE[path])
        R = ref["R"].astype(np.float64)
        system = load_molecules([molecule(R, ref["cell"])], device=dev)
        pot, params = layout_potential(model)
        pot.load_state_dict(params)
        pot.to(dev).requires_grad_(False)
        inputs = flat_inputs(R, ref["cell"], dev)
        dense = SchNetPackCalculator(pot, cutoff=CUTOFF,
                                     neighbor_list="dense")
        state = dense.init_state(system)
        evals = {
            "flat": lambda: pot(dict(inputs)),
            "dense": lambda: pot(dense.model_inputs(system, state))}
        layouts = [("flat", "dense")] + (
            [("cellblock_atom",)] if model in ("schnet", "so3net") else [])
        if model in ("schnet", "so3net"):
            cell = calculator(pot, params, layout="atom")
            cstate = cell.init_state(system)
            evals["cellblock_atom"] = lambda: pot(
                cell.model_inputs(system, cstate))
        for names in layouts:
            for name in names:
                torch.cuda.reset_peak_memory_stats()
                reset(launches)
                out = evals[name]()
                torch.cuda.synchronize()
                counts = {k: v for k, v in read_counts(launches).items()
                          if v}
                want = CELL_LAUNCHES if name == "cellblock_atom" else {}
                assert counts == want, (
                    f"{model} {name}: launches {counts}, want {want}")
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                F = out[P.forces].float().cpu().numpy()
                if name == "cellblock_atom":   # sorted space -> atoms
                    F = F[cstate["cell_rank"].cpu().numpy()]
                E = float(out[P.energy][0])
                rms = float(np.sqrt(np.mean((F - ref["forces"]) ** 2)))
                dE = abs(E - float(ref["energy"])) / abs(float(
                    ref["energy"]))
                ms = cuda_ms(evals[name], reps=3)
                print(f"layouts ({model}, {name}): force rms err {rms:.3e} "
                      f"eV/Ang (max {np.abs(F - ref['forces']).max():.3e}), "
                      f"energy rel err {dE:.2e}, launches {counts}, energy "
                      f"+ forces {ms:.3f} ms, peak device memory "
                      f"{peak:.2f} GiB; {smi}", flush=True)
                assert np.isfinite(F).all() and F.shape == ref[
                    "forces"].shape
                assert rms <= FORCE_RMS_TOL, f"{model} {name}: rms {rms}"
                assert dE <= ENERGY_RTOL, f"{model} {name}: energy {dE}"
        print(f"layouts ({model}): dense K = "
              f"{state[P.nbh_idx].shape[1]}, {int(inputs[P.idx_i].shape[0])}"
              " flat pairs", flush=True)
        del pot, inputs, dense, state, evals
        torch.cuda.empty_cache()


def layout_grad_phase(dev, launches):
    """Phase 10, the parameter gradients of PaiNN and SchNet on the flat
    layout against ``port_ref_{painn,schnet}_grad_argon.npz`` at
    ``grad_phase``'s rule; no kernel runs."""
    from schnetpack_tpu_torch import properties as P

    for model, path in (("painn", "full"), ("schnet", "schnet")):
        ref = np.load(GRAD_REFERENCE[path])
        pot, params = layout_potential(model, forces=False)
        pot.load_state_dict(params)
        pot.to(dev)
        inputs = flat_inputs(ref["R"].astype(np.float64), ref["cell"], dev)
        names, leaves = zip(*pot.named_parameters())
        reset(launches)
        E = pot(dict(inputs))[P.energy][0]
        grads = torch.autograd.grad(E, leaves)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts(launches).items() if v}
        norms = {n: float(np.linalg.norm(ref[f"grad/{n}"])) for n in names}
        floor = GRAD_FLOOR * max(norms.values())
        errs = {n: float(np.linalg.norm(g.double().cpu().numpy()
                                        - ref[f"grad/{n}"]))
                / max(norms[n], floor) for n, g in zip(names, grads)}
        worst = max(errs, key=errs.get)
        dE = (abs(float(E.detach()) - float(ref["energy"]))
              / abs(float(ref["energy"])))
        print(f"layouts (gradient, {model}, flat): {len(names)} leaves, "
              f"worst {worst} ||dg||/||g|| {errs[worst]:.3e} (|g| "
              f"{norms[worst]:.3e}), energy rel err {dE:.2e}, launches "
              f"{counts}", flush=True)
        assert not counts, f"{model} flat gradient launched {counts}"
        assert set(f"grad/{n}" for n in names) == {
            k for k in ref.files if k.startswith("grad/")}
        assert all(np.isfinite(g.cpu().numpy()).all() for g in grads)
        assert errs[worst] <= GRAD_RTOL, f"{model}: {worst} {errs[worst]}"
        assert dE <= ENERGY_RTOL, f"{model}: energy rel err {dE}"


def drift_per_atom(sim, calc):
    """max |E_tot(t) - E_tot(0)| over the logged steps, eV per atom (every
    molecule and replica summed)."""
    E = np.concatenate([lg["energy"] + lg["kinetic_energy"]
                        for lg in sim.logs]).sum(axis=(1, 2))
    E = E / calc.energy_conversion
    return float(np.abs(E - E[0]).max()) / (
        sim.system.total_atoms * sim.system.n_replicas)


def step_profile(sim, steps):
    """(ms/step of wall, ms/step of kernels, the eight kernels with the
    most device time as (name, ms/step)) of ``steps`` steps under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.simulate(steps, chunk_size=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(e.device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    return (1e3 * wall / steps, busy,
            [(e.key[:70], e.device_time_total / 1e3 / steps) for e in top])


def painn_dense_phase(seed, dev, launches, smi):
    """Phase 10, ``painn_dense``: NVE of the bench box with PaiNN-128x3 on
    ``neighbor_list="dense"`` (skin 0.5 A, host builds); then a short
    profile of its steps.  Returns ms/step."""
    from schnetpack_tpu_torch.md import (
        MaxwellBoltzmannInit, Simulator, VelocityVerlet, load_molecules,
    )
    from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator

    pos, cell = fcc_box(10_000)
    pot, params = layout_potential("painn")
    calc = SchNetPackCalculator(pot, params, cutoff=CUTOFF,
                                neighbor_list="dense")
    system = MaxwellBoltzmannInit(T_BATH).initialize_system(
        load_molecules([molecule(pos, cell)], device=dev),
        torch.Generator().manual_seed(seed + 1))
    sim = Simulator(system, VelocityVerlet(0.5), calc,
                    log_keys=("energy", "kinetic_energy", "temperature"))
    sim.simulate(0)
    nbl = calc.nbl
    builds0, build_s0 = nbl.n_builds, nbl.build_seconds
    reset(launches)
    ms_step, peak = timed_run(sim, LAYOUT_STEPS)
    counts = {k: v for k, v in read_counts(launches).items() if v}
    A = sim.system.total_atoms
    T = float(sim.system.temperature.mean())
    drift = drift_per_atom(sim, calc)
    from schnetpack_tpu_torch import properties as P
    print(f"md (painn_dense): {LAYOUT_STEPS} steps, {A} atoms, K = "
          f"{sim.calc_state[P.nbh_idx].shape[1]}, ms/step (CUDA events) "
          f"{ms_step:.3f}, {A / (ms_step * 1e-3):.4g} atom-steps/s, "
          f"T_end={T:.2f} K, max |E_tot - E_tot(0)| = {drift:.3e} eV/atom, "
          f"rebuilds: {nbl.n_builds - builds0} on the host "
          f"({nbl.build_seconds - build_s0:.3f} s wall; the first build "
          f"{build_s0:.3f} s), peak device memory {peak:.2f} GiB, launches "
          f"{counts}; {smi}", flush=True)
    assert np.isfinite(sim.system.positions.cpu().numpy()).all()
    assert 0.0 < T < 300.0, f"painn_dense: T {T}"
    assert drift <= DRIFT_TOL, f"painn_dense: drift {drift}"
    assert not counts, f"painn_dense launched {counts}"
    wall, busy, top = step_profile(sim, PROFILE_STEPS)
    print(f"profile (painn_dense): {PROFILE_STEPS} steps under "
          f"torch.profiler, wall {wall:.3f} ms/step, kernels {busy:.3f} "
          f"ms/step (idle share {max(0.0, 1 - busy / wall):.3f}); most "
          "device time: " + "; ".join(f"{k} {v:.3f}" for k, v in top)
          + f"; {smi}", flush=True)
    return ms_step


def clusters(seed):
    """``N_CLUSTERS`` argon clusters of ``CLUSTER_ATOMS`` atoms: seeded
    sites of the bench lattice, each with the atoms within
    ``CLUSTER_RADIUS`` (its first four FCC shells) by the minimum image,
    jittered by +-``CLUSTER_JITTER``; non-periodic molecules."""
    from schnetpack_tpu_torch import properties as P

    pos, cell = fcc_box(10_000)
    L = cell[0, 0]
    rng = np.random.RandomState(seed + 11)
    out = []
    for c in rng.choice(len(pos), N_CLUSTERS, replace=False):
        d = pos - pos[c]
        d -= L * np.round(d / L)
        near = np.linalg.norm(d, axis=1) < CLUSTER_RADIUS
        R = pos[c] + d[near] + rng.uniform(-CLUSTER_JITTER, CLUSTER_JITTER,
                                           (int(near.sum()), 3))
        assert len(R) == CLUSTER_ATOMS, len(R)
        out.append({P.Z: np.full(len(R), 18, np.int64), P.R: R})
    return out


def cluster_phase(seed, dev, launches, smi):
    """Phase 10, ``painn_clusters``: the clusters with PaiNN-128x3 on the
    all-pairs list, forces at the start against the dense layout, NVE;
    then 4 beads under PILE-L on both layouts.  Returns ms/step by run."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.md import (
        MaxwellBoltzmannInit, RingPolymer, Simulator, VelocityVerlet,
        load_molecules,
    )
    from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
    from schnetpack_tpu_torch.md.simulation_hooks import PILELocalThermostat

    mols = clusters(seed)
    pot, params = layout_potential("painn")
    calcs = {nl: SchNetPackCalculator(pot, params, cutoff=CUTOFF,
                                      neighbor_list=nl)
             for nl in ("all_pairs", "dense")}
    out = {}
    for n_rep in (1, CLUSTER_BEADS):
        system = MaxwellBoltzmannInit(T_BATH).initialize_system(
            load_molecules(mols, n_replicas=n_rep, device=dev),
            torch.Generator().manual_seed(seed + 5))
        forces = {nl: c.calculate(system, c.init_state(system)).forces
                  / c.force_conversion for nl, c in calcs.items()}
        err = float((forces["dense"] - forces["all_pairs"]).abs().max())
        tag = "painn_clusters" + (f", {n_rep} beads" if n_rep > 1 else "")
        pairs = calcs["all_pairs"]._pair_inputs(system)[P.idx_i].shape[0]
        print(f"md ({tag}): start: max |F_dense - F_all_pairs| {err:.3e} "
              f"eV/Ang (largest |F| "
              f"{float(forces['all_pairs'].abs().max()):.3e}), "
              f"{system.total_atoms} atoms x {n_rep} replicas, {pairs} "
              "all-pairs", flush=True)
        assert err <= CLUSTER_FORCE_ATOL, f"{tag}: dense vs all_pairs {err}"
        for nl, calc in calcs.items():
            if n_rep == 1 and nl == "dense":
                continue
            integrator = (VelocityVerlet(0.5) if n_rep == 1 else RingPolymer(
                0.5, n_beads=n_rep, temperature=T_BATH))
            hooks = [] if n_rep == 1 else [PILELocalThermostat(T_BATH)]
            sim = Simulator(system, integrator, calc, simulator_hooks=hooks,
                            seed=seed, log_keys=(
                                "energy", "kinetic_energy",
                                "centroid_temperature"))
            sim.simulate(0)
            reset(launches)
            steps = LAYOUT_STEPS if n_rep == 1 else CLUSTER_RPMD_STEPS
            ms_step, peak = timed_run(sim, steps)
            counts = {k: v for k, v in read_counts(launches).items() if v}
            T = np.concatenate([lg["centroid_temperature"][:, 0]
                                for lg in sim.logs])
            line = (f"md ({tag}, {nl}): {steps} steps, ms/step (CUDA "
                    f"events) {ms_step:.3f}, "
                    f"{system.total_atoms * n_rep / (ms_step * 1e-3):.4g} "
                    f"atom-steps/s, mean centroid T at the end "
                    f"{float(T[-1].mean()):.2f} K, peak device memory "
                    f"{peak:.2f} GiB, launches {counts}")
            assert np.isfinite(sim.system.positions.cpu().numpy()).all()
            assert 0.0 < T.min() and T.max() < 300.0, f"{tag}: T"
            assert not counts, f"{tag} {nl} launched {counts}"
            if n_rep == 1:
                drift = drift_per_atom(sim, calc)
                line += f", max |E_tot - E_tot(0)| = {drift:.3e} eV/atom"
                assert drift <= DRIFT_TOL, f"{tag}: drift {drift}"
            out[f"{tag}, {nl}"] = ms_step
            print(f"{line}; {smi}", flush=True)
    return out


def spkmd_cluster_phase(seed, dev, launches, smi):
    """Phase 10, ``spkmd_clusters``: ``spkmd`` on an extxyz of the clusters
    with the calculator config as shipped (``neighbor_list: all_pairs``):
    Langevin at 30 K, 300 steps, the trajectory file.  Returns ms/step."""
    import shutil
    import tempfile

    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.datasets import write_extxyz

    tmp = tempfile.mkdtemp(prefix="spkmd_clusters_")
    try:
        xyz = os.path.join(tmp, "clusters.xyz")
        write_extxyz(xyz, [{"numbers": m[P.Z], "positions": m[P.R]}
                           for m in clusters(seed)])
        run = write_run_dir(os.path.join(tmp, "run"), ASSET["painn"])
        sim, counts, data = spkmd_run("spkmd_clusters", [
            f"system.molecule_file={xyz}", f"calculator.model_dir={run}",
            "dynamics=nvt", "thermostat=langevin",
            f"thermostat.temperature_bath={T_BATH}",
            f"thermostat.time_constant={TAU_FS}",
            f"system.initializer.temperature={T_BATH}",
            f"dynamics.n_steps={LAYOUT_STEPS}",
            f"dynamics.chunk_size={SPKMD_CHUNK}", "callbacks=hdf5",
            f"device={dev}", f"seed={seed}",
            f"simulation_dir={tmp}/sim"], launches, smi)
        check_launches("spkmd_clusters", counts, {}, 1)
        assert sim.calculator.nbl is None, "not the all-pairs list"
        assert sim.system.n_molecules == N_CLUSTERS
        assert data.entries == LAYOUT_STEPS, data.entries
        assert torch.isfinite(sim.system.positions).all()
        return 1e3 * sim.wall_seconds / LAYOUT_STEPS
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def layout_phase(seed, dev, launches, smi):
    """Phase 10, the flat and dense layouts (see the module's
    docstring)."""
    t0 = time.perf_counter()
    layout_force_phase(dev, launches, smi)
    layout_grad_phase(dev, launches)
    ms = {"painn_dense": painn_dense_phase(seed, dev, launches, smi)}
    ms.update(cluster_phase(seed, dev, launches, smi))
    ms["spkmd_clusters"] = spkmd_cluster_phase(seed, dev, launches, smi)
    print("layouts ms/step: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in ms.items())
          + f"; phase 10 took {time.perf_counter() - t0:.1f} s; {smi}",
          flush=True)


def seeded_tree(tree, seed):
    """A flax parameter tree of ``tree``'s names and shapes with every leaf
    drawn from ``numpy.random.RandomState(seed)``, the leaves in sorted
    path order: a kernel [in, out] uniform in +-sqrt(6 / (in + out))
    (flax's Xavier init), an embedding table normal / sqrt(width), any
    other leaf (biases, gates) normal x 0.01 (at x 0.1 the biases drive a
    full-width FieldSchNet's responses to 1e6, where f32 keeps only 1e-4
    of them; numpy only: the JAX fixture's script and phase 12 draw the
    same numbers)."""
    rng = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            shape = np.shape(v)
            if k == "kernel" and len(shape) == 2:
                a = np.sqrt(6.0 / sum(shape))
                x = rng.uniform(-a, a, shape)
            elif k == "embedding":
                x = rng.randn(*shape) / np.sqrt(shape[-1])
            else:
                x = 0.01 * rng.randn(*shape)
            out[k] = x.astype(np.float32)
        return out
    return walk(tree)


def seeded_params(params, seed):
    """A potential's flax tree (the ``params`` level) with the
    representation from ``seeded_tree(seed)`` and the output modules from
    ``seeded_tree(seed + 1)``, so that a head's numbers do not depend on
    the representation's or on the heads after it."""
    heads = {k: v for k, v in params.items() if k != "representation"}
    return dict(seeded_tree(heads, seed + 1),
                representation=seeded_tree(params["representation"], seed))


def nacl(n_cells, a=NACL_A):
    """Rock salt of ``n_cells``^3 conventional cells: (R [8 n^3, 3], cubic
    cell, charges +1 on Na and -1 on Cl)."""
    fcc = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                    -1).reshape(-1, 1, 3)
    na = ((fcc[None] + grid) * a).reshape(-1, 3)
    R = np.concatenate([na, na + np.array([0.5 * a, 0.0, 0.0])])
    q = np.concatenate([np.ones(len(na)), -np.ones(len(na))])
    return R, np.eye(3) * a * n_cells, q


def nacl_pairs(R, cell, rc, chunk=256):
    """(idx_i, idx_j, offsets) of every ordered pair within ``rc`` under
    the minimum image (``rc`` under half the box), in (i, j) order."""
    inv = np.linalg.inv(cell)
    ii, jj, oo = [], [], []
    for lo in range(0, len(R), chunk):
        d = R[None, :, :] - R[lo:lo + chunk, None, :]
        off = -np.round(d @ inv) @ cell
        r = np.linalg.norm(d + off, axis=-1)
        i, j = np.nonzero((r < rc) & (r > 0))
        ii.append(i + lo)
        jj.append(j)
        oo.append(off[i, j])
    return (np.concatenate(ii).astype(np.int32),
            np.concatenate(jj).astype(np.int32), np.concatenate(oo))


def madelung(E, n_ions, a=NACL_A):
    """Rock salt's Madelung constant from its energy: E = -(N/2) M ke /
    r0, r0 = a / 2."""
    from schnetpack_tpu_torch.units import ke

    return -2.0 * E * (0.5 * a) / (n_ions * ke)


def train_molecules():
    """The molecules of ``bench.py::train_bench`` (``bench.py:100-112``):
    ``TRAIN_MOLECULES`` blobs of 21 atoms (C9H8O4, positions ``randn *
    1.5`` from ``RandomState(0)``, energy sum(R^2), forces -2R), as dicts
    of numpy arrays under the batch keys (numpy only: the response
    fixture's script builds its JAX batch from them)."""
    rng = np.random.RandomState(0)
    Z = np.array([6] * 9 + [1] * 8 + [8] * 4)
    out = []
    for _ in range(TRAIN_MOLECULES):
        R = rng.randn(len(Z), 3) * 1.5
        out.append({"_atomic_numbers": Z, "_positions": R,
                    "_cell": np.zeros((3, 3)), "_pbc": np.zeros(3, bool),
                    "energy": np.array([float((R ** 2).sum())]),
                    "forces": -2.0 * R})
    return out


def field_molecules(seed=0):
    """``TRAIN_MOLECULES`` synthetic molecules (``synthetic_molecule``:
    5-12 atoms of H, C, N, O and F at least 1 A apart) as dicts of numpy
    arrays: the field responses' batch.  ``train_molecules`` places atoms
    as close as 0.04 A, where FieldSchNet's 1/d^5 dipole terms overflow
    f32 at full width."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(TRAIN_MOLECULES):
        Z, R, _ = synthetic_molecule(rng)
        out.append({"_atomic_numbers": Z, "_positions": R,
                    "_cell": np.zeros((3, 3)), "_pbc": np.zeros(3, bool)})
    return out


def train_samples():
    """``train_molecules`` neighbor-listed at the cutoff by the port's
    transform."""
    from schnetpack_tpu_torch.transform import NeighborListTransform

    nbl = NeighborListTransform(CUTOFF)
    return [nbl(m) for m in train_molecules()]


def train_task_and_batch(layout, dev):
    """(task, numpy batch) of ``make_port_reference_train.py``'s step:
    PaiNN-128x3 with the asset's weights on ``dev``, an energy (0.01) and
    force (0.99) MSE loss, AdamW at lr 1e-4; the batch collated by the
    port on the flat layout (``padding_for``) or the dense one (bench.py's
    K: the largest neighbor count + 1, rounded up to 4)."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.data import PaddingSpec, collate, padding_for
    from schnetpack_tpu_torch.data.loader import round_up
    from schnetpack_tpu_torch.train import AtomisticTask, ModelOutput

    samples = train_samples()
    spec = padding_for(samples)
    if layout == "dense":
        K = max(int(np.bincount(s[P.idx_i]).max()) for s in samples)
        spec = PaddingSpec(spec.n_atoms, spec.n_pairs, spec.n_molecules,
                           n_neighbors=round_up(K + 1, 4))
    pot, params = layout_potential("painn")
    pot.load_state_dict(params)
    task = AtomisticTask(pot.to(dev), [
        ModelOutput(P.energy, loss_weight=0.01),
        ModelOutput(P.forces, loss_weight=0.99)], learning_rate=1e-4)
    return task, collate(samples, spec)


def train_parity_phase(dev, launches, smi):
    """Phase 11a: the port's train step on the card against
    ``TRAIN_REFERENCE`` on the flat and dense layouts: the first loss, the
    gradient of every parameter (per leaf, ``grad_phase``'s rule) and the
    losses before steps 2-4; no kernel launches."""
    from schnetpack_tpu_torch.convert import params_to_jax
    from schnetpack_tpu_torch.train import as_tensors

    ref = np.load(TRAIN_REFERENCE)
    for layout in ("flat", "dense"):
        task, batch = train_task_and_batch(layout, dev)
        batch = as_tensors(batch, dev)
        state = task.create_state()
        reset(launches)
        loss, _, grads = task.gradients(state, batch)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts(launches).items() if v}
        flat = {}

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{path}/{k}" if path else k)
                else:
                    flat[f"grad/{path}/{k}"] = np.asarray(v, np.float64)
        walk(params_to_jax(task.model, grads), "")
        assert set(flat) == {k for k in ref.files if k.startswith("grad/")}
        norms = {k: float(np.linalg.norm(ref[k])) for k in flat}
        floor = GRAD_FLOOR * max(norms.values())
        errs = {k: float(np.linalg.norm(flat[k] - ref[k]))
                / max(norms[k], floor) for k in flat}
        worst = max(errs, key=errs.get)
        losses = []
        for _ in range(len(ref["loss"])):
            state, m = task.train_step(state, batch)
            losses.append(float(m["train_loss"][0]))
        counts_steps = {k: v for k, v in read_counts(launches).items() if v}
        dl = np.abs(np.asarray(losses) - ref["loss"]) / np.abs(ref["loss"])
        print(f"train ({layout}): first loss {float(loss.detach()):.9e} (JAX "
              f"{float(ref['loss'][0]):.9e}, rel err {dl[0]:.2e}), "
              f"{len(flat)} gradient leaves, worst {worst} ||dg||/||g|| "
              f"{errs[worst]:.3e}, losses before steps 2-4 rel err "
              f"{', '.join(f'{d:.2e}' for d in dl[1:])}, launches "
              f"{counts_steps}; {smi}", flush=True)
        assert not counts and not counts_steps, (
            f"train {layout} launched {counts} {counts_steps}")
        assert np.isfinite(losses).all()
        assert dl[0] <= TRAIN_LOSS_RTOL, f"{layout}: first loss {dl[0]}"
        assert errs[worst] <= GRAD_RTOL, f"{layout}: {worst} {errs[worst]}"
        assert dl[1:].max() <= TRAIN_STEP_LOSS_RTOL, f"{layout}: losses {dl}"
        del task, batch, state, grads
        torch.cuda.empty_cache()


def train_time_phase(dev, smi):
    """Phase 11b: ms per train step on the flat and dense layouts (CUDA
    events around chunks of ``TRAIN_CHUNK`` steps after a warm-up; the
    median chunk), the peak device memory, and ``TRAIN_PROFILE_STEPS``
    steps under ``torch.profiler``: kernel time, idle share and the
    operations with the most device time.  Returns ms/step by layout."""
    from torch.profiler import ProfilerActivity, profile

    from schnetpack_tpu_torch.train import as_tensors

    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for layout in ("flat", "dense"):
        task, batch = train_task_and_batch(layout, dev)
        batch = as_tensors(batch, dev)
        state = task.create_state()
        for _ in range(TRAIN_WARMUP):
            state, _ = task.train_step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        chunks = []
        for _ in range(TRAIN_CHUNKS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(TRAIN_CHUNK):
                state, _ = task.train_step(state, batch)
            end.record()
            end.synchronize()
            chunks.append(start.elapsed_time(end) / TRAIN_CHUNK)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TRAIN_PROFILE_STEPS):
                state, _ = task.train_step(state, batch)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / TRAIN_PROFILE_STEPS
        kernels = [e for e in prof.key_averages() if e.device_type == cuda]
        busy = (sum(e.device_time_total for e in kernels) / 1e3
                / TRAIN_PROFILE_STEPS)
        n_launch = sum(e.count for e in kernels) / TRAIN_PROFILE_STEPS
        top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
        ops = sorted((e for e in prof.key_averages()
                      if e.device_type != cuda and e.key.startswith("aten::")
                      and e.device_time_total > 0),
                     key=lambda e: -e.device_time_total)[:8]
        ms = float(np.median(chunks))
        out[layout] = ms
        atoms = int(batch["_atom_mask"].sum())
        print(f"train step ({layout}): {TRAIN_MOLECULES} molecules, {atoms} "
              f"atoms, {int(batch['_pair_mask'].sum())} pairs; ms/step "
              f"(CUDA events, median of {TRAIN_CHUNKS} chunks of "
              f"{TRAIN_CHUNK}) {ms:.3f} (chunks "
              f"{', '.join(f'{c:.3f}' for c in chunks)}), "
              f"{TRAIN_MOLECULES / (ms * 1e-3):.4g} molecules/s, peak "
              f"device memory {peak:.2f} GiB; {smi}", flush=True)
        print(f"profile (train {layout}): {TRAIN_PROFILE_STEPS} steps under "
              f"torch.profiler, wall {wall:.3f} ms/step, kernels "
              f"{busy:.3f} ms/step in {n_launch:.0f} launches (idle share "
              f"{max(0.0, 1 - busy / wall):.3f}); most device time: "
              + "; ".join(f"{e.key[:60]} {e.device_time_total / 1e3 / TRAIN_PROFILE_STEPS:.3f}"
                          for e in top)
              + "; by operation: "
              + "; ".join(f"{e.key} {e.device_time_total / 1e3 / TRAIN_PROFILE_STEPS:.3f}"
                          for e in ops) + f"; {smi}", flush=True)
        assert np.isfinite(chunks).all()
        del task, batch, state, prof
        torch.cuda.empty_cache()
    return out


def write_aspirin_npz(raw_dir, seed):
    """A synthetic aspirin trajectory of ``SPKTRAIN_FRAMES`` frames in the
    MD17 (sGDML: ``md17_aspirin.npz``) and the rMD17 (``rmd17_aspirin.npz``)
    formats: C9H8O4 blobs as in ``train_samples``, each centred on its
    centre of mass, energy sum(R^2) in kcal/mol and forces -2R."""
    from schnetpack_tpu_torch.transform.atomistic import ATOMIC_MASSES

    rng = np.random.RandomState(seed)
    z = np.array([6] * 9 + [1] * 8 + [8] * 4)
    m = ATOMIC_MASSES[z]
    R = rng.randn(SPKTRAIN_FRAMES, len(z), 3) * 1.5
    R -= (m[None, :, None] * R).sum(1, keepdims=True) / m.sum()
    E, F = (R ** 2).sum((1, 2)), -2.0 * R
    np.savez(os.path.join(raw_dir, "md17_aspirin.npz"), z=z, R=R, E=E, F=F)
    np.savez(os.path.join(raw_dir, "rmd17_aspirin.npz"), nuclear_charges=z,
             coords=R, energies=E, forces=F)


def val_losses(run_dir):
    """The validation loss of each epoch from the run's ``metrics.csv``."""
    import csv

    with open(os.path.join(run_dir, "metrics.csv")) as f:
        return [float(r["val_loss"]) for r in csv.DictReader(f)
                if r.get("val_loss") not in (None, "", "val_loss")]


def spktrain_phase(seed, dev, launches, smi):
    """Phase 11c: ``spktrain`` through the port's CLI at full width in a
    temporary directory, ``experiment=md17`` (SchNet-128x3) and
    ``experiment=rmd17`` (PaiNN-128x3; ``experiment=md17 model=painn``
    swaps in a model config without ``Forces``), on
    ``write_aspirin_npz``'s files; each
    run: the validation loss falls from epoch 1 to the last, the run
    directory is complete, a rerun with one more epoch resumes,
    ``spkpredict`` writes predictions and ``cli.load_model`` of the run
    directory gives the trained model's energies within
    ``SPKTRAIN_E_ATOL``; then ``spkmd`` runs 100 NVE steps of one molecule
    from the last run directory on ``all_pairs``."""
    import shutil
    import tempfile

    from schnetpack_tpu_torch import cli
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.datasets import write_extxyz
    from schnetpack_tpu_torch.train import as_tensors, load_pytree

    tmp = tempfile.mkdtemp(prefix="spktrain_")
    try:
        raw = os.path.join(tmp, "raw")
        os.makedirs(raw)
        write_aspirin_npz(raw, seed + 13)
        common = [f"run.path={tmp}/runs", f"run.data_dir={tmp}/data",
                  f"data.raw_dir={raw}",
                  f"data.num_train={SPKTRAIN_SPLIT[0]}",
                  f"data.num_val={SPKTRAIN_SPLIT[1]}",
                  f"data.num_test={SPKTRAIN_SPLIT[2]}",
                  f"data.batch_size={SPKTRAIN_BATCH}",
                  "trainer.progress=false", f"device={dev}",
                  f"globals.seed={seed}", "print_config=false"]
        for name, experiment in (("schnet", "md17"), ("painn", "rmd17")):
            argv = [f"experiment={experiment}", f"run.id={name}"] + common
            cfg = cli.default_composer().compose("train", argv + [
                f"trainer.max_epochs={SPKTRAIN_EPOCHS}"])
            reset(launches)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics, task, state, dm = cli.fit(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in read_counts(launches).items() if v}
            run = os.path.join(tmp, "runs", name)
            losses = val_losses(run)
            files = ["config.yaml", "best_model", "model_config.pkl",
                     "metrics.csv", "checkpoints/last.ckpt",
                     "checkpoints/best.ckpt"]
            missing = [f for f in files
                       if not os.path.exists(os.path.join(run, f))]
            rep = task.model.representation
            # the trained model in memory against the run directory, at the
            # best epoch's weights (best_model is written at the best
            # validation loss; the last epoch's where that is the best)
            last_is_best = min(losses) == losses[-1]
            if not last_is_best:
                state.load_state_dict(torch.load(os.path.join(
                    run, "checkpoints", "best.ckpt"),
                    weights_only=False)["state"])
            batch = as_tensors(next(iter(dm.test_dataloader())), dev)
            M = int(batch[P.mol_mask].sum())
            with torch.no_grad():
                mine = task.model(batch)
                loaded, _ = cli.load_model(run, dev)
                theirs = loaded(batch)
            dE = float((mine[P.energy] - theirs[P.energy])[:M].abs().max())
            assert {P.energy, P.forces} <= set(task.model.model_outputs)
            dF = float((mine[P.forces] - theirs[P.forces]).abs().max())
            print(f"spktrain ({name}, {type(rep).__name__}-"
                  f"{rep.n_atom_basis}x{rep.n_interactions}): "
                  f"{SPKTRAIN_EPOCHS} epochs of {len(dm.train_idx)} frames "
                  f"in {state.step} steps, {wall:.1f} s "
                  f"({1e3 * wall / state.step:.1f} ms/step with validation "
                  f"and checkpoints), val loss by epoch "
                  f"{', '.join(f'{v:.6g}' for v in losses)}, test "
                  f"{', '.join(f'{k} {v:.6g}' for k, v in metrics.items())}"
                  f", load_model (at the "
                  f"{'last' if last_is_best else 'best'} epoch's weights) "
                  f"max |dE| {dE:.3e} kcal/mol, max |dF| "
                  f"{dF:.3e}, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                  f"launches {counts}; {smi}", flush=True)
            assert not missing, f"{name}: run directory lacks {missing}"
            assert len(losses) == SPKTRAIN_EPOCHS and losses[-1] < losses[0], (
                f"{name}: val losses {losses}")
            assert all(np.isfinite(v) for v in metrics.values())
            assert dE <= SPKTRAIN_E_ATOL and dF <= SPKTRAIN_F_ATOL, (
                f"{name}: load_model dE {dE} dF {dF}")
            assert not counts, f"{name}: launched {counts}"
            del task, state, loaded, mine, theirs
            # resume: one more epoch from checkpoints/last.ckpt
            cfg = cli.default_composer().compose("train", argv + [
                f"trainer.max_epochs={SPKTRAIN_EPOCHS + 1}"])
            _, _, state, _ = cli.fit(cfg)
            ckpt = torch.load(os.path.join(run, "checkpoints", "last.ckpt"),
                              weights_only=False)
            steps_per_epoch = len(dm.train_dataloader())
            print(f"spktrain ({name}): resumed to epoch {ckpt['epoch']}, "
                  f"step {state.step}, val losses "
                  f"{', '.join(f'{v:.6g}' for v in val_losses(run))}",
                  flush=True)
            assert ckpt["epoch"] == SPKTRAIN_EPOCHS + 1
            assert state.step == (SPKTRAIN_EPOCHS + 1) * steps_per_epoch
            pred = cli.main(["predict", f"model_dir={run}", f"device={dev}"])
            n_pred = len(os.listdir(pred))
            first = load_pytree(os.path.join(pred, "batch_0.pkl"))
            assert n_pred == -(-SPKTRAIN_SPLIT[2] // SPKTRAIN_BATCH), n_pred
            assert np.isfinite(first[P.energy]).all()
            assert first[P.forces].shape[1] == 3
        # train -> MD: spkmd with the run directory
        xyz = os.path.join(tmp, "aspirin.xyz")
        with np.load(os.path.join(raw, "md17_aspirin.npz")) as f:
            write_extxyz(xyz, [{"numbers": f["z"], "positions": f["R"][0]}])
        sim, counts, _ = spkmd_run("spkmd_trained", [
            f"system.molecule_file={xyz}", f"calculator.model_dir={run}",
            "calculator.energy_unit=kcal/mol", "dynamics=nve",
            "system.initializer.temperature=300",
            f"dynamics.n_steps={SPKTRAIN_MD_STEPS}", "callbacks=hdf5",
            f"device={dev}", f"seed={seed}",
            f"simulation_dir={tmp}/sim"], launches, smi)
        E = np.concatenate([lg["energy"] + lg["kinetic_energy"]
                            for lg in sim.logs]).sum(axis=(1, 2))
        E = E / sim.calculator.energy_conversion
        print(f"spkmd (spkmd_trained): {SPKTRAIN_MD_STEPS} NVE steps of one "
              f"molecule with the PaiNN run directory, max |E_tot - "
              f"E_tot(0)| {float(np.abs(E - E[0]).max()):.3e} kcal/mol, "
              f"launches {({k: v for k, v in counts.items() if v})}; {smi}",
              flush=True)
        assert sim.n_simulated == SPKTRAIN_MD_STEPS
        assert torch.isfinite(sim.system.positions).all()
        assert np.isfinite(E).all()
        check_launches("spkmd_trained", counts, {}, 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_phase(seed, dev, launches, smi):
    """Phase 11, training (see the module's docstring)."""
    t0 = time.perf_counter()
    train_parity_phase(dev, launches, smi)
    ms = train_time_phase(dev, smi)
    spktrain_phase(seed, dev, launches, smi)
    print("train ms/step: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; phase 11 took {time.perf_counter() - t0:.1f} s; {smi}",
          flush=True)


def rel_err(got, want):
    """max |got - want| over max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def stress_phase(dev, launches, smi):
    """Phase 12a: PaiNN-128x3 (the asset) with ``Forces(calc_stress=True)``
    on the fixture's bench box, on the flat layout (``flat_inputs``) and
    the 27-cell layout (the calculator's ``cellblock_atom`` inputs, K16-K19
    with K3/K4), against ``RESPONSE_REFERENCE``: energy, forces and the
    stress over the virial's scale; the 27-cell evaluation's launches;
    ms per evaluation with and without stress on each layout."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.atomistic import Forces, PairwiseDistances
    from schnetpack_tpu_torch.md import load_molecules
    from schnetpack_tpu_torch.model import NeuralNetworkPotential

    ref = np.load(RESPONSE_REFERENCE)
    R, cell = ref["box_R"].astype(np.float64), ref["box_cell"]
    V = abs(np.linalg.det(cell))
    virial = np.abs(R[:, :, None] * ref["box_forces"][:, None, :]).sum(0) / V
    scale = float(virial.max())
    system = load_molecules([molecule(R, cell)], device=dev)
    pot, params = layout_potential("painn")
    pot.load_state_dict(params)
    stress_pot = NeuralNetworkPotential(
        pot.representation, [pot.output_modules[0], Forces(calc_stress=True)],
        input_modules=[PairwiseDistances(columns=False)])
    pot.to(dev).requires_grad_(False)
    stress_pot.to(dev).requires_grad_(False)
    flat = flat_inputs(R, cell, dev)
    flat[P.cell] = torch.as_tensor(cell[None], dtype=torch.float32,
                                   device=dev)
    calc = calculator(pot, params, layout="atom")
    state = calc.init_state(system)
    cell_in = calc.model_inputs(system, state)
    rank = state["cell_rank"].cpu().numpy()
    evals = {"flat": flat, "cellblock_atom": cell_in}
    total = {}
    for name, inputs in evals.items():
        reset(launches)
        out = stress_pot(dict(inputs))
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts(launches).items() if v}
        want = CELL_STRESS_LAUNCHES if name == "cellblock_atom" else {}
        F = out[P.forces].float().cpu().numpy()
        if name == "cellblock_atom":
            F = F[rank]
        sigma = out[P.stress][0].double().cpu().numpy()
        rms = float(np.sqrt(np.mean((F - ref["box_forces"]) ** 2)))
        dE = abs(float(out[P.energy][0]) - float(ref["box_energy"])) / abs(
            float(ref["box_energy"]))
        ds = float(np.abs(sigma - ref["box_stress"]).max()) / scale
        ms = cuda_ms(lambda: stress_pot(dict(inputs)), reps=3)
        ms_plain = cuda_ms(lambda: pot(dict(inputs)), reps=3)
        print(f"responses (stress, {name}): force rms err {rms:.3e} eV/Ang, "
              f"energy rel err {dE:.2e}, stress max err {ds:.3e} of the "
              f"virial's scale {scale:.4e} eV/A^3 (stress "
              f"{np.array2string(sigma.diagonal(), precision=6)} eV/A^3, "
              f"JAX {np.array2string(ref['box_stress'].diagonal(), precision=6)}"
              f"), launches {counts}, ms per evaluation {ms:.3f} with stress, "
              f"{ms_plain:.3f} forces only; {smi}", flush=True)
        assert counts == want, f"stress {name}: launches {counts}, want {want}"
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        assert np.isfinite(sigma).all() and np.isfinite(F).all()
        assert rms <= FORCE_RMS_TOL, f"stress {name}: force rms {rms}"
        assert dE <= ENERGY_RTOL, f"stress {name}: energy {dE}"
        assert ds <= STRESS_VIRIAL_TOL, f"stress {name}: {ds}"
    del pot, stress_pot, calc, state, evals
    torch.cuda.empty_cache()
    return total


def seeded(pot, seed):
    """``pot`` with every parameter from ``seeded_params(seed)`` (the JAX
    fixture's numbers, through the flax tree's names)."""
    from schnetpack_tpu_torch.convert import params_from_jax, params_to_jax

    tree = params_to_jax(pot)["params"]
    pot.load_state_dict(params_from_jax({"params": seeded_params(tree,
                                                                 seed)}))
    return pot


def heads_phase(dev, launches, smi):
    """Phase 12b and 12d: PaiNN-128x3 with an ``Atomwise``, a
    ``DipoleMoment(use_vector_representation=True)`` and a
    ``Polarizability``, seeded, on ``train_bench``'s batch against the
    fixture; then ``md/vibrations.normal_modes`` of the batch's first
    molecule under that representation and energy head.  No launches."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.atomistic import (
        Atomwise, DipoleMoment, PairwiseDistances, Polarizability,
    )
    from schnetpack_tpu_torch.data import collate, padding_for
    from schnetpack_tpu_torch.md.vibrations import (
        hessian_inputs, normal_modes, with_hessian,
    )
    from schnetpack_tpu_torch.model import NeuralNetworkPotential
    from schnetpack_tpu_torch.representation import PaiNN
    from schnetpack_tpu_torch.train import as_tensors

    ref = np.load(RESPONSE_REFERENCE)
    pot = seeded(NeuralNetworkPotential(
        PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20, cutoff=CUTOFF),
        [Atomwise(128), DipoleMoment(128, use_vector_representation=True),
         Polarizability(128)],
        input_modules=[PairwiseDistances(columns=False)]), HEADS_SEED)
    pot.to(dev).requires_grad_(False)
    samples = train_samples()
    batch = as_tensors(collate(samples, padding_for(samples)), dev)
    reset(launches)
    out = pot(batch)
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counts(launches).items() if v}
    errs = {k: rel_err(out[k].cpu(), ref[f"heads_{k}"])
            for k in (P.energy, P.dipole_moment, P.partial_charges,
                      P.polarizability)}
    ms = cuda_ms(lambda: pot(batch), reps=3)
    print(f"responses (heads): {TRAIN_MOLECULES} molecules, rel err "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f", {ms:.3f} ms per evaluation, launches {counts}; {smi}",
          flush=True)
    assert not counts, f"heads launched {counts}"
    for k, v in errs.items():
        assert v <= RESPONSE_RTOL, f"heads {k}: {v}"

    energy = NeuralNetworkPotential(
        pot.representation, [pot.output_modules[0]],
        input_modules=[PairwiseDistances(columns=False)])
    mol = train_molecules()[0]
    freqs, _ = normal_modes(energy, mol)
    hess = with_hessian(energy)
    ins = hessian_inputs(mol, CUTOFF, dev)
    ms_h = cuda_ms(lambda: hess(dict(ins)), reps=3)
    df = float(np.abs(freqs - ref["freqs"]).max() / np.abs(ref["freqs"]).max())
    print(f"responses (hessian): {len(mol['_atomic_numbers'])} atoms, "
          f"frequencies {freqs.min():.2f} .. {freqs.max():.2f} cm^-1, max "
          f"err {df:.2e} of the largest |f| (JAX "
          f"{np.abs(ref['freqs']).max():.2f}), Hessian {ms_h:.3f} ms; {smi}",
          flush=True)
    assert np.isfinite(freqs).all() and df <= FREQ_RTOL, f"freqs {df}"
    del pot, energy, hess, batch
    torch.cuda.empty_cache()


def field_phase(dev, launches, smi):
    """Phase 12c: FieldSchNet-128x5 with both fields, seeded, on
    ``field_molecules``'s batch (flat layout) with ``Response`` of
    ``FIELD_RESPONSES`` against the fixture; then the FieldSchNet asset on
    the bench box's column layout with forces and the dipole (dE/dF
    through K11-K14's VJPs), its launches counted."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.atomistic import (
        Atomwise, PairwiseDistances, Response,
    )
    from schnetpack_tpu_torch.data import collate, padding_for
    from schnetpack_tpu_torch.md import load_molecules
    from schnetpack_tpu_torch.model import NeuralNetworkPotential
    from schnetpack_tpu_torch.representation import FieldSchNet
    from schnetpack_tpu_torch.train import as_tensors

    from schnetpack_tpu_torch.transform import NeighborListTransform

    ref = np.load(RESPONSE_REFERENCE)
    props = list(FIELD_RESPONSES)
    pot = seeded(NeuralNetworkPotential(
        FieldSchNet(n_atom_basis=128, n_interactions=5, n_rbf=20,
                    cutoff=CUTOFF, response_properties=props),
        [Atomwise(128), Response(response_properties=props)],
        input_modules=[PairwiseDistances(columns=False)]), FIELD_SEED)
    pot.to(dev).requires_grad_(False)
    samples = [NeighborListTransform(CUTOFF)(m) for m in field_molecules()]
    batch = as_tensors(collate(samples, padding_for(samples)), dev)
    reset(launches)
    torch.cuda.reset_peak_memory_stats()
    out = pot(batch)
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counts(launches).items() if v}
    errs = {k: rel_err(out[k].cpu(), ref[f"field_{k}"])
            for k in ["energy"] + props}
    ms = cuda_ms(lambda: pot(batch), reps=3)
    print(f"responses (field, molecules): rel err "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f", {ms:.3f} ms per evaluation, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, launches "
          f"{counts}; {smi}", flush=True)
    assert not counts, f"field responses launched {counts}"
    for k, v in errs.items():
        assert v <= RESPONSE_RTOL, f"field {k}: {v}"
    del pot, batch, out
    torch.cuda.empty_cache()

    base, params = potential("field_schnet")
    pot = NeuralNetworkPotential(
        base.representation,
        [base.output_modules[0],
         Response(response_properties=[P.forces, P.dipole_moment])],
        input_modules=[PairwiseDistances()])
    pot.load_state_dict(params)
    pot.to(dev).requires_grad_(False)
    R, cell = ref["box_R"].astype(np.float64), ref["box_cell"]
    system = load_molecules([molecule(R, cell)], device=dev)
    calc = calculator(base, params)
    state = calc.init_state(system)
    inputs = calc.model_inputs(system, state)
    reset(launches)
    out = pot(dict(inputs))
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counts(launches).items() if v}
    F = out[P.forces].float().cpu().numpy()[state["cell_rank"].cpu().numpy()]
    mu = out[P.dipole_moment][0].double().cpu().numpy()
    rms = float(np.sqrt(np.mean((F - ref["colfield_forces"]) ** 2)))
    # the dipole is a sum over the atoms that cancels to ~1e-4 of its
    # terms: its scale is that of the terms, each atom's own dE/dF, from
    # the flat layout with every atom a molecule of its own
    flat = flat_inputs(R, cell, dev)
    A = len(R)
    flat[P.idx_m] = torch.arange(A, device=dev)
    flat[P.n_atoms] = torch.ones(A, dtype=torch.int64, device=dev)
    mu_atoms = pot(flat)[P.dipole_moment].double()
    scale = float(mu_atoms.abs().sum(0).max())
    dmu = float(np.abs(mu - ref["colfield_dipole_moment"]).max()) / scale
    ms = cuda_ms(lambda: pot(dict(inputs)), reps=3)
    print(f"responses (field, column): {layout_str(state)}, dipole "
          f"{np.array2string(mu, precision=6)} (JAX "
          f"{np.array2string(ref['colfield_dipole_moment'], precision=6)}), "
          f"max err {dmu:.2e} of the atoms' sum_a |dE/dF_a| {scale:.4g} "
          f"(the flat layout's sum of them "
          f"{np.array2string(mu_atoms.sum(0).cpu().numpy(), precision=6)}), "
          f"force rms err {rms:.3e} eV/Ang, launches "
          f"{counts}, {ms:.3f} ms per evaluation; {smi}", flush=True)
    check_launches("field column dipole", counts, PER_STEP["field_schnet"], 1)
    assert rms <= FORCE_RMS_TOL, f"field column forces {rms}"
    assert dmu <= DIPOLE_SCALE_TOL, f"field column dipole {dmu}"
    del pot, base, calc, state, inputs
    torch.cuda.empty_cache()
    return counts


def ewald_phase(dev, smi):
    """Phase 12e: ``EnergyEwald`` of rock salt (``NACL_CELLS``^3 cells,
    4,096 ions, the real-space pairs within ``NACL_RC``) in f32 on the
    card: the Madelung constant and the JAX float64 energy."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.atomistic import EnergyEwald, PairwiseDistances

    ref = np.load(RESPONSE_REFERENCE)
    R, cell, q = nacl(NACL_CELLS)
    i, j, off = nacl_pairs(R, cell, NACL_RC)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    ins = PairwiseDistances()({
        P.R: t(R), P.cell: t(cell[None]), P.idx_i: t(i, torch.int64),
        P.idx_j: t(j, torch.int64), P.offsets: t(off),
        P.pair_mask: t(np.ones(len(i))), P.n_atoms: t([len(R)], torch.int64),
        P.idx_m: t(np.zeros(len(R)), torch.int64),
        P.atom_mask: t(np.ones(len(R))), P.partial_charges: t(q)})
    ewald = EnergyEwald(**NACL_EWALD)
    E = float(ewald(dict(ins))["energy_ewald"][0])
    M = madelung(E, len(R))
    dM = abs(M / MADELUNG_NACL - 1)
    dE = abs(E / float(ref["nacl_energy"]) - 1)
    ms = cuda_ms(lambda: ewald(dict(ins)), reps=3)
    print(f"responses (ewald): {len(R)} ions, {len(i)} pairs, E {E:.6f} eV "
          f"(JAX float64 {float(ref['nacl_energy']):.6f}, rel err {dE:.2e}), "
          f"Madelung {M:.7f} (rel err {dM:.2e}), {ms:.3f} ms; {smi}",
          flush=True)
    assert dM <= MADELUNG_RTOL, f"Madelung {M}"
    assert dE <= NACL_RTOL, f"NaCl energy {dE}"


QM9_SYMBOLS = {1: "H", 6: "C", 7: "N", 8: "O", 9: "F"}
#: per-element energies (eV) of the synthetic response set's labels
RESPONSE_ATOM_ENERGY = {1: -13.6, 6: -1030.0, 8: -2040.0}
#: partial charges (e) of the synthetic sets' dipole labels by element
SYNTHETIC_CHARGES = {1: 0.3, 6: -0.1, 7: -0.3, 8: -0.4, 9: -0.2}


def synthetic_molecule(rng, elements=(1, 6, 7, 8, 9)):
    """5-12 atoms placed one by one in a 4 A cube at least 1 A apart: (Z,
    R, the dipole of ``SYNTHETIC_CHARGES`` less their mean)."""
    n = rng.randint(5, 13)
    R = [rng.rand(3) * 4.0]
    while len(R) < n:
        r = rng.rand(3) * 4.0
        if np.linalg.norm(np.asarray(R) - r, axis=1).min() >= 1.0:
            R.append(r)
    R = np.asarray(R)
    Z = rng.choice(elements, n)
    q = np.array([SYNTHETIC_CHARGES[z] for z in Z])
    return Z, R, ((q - q.mean())[:, None] * R).sum(0)


def write_qm9_archive(raw_dir, n, seed):
    """A QM9 archive (``dsgdb9nsd.xyz.tar.bz2``) of ``n`` synthetic
    molecules in QM9's xyz flavour, the dipole label |mu| of
    ``synthetic_molecule`` and the other 14 properties seeded."""
    import io
    import tarfile

    rng = np.random.RandomState(seed)
    os.makedirs(raw_dir, exist_ok=True)
    with tarfile.open(os.path.join(raw_dir, "dsgdb9nsd.xyz.tar.bz2"),
                      "w:bz2") as tar:
        for k in range(1, n + 1):
            Z, R, mu = synthetic_molecule(rng)
            props = rng.randn(15)
            props[3] = np.linalg.norm(mu)
            lines = [str(len(Z)), f"gdb {k}\t"
                     + "\t".join(f"{v:.8f}" for v in props)]
            lines += [f"{QM9_SYMBOLS[z]}\t{r[0]:.8f}\t{r[1]:.8f}\t"
                      f"{r[2]:.8f}\t0.0" for z, r in zip(Z, R)]
            data = ("\n".join(lines + ["0.0", "C", "InChI=1S/x"])
                    + "\n").encode()
            info = tarfile.TarInfo(f"dsgdb9nsd_{k:06d}.xyz")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def write_response_db(path, n, seed):
    """A database of ``n`` synthetic H/C/O molecules with the ``response``
    experiment's labels: energy the sum of per-element energies
    (``RESPONSE_ATOM_ENERGY``) and 0.01 sum(R^2), forces -0.02 R, the
    dipole of ``synthetic_molecule``, polarizability (atoms) x I,
    shielding Z x I per atom."""
    from schnetpack_tpu_torch.data import ASEAtomsData

    rng = np.random.RandomState(seed)
    ds = ASEAtomsData.create(path, distance_unit="Ang", property_unit_dict={
        "energy": "eV", "forces": "eV/Ang", "dipole_moment": "e*Ang",
        "polarizability": "Ang^3", "shielding": "ppm"})
    rows = []
    for _ in range(n):
        Z, R, mu = synthetic_molecule(rng, (1, 6, 8))
        rows.append(dict(
            numbers=Z, positions=R, energy=np.array([
                sum(RESPONSE_ATOM_ENERGY[z] for z in Z)
                + 0.01 * (R ** 2).sum()]),
            forces=-0.02 * R, dipole_moment=mu[None],
            polarizability=len(Z) * np.eye(3)[None],
            shielding=Z[:, None, None] * np.eye(3)[None]))
    ds.add_systems(rows)


def spktrain_response_phase(seed, dev, launches, smi):
    """Phase 12f: ``spktrain`` of ``experiment=qm9_dipole`` (PaiNN-128x3)
    on a synthetic QM9 archive and ``experiment=response`` (FieldSchNet-
    128x5: energy, forces, dipole, polarizability, shielding) on a
    synthetic database, ``RESPONSE_EPOCHS`` epochs each: the validation
    loss falls, and ``cli.load_model`` of the run directory gives the
    trained model's outputs within ``RESPONSE_LOAD_RTOL``."""
    import shutil
    import tempfile

    from schnetpack_tpu_torch import cli
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.train import as_tensors

    tmp = tempfile.mkdtemp(prefix="spktrain_response_")
    try:
        write_qm9_archive(os.path.join(tmp, "raw"), QM9_MOLECULES, seed + 17)
        db = os.path.join(tmp, "response.db")
        write_response_db(db, RESPONSE_MOLECULES, seed + 19)
        common = [f"run.path={tmp}/runs", f"run.data_dir={tmp}/data",
                  "trainer.progress=false", f"device={dev}",
                  f"globals.seed={seed}", "print_config=false",
                  f"trainer.max_epochs={RESPONSE_EPOCHS}"]
        runs = {
            "qm9_dipole": [f"data.raw_dir={tmp}/raw",
                           f"data.num_train={QM9_SPLIT[0]}",
                           f"data.num_val={QM9_SPLIT[1]}",
                           f"data.num_test={QM9_SPLIT[2]}"],
            "response": [f"data.datapath={db}",
                         f"data.num_train={RESPONSE_SPLIT[0]}",
                         f"data.num_val={RESPONSE_SPLIT[1]}",
                         f"data.num_test={RESPONSE_SPLIT[2]}"]}
        for name, extra in runs.items():
            cfg = cli.default_composer().compose("train", [
                f"experiment={name}", f"run.id={name}"] + common + extra)
            reset(launches)
            t0 = time.perf_counter()
            metrics, task, state, dm = cli.fit(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in read_counts(launches).items() if v}
            run = os.path.join(tmp, "runs", name)
            losses = val_losses(run)
            best = torch.load(os.path.join(run, "checkpoints", "best.ckpt"),
                              weights_only=False)
            state.load_state_dict(best["state"])
            batch = as_tensors(next(iter(dm.test_dataloader())), dev)
            M = int(batch[P.mol_mask].sum())
            mine = task.model(batch)
            loaded, _ = cli.load_model(run, dev)
            theirs = loaded(batch)
            diff = 0.0      # relative: the atomics' f32 sums differ a call
            for k in task.model.model_outputs:
                a, b = mine[k].detach(), theirs[k].detach()
                if a.shape[0] == batch[P.n_atoms].shape[0]:
                    a, b = a[:M], b[:M]
                diff = max(diff, float((a - b).abs().max() / a.abs().max()))
            rep = task.model.representation
            print(f"spktrain ({name}, {type(rep).__name__}-"
                  f"{rep.n_atom_basis}x{len(rep.interactions)}): "
                  f"{RESPONSE_EPOCHS} epochs of {len(dm.train_idx)} "
                  f"molecules in {state.step} steps, {wall:.1f} s "
                  f"({1e3 * wall / state.step:.1f} ms/step with validation "
                  f"and checkpoints), val loss by epoch "
                  f"{', '.join(f'{v:.6g}' for v in losses)}, test "
                  f"{', '.join(f'{k} {v:.6g}' for k, v in metrics.items())}"
                  f", load_model max |d| {diff:.3e} of the largest entry of "
                  f"{task.model.model_outputs}, launches {counts}; {smi}",
                  flush=True)
            assert len(losses) == RESPONSE_EPOCHS and losses[-1] < losses[0], (
                f"{name}: val losses {losses}")
            assert all(np.isfinite(v) for v in metrics.values())
            assert diff <= RESPONSE_LOAD_RTOL, f"{name}: load_model {diff}"
            assert not counts, f"{name}: launched {counts}"
            del task, state, dm, loaded, mine, theirs
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def npt_model_phase(seed, dev, launches, smi):
    """Phase 12g: ``spkmd dynamics=npt`` with a PaiNN-128x3 run directory
    whose model has ``Forces(calc_stress=True)`` (the asset's weights),
    ``calculator.stress_key=stress`` on ``all_pairs``, NHC iso barostat
    (``NPT_MODEL_ARGS``), on a 500-atom FCC argon box: the
    stress at step 0 equals a one-off ``calculate``'s; from the same state,
    ``NPT_MODEL_STEPS`` steps at each of ``NPT_PRESSURES``, finite, V/V0
    within ``NPT_VOLUME``, and the higher pressure ends at the smaller
    volume."""
    import pickle
    import shutil
    import tempfile

    from schnetpack_tpu_torch.md import cli

    pos, cell = fcc_box(NPT_BOX)
    v0 = abs(np.linalg.det(cell))
    tmp = tempfile.mkdtemp(prefix="spkmd_npt_model_")
    try:
        box = write_xyz(os.path.join(tmp, "box.xyz"), pos, cell)
        run = write_run_dir(os.path.join(tmp, "run"), ASSET["painn"])
        cfg = dict(PAINN_RUN_CONFIG, output_modules=[
            PAINN_RUN_CONFIG["output_modules"][0],
            {"_target_": "schnetpack_tpu.atomistic.Forces",
             "calc_stress": True}])
        with open(os.path.join(run, "model_config.pkl"), "wb") as f:
            pickle.dump(cfg, f)
        volumes = {}
        for pressure in NPT_PRESSURES:
            args = NPT_MODEL_ARGS + [
                f"barostat.target_pressure={pressure}",
                f"system.molecule_file={box}", f"calculator.model_dir={run}",
                "calculator.stress_key=stress",
                "calculator.neighbor_list=all_pairs", "dynamics=npt",
                "barostat=nhc_iso", f"device={dev}", f"seed={seed}",
                "dynamics.n_steps=0", "callbacks.file_logger=null",
                "callbacks.checkpoint=null",
                f"simulation_dir={tmp}/npt_{pressure:g}"]
            reset(launches)
            sim = cli.main(args)
            s0 = sim.system.stress.clone()
            calc = sim.calculator
            one = calc.calculate(sim.system, calc.init_state(sim.system))
            d0 = float((s0 - one.stress).abs().max() / s0.abs().max())
            t0 = time.perf_counter()
            ms, _ = timed_run(sim, NPT_MODEL_STEPS, chunk_size=100)
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in read_counts(launches).items() if v}
            s = sim.system
            v1 = float(s.volume[0, 0]) * 1e3          # nm^3 -> A^3
            volumes[pressure] = v1
            print(f"spkmd (npt_model, {pressure:g} bar): {s.total_atoms} "
                  f"atoms, all_pairs, {NPT_MODEL_STEPS} steps, V/V0 "
                  f"{v1 / v0:.5f}, step-0 stress vs a one-off calculate max "
                  f"|d| {d0:.3e} of its largest, P(end) {float(s.pressure[0, 0]):.6g}, "
                  f"{ms:.3f} ms/step ({wall:.1f} s), launches {counts}; "
                  f"{smi}", flush=True)
            assert d0 <= NPT_STRESS_RTOL, f"step-0 stress {d0}"
            assert torch.isfinite(s.positions).all()
            assert torch.isfinite(s.cells).all()
            assert NPT_VOLUME[0] < v1 / v0 < NPT_VOLUME[1], v1 / v0
            assert not counts, f"npt_model launched {counts}"
        lo, hi = NPT_PRESSURES
        assert volumes[hi] < volumes[lo], volumes
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def response_phase(seed, dev, launches, smi):
    """Phase 12, responses (see the module's docstring); returns the
    launch counts of its kernel paths."""
    t0 = time.perf_counter()
    total = {}
    for part in (stress_phase, heads_phase, field_phase):
        for k, v in (part(dev, launches, smi) or {}).items():
            total[k] = total.get(k, 0) + v
    ewald_phase(dev, smi)
    spktrain_response_phase(seed, dev, launches, smi)
    npt_model_phase(seed, dev, launches, smi)
    print(f"responses: phase 12 took {time.perf_counter() - t0:.1f} s; "
          f"{smi}", flush=True)
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    import schnetpack_tpu_torch  # noqa: F401 (sets f32 matmul precision)
    from schnetpack_tpu_torch.md import load_molecules
    from schnetpack_tpu_torch.ops import _build
    from schnetpack_tpu_torch.ops import cellblock_gather as cg
    from schnetpack_tpu_torch.ops import colblock_edge as edge
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op
    from schnetpack_tpu_torch.ops import colblock_message as msg
    from schnetpack_tpu_torch.ops import colblock_select as sel
    from schnetpack_tpu_torch.ops import painn_fused as pf
    from schnetpack_tpu_torch.ops import painn_mixing as mix
    from schnetpack_tpu_torch.ops import schnet_columns as cf

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.build_seconds:.1f} s)", flush=True)
    for src, params in PTXAS_SOURCES.items():
        for inst, regs, frame, st, ld in ptxas_report(
                _build.build_log.get(src, ""), params):
            print(f"ptxas {src}: {inst}: {regs} registers, {frame} bytes "
                  f"stack frame, {st} bytes spill stores, {ld} bytes spill "
                  "loads", flush=True)

    pos, cell = fcc_box(10_000)
    system = load_molecules([molecule(pos, cell)], device=dev)
    rows = kernel_phase(calculator(*potential("hybrid")), system, args.seed,
                        dev)
    rows += schnet_kernel_phase(calculator(*potential("schnet")), system,
                                args.seed, dev)
    so3 = calculator(*potential("so3net"))
    rep = so3.model.representation
    rows_d9f, rows_d3 = select_kernel_phase(
        so3, system, args.seed, dev,
        ((rep.lmax + 1) ** 2 * rep.n_atom_basis, 3))
    rows_field = select_kernel_phase(
        calculator(*potential("field_schnet")), system, args.seed, dev,
        (128, 384), ", field_schnet")
    for row, r3, r128, r384 in zip(rows_d9f, rows_d3, *rows_field):
        row.update(d3=sub_row(r3), d128=sub_row(r128), d384=sub_row(r384))
    rows += rows_d9f
    edge_rows, halo_modes = edge_kernel_phase(pos, cell, args.seed, dev)
    rows += edge_rows
    by_name = {row["name"]: row for row in rows}
    for name, modes in halo_modes.items():   # K11/K12 on the slab's halo
        by_name[name]["modes"] = modes
    for row in cell_kernel_phase(calculator(*potential("painn_cell"),
                                            layout="atom"), system,
                                 args.seed, dev):
        if row["name"] in by_name:   # K3/K4 at the 27-cell layout's rows
            by_name[row["name"]]["cell"] = sub_row(row)
        else:
            rows.append(row)
    print(f"profiler: {TRACES['taken']} traces, {TRACES['retaken']} taken "
          "again (lost kernels)", flush=True)
    reference_phase(dev)
    launches = (msg.LAUNCHES, mix.LAUNCHES, geo_op.LAUNCHES, cf.LAUNCHES,
                sel.LAUNCHES, cg.LAUNCHES, pf.LAUNCHES, edge.LAUNCHES)
    wgrad_launches = grad_phase(dev, launches)
    rebuild_phase(args.seed, dev)
    total = {}
    ms_step = {}
    for path in PATHS:
        counts, ms_step[path] = md_phase(path, pos, cell, args.steps,
                                         args.seed, dev, launches)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    counts, ms_step["painn_slab"] = slab_md_phase(pos, cell, args.steps,
                                                  args.seed, dev, launches)
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    start = None        # NHC continues from the Langevin run's last state
    for name in NVT_TOL:
        counts, start, ms_step[name], _ = nvt_phase(
            name, pos, cell, args.seed, dev, launches, smi, start)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    for k, v in rpmd_phase(pos, cell, args.seed, dev, launches, smi).items():
        total[k] = total.get(k, 0) + v
    for k, v in spkmd_phase(pos, cell, args.seed, dev, launches,
                            smi).items():
        total[k] = total.get(k, 0) + v
    layout_phase(args.seed, dev, launches, smi)
    train_phase(args.seed, dev, launches, smi)
    for k, v in response_phase(args.seed, dev, launches, smi).items():
        total[k] = total.get(k, 0) + v
    for row in rows:
        row["launches"] = total[row["name"]]
        assert row["launches"] > 0, f"{row['name']} never ran in the MD"
        key = row["name"] + "_wgrad"
        if key in wgrad_launches:   # an instance with its own counter
            row["wgrad"]["launches"] = wgrad_launches[key]
    for key in ("mix_bwd_wgrad", "cf_bwd_wgrad", "msg_bwd_edge_wgrad"):
        assert wgrad_launches.get(key, 0) > 0, f"{key} never ran"
    print(f"md ms/step PaiNN hybrid {ms_step['hybrid']:.3f}, PaiNN full "
          f"{ms_step['full']:.3f}, SchNet {ms_step['schnet']:.3f}, SO3net "
          f"{ms_step['so3net']:.3f}, PaiNN trbf {ms_step['painn_trbf']:.3f}, "
          f"PaiNN cell {ms_step['painn_cell']:.3f}, PaiNN slab "
          f"{ms_step['painn_slab']:.3f}, FieldSchNet "
          f"{ms_step['field_schnet']:.3f} on {smi}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
