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
   K1/K2 and K6/K7 also in their instances of the reduced-precision
   feature mode (sub-rows "mixed" and "bf16", K2/K7 also with wgrad), on
   the same inputs with the features and cotangents in the mode's type
   (bf16 at one piece, so the bound counts the mode's bytes), held to
   their twins at the same pieces: per edge a rounding flip of one ulp of
   the mode (2^-7 of the term at bf16, 2^-15 at mixed) on top of the f32
   tolerance, S the sum of the terms' absolute values (the twin on
   |inputs|), and K2/K7's dR within 2^-7 of max |dR| at bf16;
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
13. the reduced-precision feature mode (``precision_phase``; the
   calculator's ``precision``, ``ops/precision.py``), each part's launches
   counted from zero: (a) PaiNN-128x3 in ``fuse`` full and hybrid at
   mixed and bf16 on ``port_ref_painn_argon.npz``'s box against that JAX
   f32 fixture: max |dF| / max |F| < 5e-3 (mixed) and < 5e-2 (bf16), the
   JAX package's own envelope (``tests/test_colblock.py:676-677``), the
   rms error over the force rms printed beside the JAX package's TPU
   study (0.75 %), full against hybrid (rms) at each mode, K1/K2 (full)
   or K5 1 and K6/K7 (hybrid) in the mode's instances, 3 each with
   K3/K4; (b) 300 NVE steps of ``full`` at bf16 on the bench box with
   phase 6's gates and launches, then 1,000 NVE steps each at f32 and at
   bf16 from that run's last state, their energy drift (max and slope)
   side by side; (c) the launches per step of every run in the mode's
   instances, as at f32; (d) the ms/step of ``full`` and ``hybrid`` at
   f32, mixed and bf16 (CUDA events, the median of 5 alternated chunks of
   100 steps, peak device memory); (e) ``spkmd`` at
   ``calculator.precision=bf16`` from a PaiNN run directory written as
   phase 9's: ``build_calculator``'s forces on the fixture's box at (a)'s
   gate, then one 20-step chunk each of NVE, 8-bead RPMD and the
   two-member ensemble with their ms/step; (f) PaiNN and SchNet on the
   27-cell layout and SO3net on the column layout refuse bf16
   (``ReducedPrecisionPathError``) before any launch; the sub-rows'
   launches are this phase's;
14. the interfaces (``interfaces_phase``), on the flat layout as in the
   JAX package, so no kernel may launch over the phase: (a)
   ``SpkCalculator`` with the trained PaiNN-128x3 from a run directory
   (``write_run_dir``, ``utils.load_model``) on the card on
   ``port_ref_painn_argon.npz``'s 10,976-atom box at phase 4's gates, a
   repeat with the same positions evaluating nothing and moved positions
   once, the host neighbor list's ms apart from the evaluation's; (b)
   ``LammpsModelServer`` on the card serving the deployed artifact
   (per-atom energies): the port's ``test_client.cpp`` built with g++ on a
   2,048-atom FCC box jittered by a seeded +-0.1 A (energy, the per-atom
   energies' sum and forces within 1e-5 eV/Ang rms of (a)'s calculator;
   the per-atom energies, by the Python client, within 1e-5 eV of the
   model's), the Python client (``ModelClient``) on the fixture's box at
   phase 4's gates, its virial within 1e-4 of the virial's scale (the
   largest entry of sum_i |r_i (x) F_i|) of -V x the flat ``Strain``
   stress, a two-rank partial request within 1e-6 eV/Ang of the single
   domain, the median round trip of 10 requests beside the in-process
   evaluation; (c) ``deploy`` with ``export_program=True`` on the card:
   the loaded artifact's weights, and its forces under deterministic
   algorithms, equal the run directory's bit for bit, and the exported
   program's forces at its two-atom example within 1e-6 of the eager
   maximum; (d) a synthetic reference-format PaiNN-128x3 (seeded random
   weights) imported onto the card and onto the CPU: forces on the
   2,048-atom box within 1e-5 of the CPU's maximum; (e) ``batchwise_lbfgs``
   of phase 10's 64 clusters: every fmax under 0.05 eV/Ang within 200
   iterations, no energy above its start (1e-6 of it: a frozen cluster is
   evaluated again), ms per iteration; (f) ``spkmd calculator=orca`` with
   a stub ``orca`` (a Python LJ argon script writing ORCA's energy and
   gradient blocks) on 8 argon atoms, 20 NVE steps: drift <= 1e-4
   eV/atom, the last forces within 1e-6 of max |F| of -dE/dR of the
   stub's potential at the last ``.inp``'s positions;
15. the host cell list and the rest of the one-card MD engine
   (``engine_phase``), each run's launches counted from zero: (a) the
   native (C++, ``native/cellist.py``) and the numpy cell list of the
   bench box at 5 + 0.6 A equal array for array, their times (median of
   5), the column host build and ``SpkCalculator``'s host neighbor list
   and collate, printed beside PR 25's; (b) ``painn_slab`` under Langevin
   (``SpatialColumnSimulator(kT, gamma, seed)``; 300 steps at 0.5 fs,
   bath 30 K, tau 20 fs, 25-step chunks): a gamma = 0 chunk equal to the
   NVE chunk bit for bit over 50 steps (and two NVE chunks equal), the
   card's normal draws within 1e-6 of the CPU's, the mean chunk-end
   temperature of the last third within 3 K of the bath, 0 < T < 300 K
   at every chunk end, NVE slab's launches per force evaluation, ms/step
   beside the NVE chunk's and the re-bins' host seconds; (c)
   ``make_sharded_column_md`` (20 steps) and ``make_sharded_column_rpmd``
   (8 beads, 10 steps) on the bench box against a host-driven loop of
   ``make_sharded_column_eval`` with the same arithmetic, within 1e-5 A,
   K11-K14 1 and K20/K21/K3/K4 3 a bead per evaluation; (d) phase 10's 64
   clusters on the column layout (``neighbor_list="cellblock"``, PaiNN
   ``fuse="full"``): forces within 1e-5 eV/Ang rms and per-molecule
   energies within 1e-5 relative of ``all_pairs``, K1-K4 3 each per
   evaluation, 300 NVE steps (drift <= 1e-4 eV/atom, 0 < T < 300 K, the
   host rebuilds counted, none on the device), ms/step beside 100 steps
   on ``all_pairs``;
16. several ranks (``parallel_phase``): two ranks on the one card
   through an explicit gloo group (``parallel.mesh.spawn_ranks``, the
   workers ``parallel_rank``; the halo planes cross through the host),
   against one rank: the trained PaiNN-128x3's slab forces on
   ``port_ref_painn_argon.npz``'s box on x slabs (dims (2,), (5, 10)
   columns a rank) and (x, y) blocks (dims (1, 2), (10, 5) columns a
   rank, the y exchange across the ranks) within 1e-5 eV/Ang of one
   rank's slab evaluation and within phase 4's gates of the fixture; a
   50-step NVE chunk on the x slabs and a 25-step Langevin chunk at 30 K
   on the blocks within 2e-4 A of one rank's (the noise drawn per global
   column); each rank's launches (K11-K14 1, K20/K21/K3/K4 3 an
   evaluation); two data-parallel PaiNN-128x3 train steps on phase 11's
   batch and a relabelled copy, one a rank (SGD with momentum, clipped),
   every leaf of the averaged gradient and of the parameters within 1e-5
   of one rank on the mean of both batches' gradients (deterministic
   algorithms on both sides); ms/step per rank and the exchange's share
   beside one rank's;
17. every width (``widths_phase``): (a) the general instances of the
   message (K1/K2, K6/K7, K15 at (F, B) = (30, 50, 130, 288, 512; 20) and
   (30; 31, 50), plain and wgrad; K1/K2 and K6/K7 mixed and bf16 at F = 30
   and 288), mixing (K3/K4 plain and wgrad at F = 30-1024 on 37 and
   12,800 rows) and cfconv kernels (K9/K10 plain and wgrad at F = 30-1024
   and B = 20, and F = 64 and 128 at B = 50-2000) against their twins on a
   2,048-atom box, at the general plans' switches, the backwards and gFW
   held to the float64 twins (``held_compare``); the general instances'
   rows at F = 30 on the bench box with F = 512 sub-rows and K9's and
   K10's at (F, B) = (64, 300), the redesigned instances' device and per
   call ms beside their readings before the redesign, their bounds, 3xTF32
   floors and ratios; (b) PaiNN-30x3 (full, hybrid) and
   SchNet-30x3 on the column layout against
   ``port_ref_{painn,schnet}_w30_argon.npz`` at phase 4's gates, then 300
   NVE steps each (drift <= WIDTH_DRIFT_TOL,
   the general instances' launches a step); 20 steps each on the row-9,
   27-cell and slab paths, of PaiNN-384x1 (K3's general instance) and in
   the mixed and bf16 modes; one parameter gradient of PaiNN-30x3 (full,
   slab) and SchNet-30x3 (the general wgrad instances); (c) SchNet-64x3 at
   300 Gaussians against ``port_ref_schnet_b300_argon.npz``;
18. print the kernel table (every row and sub-row with ``ms`` and
   ``device_ms``, ``library_ms`` and ``library_device_ms``) and the card
   as JSON, then the result line.

The parameter gradients of phase 4 run before the device rebuild of phase
5, and the launches of row 12's, the mixing's and the cfconv's wgrad
instances in the table are those of phase 4's evaluations (phase 17's
general wgrad instances: its gradients').
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
#: the reduced-precision feature mode (phases 3 and 13): a message
#: kernel's instance against its twin at the same pieces may round an
#: edge's term one ulp of the mode apart (2^-7 at one piece, 2^-15 at two,
#: of that term); dR, through the geometry chain, within 2^-7 of max |dR|
#: at one piece.  Those bounds hold an instance that leaves out its
#: per-edge rounding as well (at most half an ulp a term), so each output's
#: mode effect is held too: the instance's distance from the f32 instance
#: on the same rounded inputs over its twin's from the f32 twin, in rms,
#: within MODE_EFFECT (the same rounding of the same values: ~1; an
#: instance that skips a rounding point: ~0 on the outputs it reaches)
REDUCED = ("mixed", "bf16")
MODE_EFFECT = (0.5, 2.0)
#: the message kernels with mixed and bf16 instances (counted apart)
MODE_KERNELS = ("msg_fwd", "msg_bwd", "msg_fwd_geo", "msg_bwd_geores")
#: phase 13: max |dF| / max |F| against the JAX f32 fixture, the JAX
#: package's own envelope of its modes (tests/test_colblock.py:676-677)
PRECISION_FORCE_TOL = {"mixed": 5e-3, "bf16": 5e-2}
#: the JAX package's TPU study of its bf16 mode: force rms error over the
#: force rms against exact f32 (bench.py:278-282, accuracy only)
JAX_STUDY_RMS = 0.0075
PRECISION_NVE_STEPS = 300
PRECISION_DRIFT_STEPS = 1000     # each of f32 and bf16 from one state
PRECISION_ROUNDS = 5             # alternated timing chunks a path and mode
PRECISION_CHUNK = 100
PRECISION_SPKMD_STEPS = 20       # one chunk
REDUCED_ULP = {2: 2.0 ** -15, 1: 2.0 ** -7}
DR_SHARE = 2.0 ** -7
#: the mixing's and cfconv's weight cotangents vs the f64 twin, normwise
#: (||g - w|| <= NORM_RTOL ||w||): sums over 12,800 rows or ~200k edges of
#: products of the kernels' f32 factors, whose rounding (~1e-6 relative
#: after 128-long dot products) walks; f64 partials remove only the
#: summation order's error
NORM_RTOL = 1e-5
#: the sources of the ptxas report of the build (the message, mixing and
#: cfconv kernels) and their template kernels' parameters, per kernel name
_MSG_FWD = {"msg_fwd_kernel": ("kIn", "kB4", "kP")}
_MSG_BWD = {"msg_bwd_kernel": ("kMode", "kWgrad", "kB4", "kP")}
_MSG_BWD_GEN = {"msg_bwd_gen_kernel": ("kMode", "kWgrad", "kB4", "kP",
                                      "kScr")}
PTXAS_SOURCES = {
    **{f"colblock_message{m}.cu": _MSG_FWD for m in ("", "_mixed", "_bf16")},
    **{f"colblock_message_bwd{m}.cu": _MSG_BWD
       for m in ("", "_mixed", "_bf16")},
    "painn_mixing.cu": {"mix_fwd_kernel": ("ROWS", "NW")},
    "schnet_columns.cu": {"cf_fwd_kernel": ("F",),
                          "cf_bwd_kernel": ("kWgrad", "F")},
    "colblock_message_gen.cu": {"msg_fwd_gen_kernel": ("kIn", "kP"),
                                **_MSG_BWD_GEN},
    **{f"colblock_message_gen_{m}.cu": _MSG_BWD_GEN
       for m in ("mixed", "bf16")},
    "schnet_columns_gen.cu": {"cf_fwd_gen_kernel": ("kWide", "kScr"),
                              "cf_bwd_gen_kernel": ("kWgrad", "kWide",
                                                    "kScr")},
    "painn_mixing_gen.cu": {"mix_bwd_gen_kernel": ("NT1", "NT2", "kScr")}}
#: the numbers of a kernel row that its sub-rows carry
SUB_KEYS = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "tf32x3_floor_ms", "library_ms", "library_device_ms",
            "mode_effect", "wgrad")
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
BF16_FLOP_PER_S = 989e12         # bf16 on the tensor cores, dense, same
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
#: phase 15, the host cell list and the rest of the one-card MD engine
#: (``engine_phase``): PR 25's host times on this card kind (NVIDIA H100
#: 80GB HBM3, 700 W; ``chiprun_out/p25/smoke_final.txt:155, 170, 325``),
#: printed beside this run's
PR25_HOST = {"column host build": "0.490 s",
             "SpkCalculator neighbor list + collate": "401.8 ms",
             "painn_slab re-bins": "6 in 4.098 s"}
ENGINE_REPS = 5                  # the edge lists' timings: median of
ENGINE_CHUNK = 25                # the slab Langevin run: steps per chunk
ENGINE_STEPS = 300               # ... and steps (phase 7's settings)
ENGINE_BITWISE_STEPS = 50        # gamma = 0 against NVE, bit for bit
DRAW_TOL = 1e-6                  # the card's normal draws vs the CPU's
SHARDED_MD_STEPS = 20
SHARDED_BEADS, SHARDED_RPMD_STEPS = 8, 10
SHARDED_TOL = 1e-5               # Angstrom, vs a host-driven eval loop
HBAR_EV_FS = 0.6582119569        # eV fs
MULTIMOL_FORCE_RMS = 1e-5        # eV/Ang, column vs all_pairs
MULTIMOL_E_RTOL = 1e-5           # per molecule
MULTIMOL_STEPS = 300
MULTIMOL_REF_STEPS = 100         # all_pairs steps timed beside them


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


#: traces that ``device_ms`` took, those it took again (lost kernels) and
#: the times it estimated the lost ones
TRACES = {"taken": 0, "retaken": 0, "estimated": 0}


def device_ms(fn, reps=10, tries=8):
    """Mean device time of ``fn``: the durations of the kernels (and
    copies) that ``reps`` back-to-back calls ran on the card, summed from
    ``torch.profiler``'s CUDA trace, over ``reps``.  A first step of
    ``reps`` calls warms the tracer up and is dropped, and the measured
    calls start a few ms into their step (the trace can miss the first
    kernels of a window); a trace in which some kernel did not run a
    multiple of ``reps`` times lost kernels and is taken again, each try
    waiting twice as long before its calls and after they end (5 ms, then
    10, ...: phase 17's sweep once lost a kernel five times at 5 ms, and
    in a whole run two of ten calls' kernels in all eight tries when the
    waits came before the calls only).  Where every try lost some, each
    kernel counts its mean duration times its launches a call, its count
    over ``reps`` rounded (a whole run's phase 17 once lost the first two
    fills of a window in all eight tries: 18 of 20).  The step's own range
    on the device (``ProfilerStep``) is no kernel."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(tries):
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
                time.sleep(0.005 * 2 ** attempt)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                time.sleep(0.005 * 2 ** attempt)
                prof.step()
        us = sum(e.device_time_total for e in traced)
        if us > 0 and all(e.count % reps == 0 for e in traced):
            return us / 1e3 / reps
        TRACES["retaken"] += 1
    per_call = {e.key: round(e.count / reps) for e in traced}
    if not traced or not all(per_call.values()):
        raise AssertionError(
            f"the profiler's trace lost kernels in {tries} tries: "
            f"{[(e.key, e.count) for e in traced]}")
    TRACES["estimated"] += 1
    print(f"device_ms: lost kernels in {tries} tries, estimated from each "
          f"kernel's mean: {[(e.key[:60], e.count) for e in traced]}",
          flush=True)
    return sum(e.device_time_total / e.count * per_call[e.key]
               for e in traced) / 1e3


def in_f64(fn, *args):
    """``fn`` on float64 copies of its float32 tensor arguments, its outputs
    rounded to float32."""
    out = fn(*[a.double() if torch.is_tensor(a) and a.dtype == torch.float32
               else a for a in args])
    return tuple(o.float() for o in out)


def compare(name, got, want, norm_from=None, exact=False, bound=None):
    """Max abs difference; elementwise rtol/atol (``exact``: equal), from
    output ``norm_from`` on normwise; with ``bound`` (a reduced-precision
    instance), per output an elementwise bound tensor, a float (a share of
    the output's max |value|) or None (rtol/atol)."""
    rtol, atol = (0.0, 0.0) if exact else (RTOL, ATOL)
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if bound is not None and bound[i] is not None:
            lim = bound[i]
            if isinstance(lim, float):
                lim = lim * float(w.abs().max())
            worst = float(((g - w).abs() / lim).max())
            assert worst <= 1.0, (
                f"{name}: output {i} off by {worst:.3f} of its bound")
        elif norm_from is not None and i >= norm_from:
            d = float((g.double() - w.double()).norm())
            assert d <= NORM_RTOL * float(w.double().norm()), (
                f"{name}: output {i} off by {d} (norm {w.norm()})")
        else:
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{name}: {m}")
        err = max(err, float((g - w).abs().max()))
    return err

#: phase 14, the interfaces (``interfaces_phase``): the C++ client's box
#: (its edge list is a brute-force search over 27 images, so 2,048 atoms),
#: the gates and the relaxation and ORCA runs
IFACE_CELLS = 8                  # 8^3 FCC cells: 2,048 atoms
IFACE_JITTER = 0.1               # Angstrom, seeded
IFACE_RMS_TOL = 1e-5             # eV/Ang: server vs SpkCalculator
IFACE_E_ATOM_ATOL = 1e-5         # eV: the server's per-atom energies
PARTIAL_ATOL = 1e-6              # eV/Ang: two ranks vs one domain
VIRIAL_SCALE_TOL = 1e-4          # of the virial's scale
PROGRAM_SCALE_TOL = 1e-6         # of the largest |F|: exported vs eager
IMPORT_SCALE_TOL = 1e-5          # of the largest |F|: card vs CPU import
ROUND_TRIPS = 10                 # requests timed, the median kept
RELAX_FMAX, RELAX_STEPS = 0.05, 200   # eV/Ang; LBFGS iterations
RELAX_E_RTOL = 1e-6              # a frozen cluster's energy, re-evaluated
ORCA_STEPS = 20
ORCA_DRIFT_TOL = 1e-4            # eV per atom
ORCA_FORCE_TOL = 1e-6            # of the largest |F|: the gradient's digits
LJ_EPS, LJ_SIGMA = 0.0104, 3.4   # eV, Angstrom: the stub's argon
#: the stub ``orca`` executable: LJ argon of the ``.inp``'s atoms, ORCA's
#: energy (Hartree) and gradient (Hartree/Bohr) blocks on its output
ORCA_STUB = '''#!{python}
import sys

EPS, SIGMA, HARTREE, BOHR = {eps!r}, {sigma!r}, {hartree!r}, {bohr!r}
lines = open(sys.argv[1]).read().splitlines()
start = lines.index("* xyz 0 1") + 1
atoms = [ln.split() for ln in lines[start:lines.index("*", start)]]
R = [[float(x) for x in a[1:4]] for a in atoms]
E, G = 0.0, [[0.0, 0.0, 0.0] for _ in R]
for i in range(len(R)):
    for j in range(len(R)):
        if i == j:
            continue
        d = [R[i][k] - R[j][k] for k in range(3)]
        r2 = sum(x * x for x in d)
        sr6 = (SIGMA * SIGMA / r2) ** 3
        E += 2 * EPS * (sr6 * sr6 - sr6)
        for k in range(3):
            G[i][k] += 4 * EPS * (6 * sr6 - 12 * sr6 * sr6) / r2 * d[k]
print("FINAL SINGLE POINT ENERGY %.12f" % (E / HARTREE))
print("------------------\\nCARTESIAN GRADIENT\\n------------------\\n")
for k, (a, g) in enumerate(zip(atoms, G)):
    g = [x * BOHR / HARTREE for x in g]
    print("%4d   %s  : %16.12f %16.12f %16.12f" % (k + 1, a[0], *g))
'''


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
               layout="column", wgrad=False, precision=None):
    from schnetpack_tpu_torch.md import CellBlockNeighborListMD
    from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
    from schnetpack_tpu_torch.units import _parse_unit, md_units

    conv = _parse_unit("Ang") * md_units().length
    nbl = CellBlockNeighborListMD(CUTOFF * conv, skin=SKIN * conv,
                                  layout=layout, jitter_fraction=jitter,
                                  bucket_headroom=headroom)
    return SchNetPackCalculator(pot, params, cutoff=CUTOFF, cutoff_shell=SKIN,
                                neighbor_list=nbl, wgrad=wgrad,
                                precision=precision)


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


def bound(n_bytes, flops, bf16_flops=0):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes at the HBM rate and the operations: the FP32
    ``flops`` at the FP32 peak or the ``bf16_flops`` (products with bf16
    operands on the tensor cores) at the bf16 peak, whichever is longer
    (the two units run side by side)."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * max(flops / FP32_FLOP_PER_S, bf16_flops / BF16_FLOP_PER_S)
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
        if c.get("ref64"):   # phase 17: the float64 twin, ``held_compare``
            want = c["ref64"]()
            err = held_compare(name, got, plain(), want, c.get("norm_from"))
        else:
            want = (c.get("ref") or plain)()
            err = compare(name, got, want, c.get("norm_from"),
                          c.get("exact", False), c.get("bound"))
        effect = ""
        if c.get("control"):
            ratios = mode_effect(name + c.get("tag", ""), got, want,
                                 c["control"])
            effect = ", mode effect " + "/".join(
                "-" if r is None else f"{r:.3f}" for r in ratios)
        del want
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        dev_ms = device_ms(kern)
        lib_ms = lib_dev_ms = None
        if c.get("library"):
            lib_ms = cuda_ms(c["library"])
            lib_dev_ms = device_ms(c["library"])
        bound_ms, bound_by = bound(nbytes(c["inputs"], got), c["flops"],
                                   c.get("bf16_flops") or 0)
        lib = ("none" if lib_ms is None
               else f"{lib_ms:.4f} ms (device {lib_dev_ms:.4f})")
        floor = ""
        if c.get("tc_flops"):   # the kernel's own 3xTF32 work
            floor_ms = 1e3 * c["tc_flops"] / TF32_FLOP_PER_S
            floor = f", 3xTF32 floor {floor_ms:.4f} ms"
        if c.get("bf16_flops"):   # the products with bf16 operands
            floor += (f", its bf16 tensor-core products "
                      f"{1e3 * c['bf16_flops'] / BF16_FLOP_PER_S:.4f} ms")
        print(f"kernel {name}{c.get('tag', '')}: max_abs_err={err:.3e} "
              f"{ms:.4f} ms (device {dev_ms:.4f}; plain twin {plain_ms:.4f} "
              f"ms, library {lib}, bound {bound_ms:.4f} ms by {bound_by}"
              f"{floor}{effect})", flush=True)
        row = {"name": name, "route": "cuda",
               "source": f"schnetpack_tpu_torch/csrc/{c['src']}",
               "replaces": f"schnetpack_tpu/ops/{c['replaces']}",
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "library_device_ms": lib_dev_ms}
        if c.get("tc_flops"):
            row["tf32x3_floor_ms"] = floor_ms
        if effect:
            row["mode_effect"] = ratios
        if c.get("wgrad"):   # the kernel's wgrad instance, also gFW
            (w,) = check_kernels([dict(c, **{"tc_flops": None, **c["wgrad"]},
                                       wgrad=None,
                                       tag=c.get("tag", "") + " (wgrad)")])
            row["wgrad"] = sub_row(w)
        rows.append(row)
    return rows


def rms(t):
    return float(t.double().square().mean().sqrt())


def mode_effect(name, got, want, control):
    """Per output, the reduced instance's mode effect over its twin's:
    rms(instance - f32 instance) / rms(twin - f32 twin), the f32 pair
    of ``control`` (its f32 instance, its f32 twin and the number of
    leading outputs that a rounding of the mode reaches) on the inputs
    rounded as the mode rounds them, held to ``MODE_EFFECT``; None for the
    outputs the mode leaves exact (on the card the twin's sums there can
    still differ run to run)."""
    kern3, plain3, reached = control
    out = []
    for i, (g, w, g3, w3) in enumerate(zip(got, want, kern3(), plain3())):
        if i >= reached:
            out.append(None)
            continue
        r = rms(g - g3) / rms(w - w3)
        assert MODE_EFFECT[0] <= r <= MODE_EFFECT[1], (
            f"{name}: output {i}'s mode effect is {r:.3f} of its twin's")
        out.append(r)
    return out


def sub_row(row):
    """The numbers of a row, for a sub-row of another (a wgrad instance, a
    width, a source-index mode or a layout)."""
    return {k: row[k] for k in SUB_KEYS if k in row}


def case(name, src, replaces, kern, plain, inputs, flops, library=None,
         wgrad=None, exact=False, tc_flops=None, bound=None,
         bf16_flops=None, control=None):
    """One kernel of the table; ``wgrad`` (``kern``, ``plain``, ``flops``
    and ``ref``, what the kernel is held to, where that is not ``plain``)
    adds its wgrad instance as a sub-row; ``exact``: a copy, held to its
    twin bit for bit; ``tc_flops``: the operations of a kernel that runs
    its products as three TF32 passes on the tensor cores, whose time at
    the TF32 peak is printed beside the FP32 bound as its floor; ``bound``:
    ``compare``'s per-output bounds of a reduced-precision instance;
    ``bf16_flops``: the operations, not in ``flops``, of products with
    bf16 operands on the tensor cores (charged at the bf16 peak);
    ``control``: a reduced instance's f32 instance and f32 twin on its
    rounded inputs and the outputs its mode reaches (``mode_effect``)."""
    return {"name": name, "src": src, "replaces": replaces, "kern": kern,
            "plain": plain, "inputs": inputs, "flops": flops,
            "library": library, "wgrad": wgrad, "exact": exact,
            "tc_flops": tc_flops, "bound": bound, "bf16_flops": bf16_flops,
            "control": control}


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
    del wide, x2, mu2, FW2, c2, a2
    by_name = {row["name"]: row for row in rows}
    for precision in REDUCED:
        for r in reduced_kernel_rows(precision, margs, hargs, bargs, geo,
                                     (g_dq, g_dmu), idx, msg_fwd, msg_bwd,
                                     gfw, ne, B):
            by_name[r.pop("name")][precision] = r
    return rows


def reduced_bounds(pieces, S, dR_share):
    """``compare``'s bounds of a reduced-precision instance against its
    twin at the same pieces: per edge a rounding flip of one ulp of the
    mode (``REDUCED_ULP``) of each term, whose sum S the twin gives on
    |inputs|, beside the f32 tolerance; dR (``dR_share``, None for the
    forward) as a share of max |dR| at one piece, else the f32 tolerance
    (at two pieces no rounding reaches the geometry chain)."""
    out = [REDUCED_ULP[pieces] * t + ATOL + RTOL * t for t in S]
    if dR_share is not None:
        out.insert(2, dR_share if pieces == 1 else None)
    return out


def reduced_kernel_rows(precision, margs, hargs, bargs, geo, cots, idx,
                        msg_fwd, msg_bwd, gfw, ne, B):
    """K1/K2 and K6/K7 in the instances of ``precision`` against their
    twins at the same pieces, at phase 3's inputs (features and
    cotangents bf16 at one piece, so the bytes are the mode's), each with
    its mode effect against the f32 instance and twin; returns the
    sub-rows, named by their rows.  At one piece K2/K7's P3 (grbf, and
    with wgrad gFW: ``gfw`` operations each) runs on bf16 operands on the
    tensor cores, so those operations are charged at the bf16 peak."""
    from schnetpack_tpu_torch.ops import colblock_message as msg
    from schnetpack_tpu_torch.ops.precision import PIECES, round_pieces

    p = PIECES[precision]
    x, mu, R, FW, coff, cw, refs, rc = margs
    xp, mup, gq, gm = (msg.feat(t, p) for t in (x, mu, *cots))
    ma = (xp, mup, R, FW, coff, cw, refs, rc)
    ha = (xp, mup, geo, FW, refs)
    ba = (xp, mup, geo, FW, cw, refs, rc, gq, gm)
    # the f32 instances' and twins' inputs: rounded as the mode rounds them
    xr, mur, gqr, gmr = (round_pieces(t, p) for t in (x, mu, *cots))
    ma3 = (xr, mur, R, FW, coff, cw, refs, rc)
    ha3 = (xr, mur, geo, FW, refs)
    ba3 = (xr, mur, geo, FW, cw, refs, rc, gqr, gmr)
    with torch.no_grad():   # S: the twins on |inputs| (all terms >= 0)
        ab = [t.abs() for t in (x, mu, geo, FW)]
        S_f = msg.msg_fwd_geo_plain(*ab, refs)
        S_b = msg.msg_bwd_geores_plain(*ab, cw, refs, rc,
                                       *(t.abs() for t in cots))
    fwd_b = reduced_bounds(p, S_f, None)
    bwd_b = reduced_bounds(p, S_b[:2], DR_SHARE)
    bwd_bw = bwd_b + reduced_bounds(p, S_b[3:], None)
    tc = gfw if p == 1 else 0   # P3's products on bf16 operands, each
    # the outputs a rounding of the mode reaches: at two pieces the
    # features' (dq, dmu; dx, dmu), not dR or gFW
    reach = 2 if p == 2 else 4
    tag = f" ({precision})"
    cases = [
        case("msg_fwd", "colblock_message.cu", "colblock_pallas.py:1889",
             lambda: msg.msg_fwd_kernel(*ma, pieces=p),
             lambda: msg.msg_fwd_plain(*margs, pieces=p),
             (xp, mup, R, FW, coff, cw, idx), msg_fwd + ne * geo_flops(B),
             bound=fwd_b,
             control=(lambda: msg.msg_fwd_kernel(*ma3),
                      lambda: msg.msg_fwd_plain(*ma3), reach)),
        case("msg_bwd", "colblock_message_bwd.cu", "colblock_pallas.py:1239",
             lambda: msg.msg_bwd_kernel(*ma, gq, gm, pieces=p),
             lambda: msg.msg_bwd_plain(*margs, *cots, pieces=p)[:3],
             (xp, mup, R, FW, coff, cw, idx, gq, gm),
             msg_bwd - tc + 2 * ne * geo_flops(B), bound=bwd_b,
             bf16_flops=tc,
             control=(lambda: msg.msg_bwd_kernel(*ma3, gqr, gmr),
                      lambda: msg.msg_bwd_plain(*ma3, gqr, gmr)[:3], reach),
             wgrad={"kern": lambda: msg.msg_bwd_kernel(
                        *ma, gq, gm, wgrad=True, pieces=p),
                    "plain": lambda: msg.msg_bwd_plain(*margs, *cots,
                                                       pieces=p),
                    "flops": msg_bwd + 2 * ne * geo_flops(B) + gfw - 2 * tc,
                    "bf16_flops": 2 * tc, "bound": bwd_bw,
                    "control": (lambda: msg.msg_bwd_kernel(
                                    *ma3, gqr, gmr, wgrad=True),
                                lambda: msg.msg_bwd_plain(*ma3, gqr,
                                                          gmr), reach)}),
        case("msg_fwd_geo", "colblock_message.cu", "colblock_pallas.py:687",
             lambda: msg.msg_fwd_geo_kernel(*ha, pieces=p),
             lambda: msg.msg_fwd_geo_plain(*hargs, pieces=p),
             (xp, mup, geo, FW, idx), msg_fwd, bound=fwd_b,
             control=(lambda: msg.msg_fwd_geo_kernel(*ha3),
                      lambda: msg.msg_fwd_geo_plain(*ha3), reach)),
        case("msg_bwd_geores", "colblock_message_bwd.cu",
             "colblock_pallas.py:1570",
             lambda: msg.msg_bwd_geores_kernel(*ba, pieces=p),
             lambda: msg.msg_bwd_geores_plain(*bargs, pieces=p)[:3],
             (xp, mup, geo, FW, cw, idx, gq, gm),
             msg_bwd - tc + ne * geo_flops(B), bound=bwd_b, bf16_flops=tc,
             control=(lambda: msg.msg_bwd_geores_kernel(*ba3),
                      lambda: msg.msg_bwd_geores_plain(*ba3)[:3], reach),
             wgrad={"kern": lambda: msg.msg_bwd_geores_kernel(
                        *ba, wgrad=True, pieces=p),
                    "plain": lambda: msg.msg_bwd_geores_plain(*bargs,
                                                              pieces=p),
                    "flops": msg_bwd + ne * geo_flops(B) + gfw - 2 * tc,
                    "bf16_flops": 2 * tc, "bound": bwd_bw,
                    "control": (lambda: msg.msg_bwd_geores_kernel(
                                    *ba3, wgrad=True),
                                lambda: msg.msg_bwd_geores_plain(*ba3),
                                reach)}),
    ]
    for c in cases:
        c["tag"] = tag
    return [dict(sub_row(r), name=r["name"]) for r in check_kernels(cases)]


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


def slab_simulator(pos, cell, dev, pot=None, params=None, **kw):
    """The port's ``SpatialColumnSimulator`` of the bench box on one card
    (the trained PaiNN-128x3 unless ``pot`` is given; ``kw``: ``kT``,
    ``gamma``, ``seed`` of the Langevin form)."""
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
        dt=SLAB_DT, **kw)


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


def slab_md_phase(pos, cell, steps, seed, dev, launches, model=None,
                  per_step=None, drift_tol=DRIFT_TOL, tag=""):
    """NVE on the slab path through ``SpatialColumnSimulator``; returns
    (launch counts, ms/step).  The counts are set to 0 before each chunk
    and read after it; the total energy is evaluated at the chunk
    boundaries, outside them.  The ms/step is the chunks' CUDA-event time
    over the steps, without the host re-bins (printed apart).  ``model``,
    ``per_step``: as ``md_phase``'s."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.parallel import make_sharded_column_eval

    sim = slab_simulator(pos, cell, dev, *(model or ()))
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
    print(f"md (painn_slab{tag}): {n_chunks * SLAB_CHUNK} steps, {A} atoms, "
          f"dims={lay.dims[:3]} Ktot={lay.qcol.shape[2]}, ms/step (CUDA "
          f"events, chunks only) {ms_step:.3f}, {A / (ms_step * 1e-3):.4g} "
          f"atom-steps/s, host re-bins {sim.rebuilds} in "
          f"{sim.host_seconds:.3f} s wall, T_end={T:.2f} K, max |E_tot - "
          f"E_tot(0)| at the chunk boundaries = {drift:.3e} eV/atom",
          flush=True)
    assert np.isfinite(sim.R).all(), "non-finite positions"
    assert 0.0 < T < 300.0, f"temperature {T} K"
    assert drift <= drift_tol, f"painn_slab{tag}: energy drift {drift}"
    evals = n_chunks * (SLAB_CHUNK + 1)
    for k, v in counts.items():
        want = (per_step or PER_STEP["painn_slab"]).get(k, 0) * evals
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


def md_phase(path, pos, cell, steps, seed, dev, launches, precision=None,
             keep=None, model=None, per_step=None, drift_tol=DRIFT_TOL,
             tag=""):
    """NVE run on one path of ``PATHS`` (PaiNN's in the feature mode
    ``precision``, phase 13); returns (launch counts, ms/step), and puts
    the simulator in ``keep`` where that is a dict.  The ms/step is the
    CUDA-event time of the run over the steps, host rebuilds included; for
    painn_cell, whose rebuilds all run on the host, it is also printed
    with their wall time subtracted.  ``model`` (pot, params) replaces the
    path's trained model, ``per_step`` its launches a step (phase 17's
    widths)."""
    from schnetpack_tpu_torch.md import (
        MaxwellBoltzmannInit, Simulator, VelocityVerlet, load_molecules,
    )
    from schnetpack_tpu_torch.units import md_units

    pot, params = model or potential(path)
    calc = calculator(pot, params, layout=layout_of(path),
                      precision=precision)
    nbl = calc.nbl
    system = load_molecules([molecule(pos, cell)], device=dev)
    system = MaxwellBoltzmannInit(30.0).initialize_system(
        system, torch.Generator().manual_seed(seed + 1))
    sim = Simulator(system, VelocityVerlet(0.5), calc)
    if keep is not None:
        keep["sim"] = sim
    if precision is not None:
        path = f"{path}, {precision}"
    name = path + tag
    sim.simulate(100, chunk_size=100)            # warm-up (equilibration)
    nbl.retighten(sim.system, jitter_fraction=0.05,
                  bucket_headroom=1.0 / 24.0)
    sim.calc_state = nbl.state()
    print(f"md ({name}) after retighten: {layout_str(sim.calc_state)}",
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
    print(f"md ({name}): {steps} steps, {A} atoms, ms/step (CUDA events) "
          f"{ms_step:.3f}, wall {1e3 * wall / steps:.3f} ms/step, "
          f"{A / (ms_step * 1e-3):.4g} atom-steps/s, T_end={T:.2f} K, "
          f"max |E_tot - E_tot(0)| = {drift:.3e} eV/atom, rebuilds: "
          f"{device} on the device, {host} on the host ({host_s:.3f} s "
          f"wall), {overflows} overflows; ms/step without the host builds "
          f"{ms_step - 1e3 * host_s / steps:.3f}", flush=True)
    assert np.isfinite(R).all(), "non-finite positions"
    assert 0.0 < T < 300.0, f"temperature {T} K"
    assert drift <= drift_tol, f"{name}: energy drift {drift} eV/atom"
    check_launches(name, counts, mode_counts(
        per_step or PER_STEP[path.split(",")[0]], precision), steps)
    if layout_of(path) == "atom":
        assert device == 0, f"{device} device rebuilds on the atom layout"
    else:
        assert host == overflows, (
            f"{host} host rebuilds after the retighten, {overflows} "
            "overflows")
    return counts, ms_step


def mode_counts(per_step, precision):
    """``per_step`` with the message kernels' counters of the feature mode
    ``precision`` (None, "f32", "mixed" or "bf16")."""
    suffix = {"mixed": "_mixed", "bf16": "_bf16"}.get(precision, "")

    def name(k):
        if k in MODE_KERNELS:
            return k + suffix
        if k.endswith("_gen") and k[:-4] in MODE_KERNELS:  # a general one
            return k + suffix
        return k
    return {name(k): v for k, v in per_step.items()}


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


def energy_drift(sim, calc, dt_fs=0.5):
    """(max |E_tot(t) - E_tot(0)|, the least-squares slope of E_tot(t)
    in eV per atom per ps) over the logged steps."""
    E = np.concatenate([lg["energy"] + lg["kinetic_energy"]
                        for lg in sim.logs]).sum(axis=(1, 2))
    E = E / calc.energy_conversion / sim.system.total_atoms
    t = np.arange(len(E)) * dt_fs * 1e-3
    return float(np.abs(E - E[0]).max()), float(np.polyfit(t, E, 1)[0])


def precision_forces_phase(dev, launches, smi):
    """Phase 13 (a): PaiNN-128x3 in both message forms at each reduced
    mode on the fixture's box against the JAX f32 fixture, its launches
    per evaluation; returns the launch counts."""
    from schnetpack_tpu_torch.md import load_molecules

    ref = np.load(REFERENCE["full"])
    F_ref = ref["forces"]
    scale, rms_ref = np.abs(F_ref).max(), np.sqrt(np.mean(F_ref ** 2))
    total, forces = {}, {}
    for precision in REDUCED:
        for fuse in ("full", "hybrid"):
            calc = calculator(*potential(fuse), precision=precision)
            system = load_molecules([molecule(ref["R"].astype(np.float64),
                                              ref["cell"])], device=dev)
            state = calc.init_state(system)
            reset(launches)
            system = calc.calculate(system, state)
            counts = read_counts(launches)
            check_launches(f"precision ({fuse}, {precision})", counts,
                           mode_counts(PER_STEP[fuse], precision), 1)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            F = (system.forces[0] / calc.force_conversion).cpu().numpy()
            d = F - F_ref
            err = float(np.abs(d).max() / scale)
            rms = float(np.sqrt(np.mean(d ** 2)) / rms_ref)
            print(f"precision ({fuse}, {precision}): forces vs the JAX f32 "
                  f"fixture: max |dF| / max |F| {err:.3e} (gate "
                  f"{PRECISION_FORCE_TOL[precision]:g}), rms |dF| / rms |F| "
                  f"{100 * rms:.4f} % (the JAX package's TPU study of its "
                  f"bf16 mode: {100 * JAX_STUDY_RMS:.2f} %)", flush=True)
            assert np.isfinite(F).all() and F.shape == F_ref.shape
            assert err < PRECISION_FORCE_TOL[precision], (
                f"{fuse} {precision}: max |dF| / max |F| {err}")
            forces[fuse] = F
        d = forces["full"] - forces["hybrid"]
        print(f"precision ({precision}): full vs hybrid forces rms "
              f"{np.sqrt(np.mean(d ** 2)):.3e}, max {np.abs(d).max():.3e} "
              "eV/Ang", flush=True)
    return total


def precision_md_phase(pos, cell, seed, dev, launches, smi):
    """Phase 13 (b)-(d): 300 NVE steps of ``full`` at bf16 (phase 6's
    gates), then f32 and bf16 NVE from that run's last state side by side,
    then the ms/step of ``full`` and ``hybrid`` in each mode, alternated;
    returns the launch counts."""
    from schnetpack_tpu_torch.md import (
        MaxwellBoltzmannInit, Simulator, VelocityVerlet, load_molecules,
    )

    keep = {}
    total, _ = md_phase("full", pos, cell, PRECISION_NVE_STEPS, seed, dev,
                        launches, precision="bf16", keep=keep)
    start = keep["sim"].system
    line = []
    for precision in (None, "bf16"):
        calc = calculator(*potential("full"), precision=precision)
        system = start.replace(positions=start.positions.clone(),
                               momenta=start.momenta.clone())
        sim = Simulator(system, VelocityVerlet(0.5), calc)
        reset(launches)
        sim.simulate(PRECISION_DRIFT_STEPS, chunk_size=100)
        check_launches(f"precision drift ({precision})", read_counts(
            launches), mode_counts(PER_STEP["full"], precision),
            PRECISION_DRIFT_STEPS + 1)
        for k, v in read_counts(launches).items():
            total[k] = total.get(k, 0) + v
        worst, slope = energy_drift(sim, calc)
        assert np.isfinite(sim.system.positions.cpu().numpy()).all()
        line.append(f"{precision or 'f32'}: max |E_tot - E_tot(0)| "
                    f"{worst:.3e} eV/atom, slope {slope:+.3e} eV/atom/ps")
    print(f"precision (full): {PRECISION_DRIFT_STEPS} NVE steps from one "
          f"state, {'; '.join(line)}; {smi}", flush=True)

    # ms/step per path and mode, alternated, the median over rounds
    runs = {}
    for fuse in ("full", "hybrid"):
        for precision in ("f32",) + REDUCED:
            calc = calculator(*potential(fuse), precision=precision)
            system = load_molecules([molecule(pos, cell)], device=dev)
            system = MaxwellBoltzmannInit(T_BATH).initialize_system(
                system, torch.Generator().manual_seed(seed + 5))
            sim = Simulator(system, VelocityVerlet(0.5), calc)
            sim.simulate(20, chunk_size=20)          # warm-up
            runs[(fuse, precision)] = (sim, [], [])
    for r in range(PRECISION_ROUNDS):
        for key in list(runs)[::1 if r % 2 == 0 else -1]:
            sim, ms, peak = runs[key]
            reset(launches)
            m, gib = timed_run(sim, PRECISION_CHUNK)
            counts = read_counts(launches)
            check_launches(f"precision timing {key}", counts, mode_counts(
                PER_STEP[key[0]], key[1]), PRECISION_CHUNK)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            ms.append(m)
            peak.append(gib)
    print(f"precision: ms/step (CUDA events, median of {PRECISION_ROUNDS} "
          f"alternated chunks of {PRECISION_CHUNK} steps; peak device "
          "memory): " + "; ".join(
              f"{fuse} {precision} {float(np.median(ms)):.3f} "
              f"({', '.join(f'{x:.3f}' for x in ms)}; {max(peak):.2f} GiB)"
              for (fuse, precision), (_, ms, peak) in runs.items())
          + f"; {smi}", flush=True)
    return total


def precision_spkmd_phase(pos, cell, seed, dev, launches, smi):
    """Phase 13 (e): ``spkmd`` at ``calculator.precision=bf16`` from a
    PaiNN run directory (phase 9's): its calculator's forces on the
    fixture's box at (a)'s gate, one chunk of NVE, of 8-bead RPMD and of
    the two-member ensemble; returns the launch counts."""
    import shutil
    import tempfile

    from schnetpack_tpu_torch.config.compose import Composer
    from schnetpack_tpu_torch.md import cli, load_molecules

    tmp = tempfile.mkdtemp(prefix="spkmd_bf16_")
    total = {}
    try:
        box = write_xyz(os.path.join(tmp, "box.xyz"), pos, cell)
        run = write_run_dir(os.path.join(tmp, "run"), ASSET["painn"])
        run2 = write_run_dir(os.path.join(tmp, "run2"), tree=perturbed_tree(
            ASSET["painn"], seed + 7, ENSEMBLE_SCALE))
        common = [f"device={dev}", "calculator.neighbor_list=cellblock",
                  "calculator.precision=bf16",
                  f"calculator.cutoff_shell={SKIN}", f"seed={seed}"]
        ref = np.load(REFERENCE["full"])
        cfg = Composer([cli._MD_CONFIG_DIR]).compose("config", [
            f"calculator.model_dir={run}"] + common)
        calc = cli.build_calculator(cfg["calculator"], dev)
        assert calc.model.representation.pieces == 1
        system = load_molecules([molecule(ref["R"].astype(np.float64),
                                          ref["cell"])], device=dev)
        system = calc.calculate(system, calc.init_state(system))
        F = (system.forces[0] / calc.force_conversion).cpu().numpy()
        err = float(np.abs(F - ref["forces"]).max()
                    / np.abs(ref["forces"]).max())
        print(f"precision (spkmd): build_calculator at bf16 on the run "
              f"directory vs the JAX f32 fixture: max |dF| / max |F| "
              f"{err:.3e}", flush=True)
        assert err < PRECISION_FORCE_TOL["bf16"], f"spkmd bf16 forces {err}"
        nve = [f"system.molecule_file={box}", "dynamics=nve",
               f"system.initializer.temperature={T_BATH}",
               f"dynamics.n_steps={PRECISION_SPKMD_STEPS}",
               f"dynamics.chunk_size={PRECISION_SPKMD_STEPS}"] + common
        for name, extra, per_step in (
                ("spkmd_painn, bf16", [f"calculator.model_dir={run}"],
                 PER_STEP["full"]),
                ("spkmd_rpmd, bf16", [
                    f"calculator.model_dir={run}", "dynamics=rpmd",
                    f"dynamics.integrator.n_beads={N_BEADS}",
                    "dynamics.integrator.time_step=0.5",
                    f"dynamics.integrator.temperature={T_BATH}"],
                 PER_STEP["rpmd"]),
                ("spkmd_ensemble, bf16", [
                    "calculator=ensemble",
                    f"calculator.model_dirs=[{run},{run2}]"],
                 {k: 2 * v for k, v in PER_STEP["full"].items()})):
            sim, counts, _ = spkmd_run(name, nve + extra + [
                f"simulation_dir={tmp}/{name.split(',')[0]}"], launches, smi)
            check_launches(name, counts, mode_counts(per_step, "bf16"),
                           PRECISION_SPKMD_STEPS + 1)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            assert np.isfinite(sim.system.positions.cpu().numpy()).all()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total


def precision_refusal_phase(dev, launches):
    """Phase 13 (f): the 27-cell layout and SO3net on the column layout
    refuse bf16 before any launch."""
    from schnetpack_tpu_torch.ops.precision import ReducedPrecisionPathError

    reset(launches)
    for path, layout in (("painn_cell", "atom"), ("schnet", "atom"),
                         ("so3net", "column")):
        try:
            calculator(*potential(path), layout=layout, precision="bf16")
        except ReducedPrecisionPathError as e:
            print(f"precision: {path} on the {layout} layout at bf16 "
                  f"refused: {str(e)[:60]}...", flush=True)
        else:
            raise AssertionError(f"{path} ({layout}) took bf16")
    launched = {k: v for k, v in read_counts(launches).items() if v}
    assert not launched, f"launches before a refusal: {launched}"


def precision_phase(pos, cell, seed, dev, launches, smi):
    """Phase 13: the reduced-precision feature mode; returns the launch
    counts."""
    total = {}
    for part in (precision_forces_phase(dev, launches, smi),
                 precision_md_phase(pos, cell, seed, dev, launches, smi),
                 precision_spkmd_phase(pos, cell, seed, dev, launches, smi)):
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    precision_refusal_phase(dev, launches)
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
    stress at step 0 equals a one-off ``calculate``'s (both under
    deterministic algorithms); from the same state,
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
            # both stresses under deterministic algorithms: the card's
            # float atomics alone moved their difference over 3e-7 - 1.03e-6
            # from run to run
            with deterministic():
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


def iface_box(seed):
    """The C++ client's box: 8^3 FCC cells jittered by a seeded
    +-``IFACE_JITTER`` (a sample dict)."""
    R, cell = fcc_box(4 * IFACE_CELLS ** 3)
    rng = np.random.RandomState(seed + 14)
    return molecule(R + rng.uniform(-IFACE_JITTER, IFACE_JITTER, R.shape),
                    cell)


def edge_list(atoms):
    """(idx_i, idx_j, offsets) of a periodic box within the cutoff: the
    host cell list, the pair style's convention."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.transform.neighborlist import (
        cell_list_neighbor_list,
    )

    i, j, S = cell_list_neighbor_list(atoms[P.R], CUTOFF, atoms[P.cell],
                                      np.ones(3, bool))
    return i, j, S @ atoms[P.cell]


def force_rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


def iface_calculator_phase(run, atoms, ref, dev, smi):
    """Phase 14 (a): ``SpkCalculator`` with the run directory's model on
    the card on the fixture's box: phase 4's gates, the cache, and the
    host neighbor list's and the evaluation's ms apart.  Returns the
    calculator and its forces."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.interfaces import SpkCalculator
    from schnetpack_tpu_torch.utils import load_model

    model, _ = load_model(run, device=dev)
    calc = SpkCalculator(model, cutoff=CUTOFF, device=dev)
    res = calc.calculate(atoms)
    F, E = res["forces"], res["energy"]
    rms = force_rms(F, ref["forces"])
    dE = abs(E - float(ref["energy"])) / abs(float(ref["energy"]))
    assert calc.calculate(dict(atoms)) is res and calc.n_evaluations == 1
    calc.calculate(dict(atoms, **{P.R: atoms[P.R] + 1e-3}))
    assert calc.n_evaluations == 2, "moved positions: one evaluation"
    t = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch = calc.converter(atoms)
        torch.cuda.synchronize()
        t.append(1e3 * (time.perf_counter() - t0))
    eval_ms = cuda_ms(lambda: calc._apply(calc.model, batch), reps=3)
    print(f"interfaces (SpkCalculator, {len(F)} atoms): force rms err "
          f"{rms:.3e} eV/Ang vs port_ref_painn_argon.npz (max "
          f"{np.abs(F - ref['forces']).max():.3e}), energy rel err "
          f"{dE:.2e}; a repeat evaluated nothing, moved positions once; "
          f"host neighbor list + collate {np.median(t):.1f} ms, evaluation "
          f"(energy, forces, the host copy) {eval_ms:.2f} ms; {smi}",
          flush=True)
    assert np.isfinite(F).all() and F.shape == ref["forces"].shape
    assert rms <= FORCE_RMS_TOL, f"SpkCalculator: force rms {rms}"
    assert dE <= ENERGY_RTOL, f"SpkCalculator: energy {dE}"
    return calc, F


def test_client_binary(tmp):
    """The port's ``test_client.cpp`` + ``spk_client.cpp`` built with
    g++."""
    src = os.path.join(ROOT, "schnetpack_tpu_torch", "interfaces", "lammps")
    exe = os.path.join(tmp, "test_client")
    subprocess.run(["g++", "-O2", "-std=c++17",
                    os.path.join(src, "test_client.cpp"),
                    os.path.join(src, "spk_client.cpp"), "-I", src, "-o",
                    exe], check=True, capture_output=True, timeout=300)
    return exe


def cpp_client(exe, sock, atoms):
    """(energy, the per-atom energies' sum, forces) of the C++ client's
    request for ``atoms`` (one LAMMPS type, argon)."""
    from schnetpack_tpu_torch import properties as P

    R, cell = atoms[P.R], atoms[P.cell]
    stdin = [f"{len(R)} 1 {CUTOFF}",
             " ".join(f"{v:.17g}" for v in cell.ravel()), "18"]
    stdin += [f"1 {r[0]:.17g} {r[1]:.17g} {r[2]:.17g}" for r in R]
    proc = subprocess.run([exe, sock], input="\n".join(stdin), text=True,
                          capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    vals = {ln.split()[0]: ln.split()[1] for ln in lines}
    F = np.array([[float(x) for x in ln.split()[2:5]] for ln in lines
                  if ln.startswith("force")])
    return float(vals["energy"]), float(vals["energy_atom_sum"]), F


def serve_in_thread(server):
    import threading

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    for _ in range(600):
        if os.path.exists(server.socket_path):
            return thread
        time.sleep(0.05)
    raise RuntimeError("the model server did not start")


def two_rank_reply(sock, atoms, ii, jj, off):
    """Forces and virial shares of a two-rank partial request (domains
    split at half the box in x), summed over the ranks."""
    import threading

    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.interfaces.lammps.server import ModelClient

    Z, R, cell = atoms[P.Z], atoms[P.R], atoms[P.cell]
    owner = (R[:, 0] >= cell[0, 0] / 2).astype(int)
    parts = {}

    def rank(r):
        local = np.nonzero(owner == r)[0]
        mine = np.isin(ii, local)
        client = ModelClient(sock)
        parts[r] = (local, client.evaluate_partial(
            r, 2, len(R), local, Z[local], R[local], cell, ii[mine],
            jj[mine], R[jj[mine]] + off[mine]))
        client.close()
    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert set(parts) == {0, 1}, "a rank got no reply"
    F = np.zeros((len(R), 3))
    for local, (_, _, f, _) in parts.values():
        F[local] = f
    return (F, sum(p[1][3] for p in parts.values()),
            sum(p[1][0] for p in parts.values()))


def stress_model(dev):
    """The PaiNN asset with ``Forces(calc_stress=True)`` (the flat
    ``Strain`` stress)."""
    import copy

    from schnetpack_tpu_torch.cli import model_from_config
    from schnetpack_tpu_torch.convert import load_jax_params

    cfg = copy.deepcopy(PAINN_RUN_CONFIG)
    cfg["output_modules"][1]["calc_stress"] = True
    model, _ = model_from_config(cfg, load_jax_params(ASSET["painn"]), dev)
    return model.requires_grad_(False)


def iface_server_phase(run, tmp, big, ref, calc, seed, dev, smi):
    """Phase 14 (b): ``LammpsModelServer`` on the card serving the deployed
    artifact (per-atom energies): the port's C++ test client on the
    2,048-atom box, the Python client on the fixture's box (forces, the
    virial against -V x the flat ``Strain`` stress), a two-rank partial
    request, and the request round trip beside the in-process
    evaluation."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.deploy import deploy
    from schnetpack_tpu_torch.interfaces.lammps import LammpsModelServer
    from schnetpack_tpu_torch.interfaces.lammps.server import ModelClient
    from schnetpack_tpu_torch.utils import load_model

    art = os.path.join(tmp, "model.spk")
    deploy(run, art, device=dev)
    model, _ = load_model(art, device=dev)
    exe = test_client_binary(tmp)
    small = iface_box(seed)
    want = calc.calculate(small)
    with torch.no_grad():
        e_atom_want = model.energy_outputs(calc.converter(small))[
            "energy_per_atom"][:len(small[P.Z])].double().cpu().numpy()
    server = LammpsModelServer(model, cutoff=CUTOFF,
                               socket_path=os.path.join(tmp, "s.sock"),
                               per_atom_energy_key="energy_per_atom",
                               device=dev)
    sock = server.socket_path
    thread = serve_in_thread(server)
    try:
        t0 = time.perf_counter()
        E, e_sum, F = cpp_client(exe, sock, small)
        cpp_s = time.perf_counter() - t0
        client = ModelClient(sock)
        ii, jj, off = edge_list(small)
        _, e_atom, F_py, _ = client.evaluate(small[P.Z], small[P.R],
                                             small[P.cell], ii, jj, off)
        rms_cpp = force_rms(F, want["forces"])
        de_atom = float(np.abs(e_atom - e_atom_want).max())
        print(f"interfaces (server, C++ test client, {len(F)} atoms): force "
              f"rms vs SpkCalculator {rms_cpp:.3e} eV/Ang, energy "
              f"{E:.6f} vs {want['energy']:.6f} eV, per-atom energies' sum "
              f"{e_sum:.6f}, per-atom energies vs the model's "
              f"{de_atom:.2e} eV (Python client), the client's wall "
              f"{cpp_s:.2f} s (its O(n^2 27) edge search included)",
              flush=True)
        assert rms_cpp <= IFACE_RMS_TOL, f"C++ client: force rms {rms_cpp}"
        assert abs(E - want["energy"]) <= ENERGY_RTOL * abs(want["energy"])
        assert abs(e_sum - E) <= ENERGY_RTOL * abs(E)
        assert de_atom <= IFACE_E_ATOM_ATOL, f"per-atom energies {de_atom}"
        assert force_rms(F_py, F) <= IFACE_RMS_TOL

        Z, R, cell = big[P.Z], big[P.R], big[P.cell]
        ii, jj, off = edge_list(big)
        E, e_atom, F, W = client.evaluate(Z, R, cell, ii, jj, off)
        rms = force_rms(F, ref["forces"])
        dE = abs(E - float(ref["energy"])) / abs(float(ref["energy"]))
        inputs = flat_inputs(R, cell, dev)
        inputs[P.cell] = torch.as_tensor(cell[None], dtype=torch.float32,
                                         device=dev)
        sigma = stress_model(dev)(inputs)[P.stress][0].double().cpu().numpy()
        W_ref = -abs(np.linalg.det(cell)) * sigma
        scale = float(np.abs(R[:, :, None] * F[:, None, :]).sum(0).max())
        dW = float(np.abs(W - W_ref).max()) / scale
        F2, W2, E2 = two_rank_reply(sock, big, ii, jj, off)
        dF2 = float(np.abs(F2 - F).max())
        trips = []
        for _ in range(ROUND_TRIPS):
            t0 = time.perf_counter()
            client.evaluate(Z, R, cell, ii, jj, off)
            trips.append(1e3 * (time.perf_counter() - t0))
        inproc = []
        for _ in range(ROUND_TRIPS):
            t0 = time.perf_counter()
            server.evaluate(Z, R, cell, ii, jj, off)
            inproc.append(1e3 * (time.perf_counter() - t0))
        client.close()
        print(f"interfaces (server, Python client, {len(R)} atoms, {len(ii)} "
              f"edges): force rms err {rms:.3e} eV/Ang vs "
              f"port_ref_painn_argon.npz, energy rel err {dE:.2e}; virial vs "
              f"-V x the flat Strain stress {dW:.2e} of its scale "
              f"{scale:.4e} eV; two ranks vs one domain: max |dF| "
              f"{dF2:.2e} eV/Ang, energy shares {E2 - E:+.2e} eV, virial "
              f"shares {float(np.abs(W2 - W).max()):.2e} eV; request round "
              f"trip median {np.median(trips):.2f} ms (min {min(trips):.2f}"
              f") over {ROUND_TRIPS}, in-process evaluate median "
              f"{np.median(inproc):.2f} ms; {smi}", flush=True)
        assert rms <= FORCE_RMS_TOL, f"server: force rms {rms}"
        assert dE <= ENERGY_RTOL, f"server: energy {dE}"
        assert dW <= VIRIAL_SCALE_TOL, f"server: virial {dW}"
        assert dF2 <= PARTIAL_ATOL, f"two ranks: {dF2}"
    finally:
        ModelClient(sock).shutdown()
        thread.join(timeout=120)
    assert not thread.is_alive() and not os.path.exists(sock)
    return small


def iface_deploy_phase(run, tmp, big, dev, smi):
    """Phase 14 (c): ``deploy`` with ``export_program=True`` on the card,
    ``load_deployed`` onto the card: the weights and (deterministic
    ``index_add_``) the forces equal the run directory's bit for bit; the
    exported program's forces at the example batch against eager."""
    import warnings

    from schnetpack_tpu_torch import deploy as dep
    from schnetpack_tpu_torch.interfaces import SpkCalculator
    from schnetpack_tpu_torch.utils import load_model

    art = os.path.join(tmp, "program.spk")
    t0 = time.perf_counter()
    dep.deploy(run, art, export_program=True, device=dev)
    export_s = time.perf_counter() - t0
    model, params, artifact = dep.load_deployed(art, device=dev)
    run_model, run_params = load_model(run, device=dev)
    assert params.keys() == run_params.keys()
    for k in params:
        assert torch.equal(params[k], run_params[k]), k
    calcs = [SpkCalculator(m, cutoff=artifact["cutoff"], device=dev)
             for m in (model, run_model)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            F_dep, F_run = (c.calculate(big)["forces"] for c in calcs)
        finally:
            torch.use_deterministic_algorithms(False)
    batch = dep._example_batch(artifact["cutoff"], dev)
    E, F = dep.load_program(artifact)(batch)
    E0, F0 = dep.energy_and_forces(model.requires_grad_(False))(batch)
    scale = float(F0.abs().max())
    dF = float((F - F0).abs().max())
    print(f"interfaces (deploy): the artifact's weights equal the run "
          f"directory's; forces bit for bit: {np.array_equal(F_dep, F_run)} "
          f"(max |dF| {np.abs(F_dep - F_run).max():.1e}); export_program on "
          f"the card {export_s:.1f} s, {len(artifact['torch_program'])} "
          f"bytes; the program's forces at the example batch vs eager "
          f"{dF:.2e} eV/Ang ({dF / scale:.2e} of max |F| {scale:.3e}); "
          f"{smi}", flush=True)
    assert np.array_equal(F_dep, F_run), "deployed forces differ"
    assert scale > 0 and dF <= PROGRAM_SCALE_TOL * scale, "the program"
    assert float((E - E0).abs().max()) <= ENERGY_RTOL * float(E0.abs().max())


def reference_painn(path, seed, F=128, n_int=3, n_rbf=20, max_z=100):
    """A reference-format (upstream SchNetPack) PaiNN potential with seeded
    random weights, pickled by ``torch.save`` as ``schnetpack.*`` classes
    (modules that exist only while saving), as the import reads it."""
    import types

    from torch import nn

    names = {"NeuralNetworkPotential": "schnetpack.model",
             "PaiNN": "schnetpack.representation"}
    classes = {n: type(n, (nn.Module,), {"__module__": m})
               for n, m in names.items()}
    g = torch.Generator().manual_seed(seed)

    def lin(n_out, n_in, bias=True):
        m = nn.Module()
        m.register_parameter("weight", nn.Parameter(torch.randn(
            n_out, n_in, generator=g) / n_in ** 0.5))
        if bias:
            m.register_parameter("bias", nn.Parameter(
                0.1 * torch.randn(n_out, generator=g)))
        return m

    def seq(*mods):
        s = nn.Module()
        for k, m in enumerate(mods):
            s.add_module(str(k), m)
        return s
    rep = classes["PaiNN"]()
    rep.embedding = nn.Embedding(max_z + 1, F)
    rep.cutoff_fn = nn.Module()
    rep.cutoff_fn.register_buffer("cutoff", torch.tensor([CUTOFF]))
    rep.radial_basis = nn.Module()
    rep.radial_basis.register_buffer("offsets",
                                     torch.linspace(0, CUTOFF, n_rbf))
    rep.filter_net = lin(n_int * 3 * F, n_rbf)
    rep.interactions = seq(*[nn.Module() for _ in range(n_int)])
    rep.mixing = seq(*[nn.Module() for _ in range(n_int)])
    for t in range(n_int):
        rep.interactions._modules[str(t)].interatomic_context_net = seq(
            lin(F, F), lin(3 * F, F))
        mix = rep.mixing._modules[str(t)]
        mix.mu_channel_mix = lin(2 * F, F, bias=False)
        mix.intraatomic_context_net = seq(lin(F, 2 * F), lin(3 * F, F))
    root = classes["NeuralNetworkPotential"]()
    root.representation = rep
    head = nn.Module()
    head.outnet = seq(lin(F // 2, F), lin(1, F // 2))
    root.output_modules = seq(head)
    fakes = {"schnetpack": types.ModuleType("schnetpack")}
    for n, m in names.items():
        fakes.setdefault(m, types.ModuleType(m))
        setattr(fakes[m], n, classes[n])
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k == "schnetpack" or k.startswith("schnetpack.")}
    sys.modules.update(fakes)
    try:
        torch.save(root, path)
    finally:
        for k in fakes:
            sys.modules.pop(k, None)
        sys.modules.update(saved)
    return path


def iface_import_phase(tmp, atoms, seed, dev, smi):
    """Phase 14 (d): a synthetic reference-format PaiNN-128x3 imported onto
    the card and onto the CPU: forces on the 2,048-atom box."""
    from schnetpack_tpu_torch.interfaces import SpkCalculator
    from schnetpack_tpu_torch.interfaces.torch_import import (
        import_torch_model,
    )

    path = reference_painn(os.path.join(tmp, "reference_painn.model"), seed)
    t0 = time.perf_counter()
    card, _, info = import_torch_model(path, device=dev)
    import_s = time.perf_counter() - t0
    host, _, _ = import_torch_model(path, device="cpu")
    F = SpkCalculator(card, cutoff=info["cutoff"],
                      device=dev).calculate(atoms)["forces"]
    F_cpu = SpkCalculator(host, cutoff=info["cutoff"],
                          device="cpu").calculate(atoms)["forces"]
    scale = float(np.abs(F_cpu).max())
    dF = float(np.abs(F - F_cpu).max())
    print(f"interfaces (import): {info['representation']}-"
          f"{info['n_atom_basis']}x{info['n_interactions']} (random "
          f"weights) imported in {import_s:.2f} s; card vs CPU forces on "
          f"{len(F)} atoms: max |dF| {dF:.2e} eV/Ang ({dF / scale:.2e} of "
          f"max |F| {scale:.3e}); {smi}", flush=True)
    assert scale > 0 and dF <= IMPORT_SCALE_TOL * scale, "import: card"


def iface_relax_phase(run, seed, dev, smi):
    """Phase 14 (e): ``BatchwiseCalculator`` + ``batchwise_lbfgs`` on phase
    10's 64 clusters (jittered by +-0.1 A): every fmax under 0.05 eV/Ang
    within 200 iterations, no energy above its start."""
    from schnetpack_tpu_torch.interfaces import (
        AtomsConverter, BatchwiseCalculator, batchwise_lbfgs,
    )
    from schnetpack_tpu_torch.utils import load_model

    mols = clusters(seed)
    model, _ = load_model(run, device=dev)
    bc = BatchwiseCalculator(model, None,
                             AtomsConverter(cutoff=CUTOFF, device=dev))
    e0, f0 = bc.calculate(mols)
    calls = [0]
    calculate = bc.calculate

    def counted(structures):
        calls[0] += 1
        return calculate(structures)
    bc.calculate = counted
    t0 = time.perf_counter()
    _, info = batchwise_lbfgs(bc, mols, fmax=RELAX_FMAX,
                              maxstep_total=RELAX_STEPS)
    wall = time.perf_counter() - t0
    rise = float(np.max((info["energies"] - e0) / np.abs(e0)))
    print(f"interfaces (relaxation): {len(mols)} clusters of "
          f"{CLUSTER_ATOMS} atoms, fmax {float(np.abs(np.concatenate(f0)).max()):.3f}"
          f" -> max {float(info['fmax'].max()):.4f} eV/Ang, converged "
          f"{int(info['converged'].sum())}/{len(mols)}, iterations max "
          f"{int(info['iterations'].max())}, {calls[0]} evaluations, "
          f"{1e3 * wall / calls[0]:.2f} ms per iteration; energy change "
          f"min {float(np.min(info['energies'] - e0)):.4f} eV, largest "
          f"rise {rise:.1e} of |E0|; {smi}", flush=True)
    assert info["converged"].all() and (info["fmax"] < RELAX_FMAX).all()
    assert rise <= RELAX_E_RTOL, f"an energy ended above its start: {rise}"


def iface_orca_phase(tmp, dev, smi):
    """Phase 14 (f): ``spkmd calculator=orca`` with a stub ``orca`` in the
    run's directory on 8 argon atoms, 20 NVE steps: energy drift, and the
    last step's forces against -dE/dR of the stub's potential at the last
    ``.inp``'s positions."""
    from schnetpack_tpu_torch import units
    from schnetpack_tpu_torch.md import cli as md_cli
    from schnetpack_tpu_torch.units import _parse_unit, md_units

    os.makedirs(os.path.join(tmp, "bin"))
    stub = os.path.join(tmp, "bin", "orca")
    with open(stub, "w") as f:
        f.write(ORCA_STUB.format(python=sys.executable, eps=LJ_EPS,
                                 sigma=LJ_SIGMA, hartree=units.Hartree,
                                 bohr=units.Bohr))
    os.chmod(stub, 0o755)
    rng = np.random.RandomState(0)
    pos = np.array([[i, j, k] for i in range(2) for j in range(2)
                    for k in range(2)]) * 3.9 + rng.rand(8, 3) * 0.05
    xyz = write_xyz(os.path.join(tmp, "argon8.xyz"), pos, None)
    work = os.path.join(tmp, "orca")
    sim = md_cli.main([
        f"system.molecule_file={xyz}", "calculator=orca",
        f"calculator.orca_path={stub}", f"calculator.working_dir={work}",
        "dynamics=nve", f"dynamics.n_steps={ORCA_STEPS}",
        "system.initializer.temperature=50.0", f"device={dev}",
        f"simulation_dir={os.path.join(tmp, 'orca_sim')}"])
    e_conv = _parse_unit("eV") * md_units().energy
    logs = {k: np.concatenate([lg[k] for lg in sim.logs])
            for k in ("energy", "kinetic_energy")}
    total = (logs["energy"] + logs["kinetic_energy"])[:, 0, 0] / e_conv
    drift = float(np.abs(total - total[0]).max()) / 8
    with open(os.path.join(work, "mol_0_0.inp")) as f:
        R = np.array([[float(x) for x in row.split()[1:]]
                      for row in f.read().splitlines()[2:-1]])
    d = R[:, None] - R[None]
    r = np.linalg.norm(d, axis=-1)
    np.fill_diagonal(r, np.inf)
    sr6 = (LJ_SIGMA / r) ** 6
    want = -np.sum((4 * LJ_EPS * (6 * sr6 - 12 * sr6 ** 2) / r ** 2)[
        ..., None] * d, axis=1)
    to_ev_ang = e_conv / (_parse_unit("Ang") * md_units().length)
    got = sim.system.forces[0].double().cpu().numpy() / to_ev_ang
    dF = float(np.abs(got - want).max()) / float(np.abs(want).max())
    print(f"interfaces (spkmd calculator=orca, stub): {ORCA_STEPS} NVE "
          f"steps of 8 argon atoms on {sim.system.positions.device}, drift "
          f"{drift:.2e} eV/atom, forces vs -dE/dR of the stub's LJ "
          f"{dF:.2e} of max |F|, {1e3 * sim.wall_seconds / ORCA_STEPS:.1f} "
          f"ms/step (a subprocess a step); {smi}", flush=True)
    assert drift <= ORCA_DRIFT_TOL, f"orca: drift {drift}"
    assert dF <= ORCA_FORCE_TOL, f"orca: forces {dF}"


def interfaces_phase(seed, dev, launches, smi):
    """Phase 14, the interfaces (see the module's docstring); no kernel
    launches."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    reset(launches)
    tmp = tempfile.mkdtemp(prefix="spk14_")    # short: AF_UNIX paths
    try:
        run = write_run_dir(os.path.join(tmp, "run"), ASSET["painn"])
        ref = np.load(REFERENCE["full"])
        big = molecule(ref["R"].astype(np.float64), ref["cell"])
        calc, _ = iface_calculator_phase(run, big, ref, dev, smi)
        small = iface_server_phase(run, tmp, big, ref, calc, seed, dev, smi)
        iface_deploy_phase(run, tmp, big, dev, smi)
        iface_import_phase(tmp, small, seed, dev, smi)
        iface_relax_phase(run, seed, dev, smi)
        iface_orca_phase(tmp, dev, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = {k: v for k, v in read_counts(launches).items() if v}
    print(f"interfaces phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{counts or 'none'}; {smi}", flush=True)
    assert not counts, f"the interfaces launched {counts}"


def median_ms(fn, reps):
    """Median wall time (ms) of ``reps`` calls of ``fn``, each ended by a
    synchronize; and the last call's result."""
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(t)), out


def host_list_phase(pos, cell, dev, smi):
    """Phase 15 (a): the native and the numpy cell list on the bench box
    (5 A + 0.6 A skin) equal array for array, their times (median of
    ``ENGINE_REPS``), then the column host build and ``SpkCalculator``'s
    host neighbor list and collate, beside PR 25's times."""
    from schnetpack_tpu_torch.interfaces import SpkCalculator
    from schnetpack_tpu_torch.md import load_molecules
    from schnetpack_tpu_torch.transform.neighborlist import (
        cell_list_neighbor_list, cell_list_numpy,
    )

    pbc = np.ones(3, bool)
    rc = CUTOFF + SKIN
    native_ms, native = median_ms(
        lambda: cell_list_neighbor_list(pos, rc, cell, pbc), ENGINE_REPS)
    numpy_ms, plain = median_ms(
        lambda: cell_list_numpy(pos, rc, cell, pbc), ENGINE_REPS)
    for a, b, k in zip(native, plain, ("idx_i", "idx_j", "S")):
        assert a.dtype == b.dtype and np.array_equal(a, b), (
            f"native and numpy cell lists differ in {k}")
    calc = calculator(*potential("full"))
    system = load_molecules([molecule(pos, cell)], device=dev)
    calc.init_state(system)
    build_ms, _ = median_ms(lambda: calc.nbl.build(system), 3)
    pot, params = layout_potential("painn")
    pot.load_state_dict(params)
    spk = SpkCalculator(pot, cutoff=CUTOFF, device=dev)
    convert_ms, _ = median_ms(lambda: spk.converter(molecule(pos, cell)), 3)
    print(f"engine (host cell list, {len(pos)} atoms, {CUTOFF} + {SKIN} A): "
          f"native and numpy edge lists equal ({len(native[0])} pairs); "
          f"native {native_ms:.1f} ms, numpy {numpy_ms:.1f} ms (median of "
          f"{ENGINE_REPS}); column host build {build_ms / 1e3:.3f} s "
          f"(PR 25: {PR25_HOST['column host build']}), SpkCalculator host "
          f"neighbor list + collate {convert_ms:.1f} ms (PR 25: "
          f"{PR25_HOST['SpkCalculator neighbor list + collate']}); {smi}",
          flush=True)


def slab_langevin_phase(pos, cell, seed, dev, launches, smi):
    """Phase 15 (b): the slab path's Langevin chunk.  A gamma = 0 chunk
    equals the NVE chunk bit for bit; the card's noise equals the CPU's;
    then ``ENGINE_STEPS`` Langevin steps of ``SpatialColumnSimulator``
    (bath ``T_BATH``, gamma = 1 / ``TAU_FS``) in chunks of
    ``ENGINE_CHUNK`` with a host re-bin before each.  Returns the launch
    counts."""
    from schnetpack_tpu_torch.md import prng
    from schnetpack_tpu_torch.parallel import (
        column_noise, make_sharded_column_chunk,
    )

    kT = KB_EV * T_BATH
    gamma = 0.5 / SLAB_DT / TAU_FS      # 1 / tau per model time unit
    sim = slab_simulator(pos, cell, dev, kT=kT, gamma=gamma, seed=seed)
    slab_momenta(sim, seed)
    lay, inputs = slab_inputs(sim, sim.R, dev)
    m = (lay.slot_mask > 0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    start = (t(sim.R[lay.order] * m[:, None]), t(sim.p[lay.order]
                                                 * m[:, None]),
             t(sim.masses[lay.order] * m))
    key = prng.split(prng.prng_key(seed))[1]
    nve = make_sharded_column_chunk(sim.pot, None, sim.mesh, SLAB_DT,
                                    ENGINE_BITWISE_STEPS)
    zero = make_sharded_column_chunk(sim.pot, None, sim.mesh, SLAB_DT,
                                     ENGINE_BITWISE_STEPS, gamma=0.0, kT=kT)
    R0, p0 = nve(inputs, *start)           # the first also warms up
    zero_ms, (R1, p1) = median_ms(lambda: zero(inputs, *start, key.to(dev)),
                                  1)
    nve_ms, (R2, p2) = median_ms(lambda: nve(inputs, *start), 1)
    assert torch.equal(R0, R2) and torch.equal(p0, p2), (
        "two NVE chunks from one state differ: the force evaluation is not "
        "deterministic")
    assert torch.equal(R0, R1) and torch.equal(p0, p1), (
        "the gamma = 0 Langevin chunk differs from the NVE chunk")
    nx, ny, Pcap, _ = lay.dims
    draws = [column_noise(key.to(d), range(4), nx * ny, Pcap).cpu()
             for d in (dev, "cpu")]
    draw_err = float((draws[0] - draws[1]).abs().max())
    assert draw_err <= DRAW_TOL, f"card vs CPU draws {draw_err}"

    counts, T = {}, []
    n_chunks = ENGINE_STEPS // ENGINE_CHUNK
    for _ in range(n_chunks):
        reset(launches)
        sim.simulate(ENGINE_CHUNK, chunk_size=ENGINE_CHUNK)
        torch.cuda.synchronize()
        for k, v in read_counts(launches).items():
            counts[k] = counts.get(k, 0) + v
        T.append(slab_temperature(sim.masses, sim.p))
    T = np.asarray(T)
    T_last = float(T[-(n_chunks // 3):].mean())
    ms_step = sum(sim.chunk_ms) / ENGINE_STEPS
    print(f"engine (painn_slab Langevin, {len(pos)} atoms, dims="
          f"{lay.dims[:3]}): gamma = 0 chunk equals the NVE chunk bit for "
          f"bit over {ENGINE_BITWISE_STEPS} steps ({zero_ms:.1f} vs "
          f"{nve_ms:.1f} ms wall); card vs CPU draws max |d| "
          f"{draw_err:.2e}; {ENGINE_STEPS} steps at {T_BATH} K, tau "
          f"{TAU_FS} fs in {ENGINE_CHUNK}-step chunks: chunk-end T from "
          f"{T.min():.2f} to {T.max():.2f} K, mean of the last third "
          f"{T_last:.3f} K; ms/step (CUDA events, chunks only) "
          f"{ms_step:.3f}, NVE chunk {nve_ms / ENGINE_BITWISE_STEPS:.3f} "
          f"(wall); host re-bins {sim.rebuilds} in {sim.host_seconds:.3f} "
          f"s wall (PR 25: {PR25_HOST['painn_slab re-bins']}); {smi}",
          flush=True)
    assert np.isfinite(sim.R).all(), "non-finite positions"
    assert 0.0 < T.min() and T.max() < 300.0, f"temperatures {T}"
    assert abs(T_last - T_BATH) <= NVT_TOL["painn_nvt_langevin"], (
        f"Langevin slab: mean T {T_last} K")
    check_launches("painn_slab Langevin", counts, PER_STEP["painn_slab"],
                   n_chunks * (ENGINE_CHUNK + 1))
    return counts


def sharded_phase(pos, cell, seed, dev, launches, smi):
    """Phase 15 (c): ``make_sharded_column_md`` and ``_rpmd`` on the bench
    box against a host-driven loop of ``make_sharded_column_eval`` with
    the same arithmetic.  Returns the launch counts."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.parallel import (
        make_sharded_column_eval, make_sharded_column_md,
        make_sharded_column_rpmd,
    )
    from schnetpack_tpu_torch.transform.atomistic import ATOMIC_MASSES

    mass, dt = float(ATOMIC_MASSES[18]), SLAB_DT
    sim = slab_simulator(pos, cell, dev)
    slab_momenta(sim, seed)
    lay, inputs = slab_inputs(sim, pos, dev)
    m = torch.as_tensor(lay.slot_mask, device=dev)[:, None]
    R_s = torch.as_tensor(pos[lay.order], dtype=torch.float32,
                          device=dev) * m
    p_s = torch.as_tensor(sim.p[lay.order], dtype=torch.float32,
                          device=dev) * m
    evaluate = make_sharded_column_eval(sim.pot, None, inputs, sim.mesh)

    def force(R):
        return evaluate(dict(inputs, **{P.R: R}))[1].detach() * m

    def verlet(R, p, total, n):
        f = total(R)
        for _ in range(n):
            p1 = p + 0.5 * dt * f
            R = R + dt * p1 / mass
            f = total(R)
            p = p1 + 0.5 * dt * f
        return R, p

    counts = {}
    md = make_sharded_column_md(sim.pot, None, inputs, sim.mesh, mass=mass,
                                dt=dt, n_steps=SHARDED_MD_STEPS)
    reset(launches)
    md_ms, (R1, p1) = median_ms(lambda: md(inputs, R_s, p_s), 1)
    c = read_counts(launches)
    check_launches("sharded md", c, PER_STEP["painn_slab"],
                   SHARDED_MD_STEPS + 1)
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    R2, _ = verlet(R_s, p_s, force, SHARDED_MD_STEPS)
    md_err = float((R1 - R2).abs().max())

    nb = SHARDED_BEADS
    omega = nb * KB_EV * T_BATH / (HBAR_EV_FS / 10.180505)
    rng = np.random.RandomState(seed + 21)
    beads = R_s[None] + torch.as_tensor(
        0.02 * rng.randn(nb, *R_s.shape), dtype=torch.float32,
        device=dev) * m
    pb = torch.as_tensor(rng.randn(nb, *R_s.shape) * np.sqrt(
        mass * KB_EV * T_BATH), dtype=torch.float32, device=dev) * m
    rp = make_sharded_column_rpmd(sim.pot, None, inputs, sim.mesh,
                                  n_beads=nb, mass=mass, dt=dt,
                                  n_steps=SHARDED_RPMD_STEPS, omega=omega)
    reset(launches)
    rp_ms, (Rb1, _) = median_ms(lambda: rp(inputs, beads, pb), 1)
    c = read_counts(launches)
    check_launches("sharded rpmd", c,
                   {k: v * nb for k, v in PER_STEP["painn_slab"].items()},
                   SHARDED_RPMD_STEPS + 1)
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v

    def ring(R):
        up, dn = torch.roll(R, -1, 0), torch.roll(R, 1, 0)
        spring = -mass * omega * omega * (2.0 * R - up - dn) * m
        return torch.stack([force(R[b]) for b in range(nb)]) + spring

    Rb2, _ = verlet(beads, pb, ring, SHARDED_RPMD_STEPS)
    rp_err = float((Rb1 - Rb2).abs().max())
    moved = float((Rb1 - beads).abs().max())
    print(f"engine (sharded md, {len(pos)} atoms, one card): "
          f"{SHARDED_MD_STEPS} steps, max |R - R_eval_loop| {md_err:.2e} "
          f"A, {md_ms / SHARDED_MD_STEPS:.3f} ms/step (wall); sharded rpmd "
          f"{nb} beads, omega {omega:.4f} per 10.18 fs, "
          f"{SHARDED_RPMD_STEPS} steps: max |R - R_eval_loop| {rp_err:.2e} "
          f"A (beads moved up to {moved:.3f} A), {rp_ms / SHARDED_RPMD_STEPS:.3f}"
          f" ms/step (wall); K20/K21/K3/K4 3 x beads per evaluation; {smi}",
          flush=True)
    assert md_err <= SHARDED_TOL, f"sharded md vs eval loop {md_err}"
    assert rp_err <= SHARDED_TOL, f"sharded rpmd vs eval loop {rp_err}"
    assert torch.isfinite(Rb1).all() and moved > 0.0
    return counts


def multimol_phase(seed, dev, launches, smi):
    """Phase 15 (d): phase 10's 64 clusters on the column layout
    (``neighbor_list="cellblock"``, PaiNN-128x3 ``fuse="full"``): forces
    and per-molecule energies at the start against ``all_pairs``, K1-K4 3
    each an evaluation, ``MULTIMOL_STEPS`` NVE steps (drift, 0 < T < 300
    K, host rebuilds), ms/step beside ``all_pairs``.  Returns the launch
    counts."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.md import (
        MaxwellBoltzmannInit, Simulator, VelocityVerlet, load_molecules,
    )
    from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator

    col = calculator(*potential("full"))
    ref = SchNetPackCalculator(*layout_potential("painn"), cutoff=CUTOFF,
                               neighbor_list="all_pairs")
    system = MaxwellBoltzmannInit(T_BATH).initialize_system(
        load_molecules(clusters(seed), device=dev),
        torch.Generator().manual_seed(seed + 5))
    reset(launches)
    st = col.init_state(system)
    out = col.calculate(system, st)
    torch.cuda.synchronize()
    counts = read_counts(launches)
    check_launches("painn_clusters column", counts, PER_STEP["full"], 1)
    want = ref.calculate(system, ref.init_state(system))
    F = (out.forces / col.force_conversion).double()
    F_ref = (want.forces / ref.force_conversion).double()
    rms = float((F - F_ref).pow(2).mean().sqrt())
    E = (out.energy / col.energy_conversion).double()
    E_ref = (want.energy / ref.energy_conversion).double()
    dE = float(((E - E_ref).abs() / E_ref.abs()).max())
    nbl = col.nbl
    nx, ny, Ktot = st[P.cell_qcol].shape
    line = (f"engine (painn_clusters on cellblock, {system.n_molecules} "
            f"molecules, {system.total_atoms} atoms, dims=({nx}, {ny}, "
            f"{st['cell_order'].shape[0] // (nx * ny)}) Ktot={Ktot}): "
            f"force rms vs all_pairs {rms:.3e} eV/Ang (largest |F| "
            f"{float(F_ref.abs().max()):.3e}), per-molecule energy rel "
            f"{dE:.2e}; first host build {nbl.build_seconds:.3f} s")
    assert rms <= MULTIMOL_FORCE_RMS, f"clusters column force rms {rms}"
    assert dE <= MULTIMOL_E_RTOL, f"clusters column energy {dE}"
    keys = ("energy", "kinetic_energy", "temperature")
    sim = Simulator(system, VelocityVerlet(0.5), col, seed=seed,
                    log_keys=keys)
    sim.simulate(0)
    builds0, secs0 = nbl.n_builds, nbl.build_seconds
    reset(launches)
    ms_step, peak = timed_run(sim, MULTIMOL_STEPS)
    c = read_counts(launches)
    check_launches("painn_clusters column MD", c, PER_STEP["full"],
                   MULTIMOL_STEPS)
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    T = np.concatenate([lg["temperature"][:, 0] for lg in sim.logs])
    drift = drift_per_atom(sim, col)
    ref_sim = Simulator(system, VelocityVerlet(0.5), ref, seed=seed,
                        log_keys=keys)
    ref_sim.simulate(0)
    ref_ms, _ = timed_run(ref_sim, MULTIMOL_REF_STEPS)
    line += (f"; {MULTIMOL_STEPS} NVE steps: ms/step (CUDA events) "
             f"{ms_step:.3f} (all_pairs {ref_ms:.3f}, {MULTIMOL_REF_STEPS} "
             f"steps), drift {drift:.3e} eV/atom, T from {T.min():.2f} to "
             f"{T.max():.2f} K, host rebuilds {nbl.n_builds - builds0} in "
             f"{nbl.build_seconds - secs0:.3f} s, device rebuilds "
             f"{nbl.n_device_builds}, peak device memory {peak:.2f} GiB")
    print(f"{line}; {smi}", flush=True)
    assert np.isfinite(sim.system.positions.cpu().numpy()).all()
    assert 0.0 < T.min() and T.max() < 300.0, f"clusters T {T.min()} {T.max()}"
    assert drift <= DRIFT_TOL, f"clusters column drift {drift}"
    assert nbl.n_device_builds == 0, "batched molecules rebuilt on the device"
    return counts


def engine_phase(pos, cell, seed, dev, launches, smi):
    """Phase 15 (see the module's docstring); returns the launch counts of
    its MD runs."""
    t0 = time.perf_counter()
    host_list_phase(pos, cell, dev, smi)
    total = {}
    for part in (slab_langevin_phase, sharded_phase):
        for k, v in part(pos, cell, seed, dev, launches, smi).items():
            total[k] = total.get(k, 0) + v
    for k, v in multimol_phase(seed, dev, launches, smi).items():
        total[k] = total.get(k, 0) + v
    print(f"engine phase: {time.perf_counter() - t0:.1f} s; {smi}",
          flush=True)
    return total


PARALLEL_RANKS = 2
#: phase 16's meshes: x slabs of (5, 10) columns a rank, (x, y) blocks of
#: (10, 5), whose y exchange crosses the ranks
PARALLEL_MESHES = {"x slabs": (2,), "xy blocks": (1, 2)}
PARALLEL_NVE_STEPS = 50          # on the x slabs
PARALLEL_NVT_STEPS = 25          # Langevin at T_BATH on the (x, y) blocks
PARALLEL_FORCE_TOL = 1e-5        # eV/Ang, two ranks vs one
PARALLEL_FIXTURE_TOL = 1e-4      # eV/Ang, largest |F - F_jax| of two ranks
PARALLEL_MD_TOL = 2e-4           # Angstrom, two ranks vs one
PARALLEL_LEAF_TOL = 1e-5         # per leaf, of its largest |entry|
PARALLEL_TRAIN_STEPS = 2


def parallel_launches():
    """The launch counters of every kernel module, for a rank."""
    from schnetpack_tpu_torch.ops import cellblock_gather as cg
    from schnetpack_tpu_torch.ops import colblock_edge as edge
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op
    from schnetpack_tpu_torch.ops import colblock_message as msg
    from schnetpack_tpu_torch.ops import colblock_select as sel
    from schnetpack_tpu_torch.ops import painn_fused as pf
    from schnetpack_tpu_torch.ops import painn_mixing as mix
    from schnetpack_tpu_torch.ops import schnet_columns as cf

    return (msg.LAUNCHES, mix.LAUNCHES, geo_op.LAUNCHES, cf.LAUNCHES,
            sel.LAUNCHES, cg.LAUNCHES, pf.LAUNCHES, edge.LAUNCHES)


class deterministic:
    """PyTorch's deterministic algorithms inside the block (the card's
    float atomics, as in ``index_add_``, reorder f32 sums from run to run;
    their deterministic forms give one rank's gradient bit for bit
    again)."""

    def __enter__(self):
        import warnings

        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)
        self._warnings.__exit__(*exc)


def dp_task(dev):
    """(task, two numpy batches) of phase 16's data-parallel steps: phase
    11's PaiNN-128x3, loss and flat batch, and the batch with other labels
    (half the energies, the forces turned round); SGD with momentum 0.9 at
    lr 1e-4 after a clip of the gradient's norm to 1, an update linear in
    the gradient (Adam's first steps are sign steps, which turn the ulps of
    a near-zero gradient entry into a whole step of lr).  The batch's
    atoms come as close as 0.04 A, so its gradient is large: the clip keeps
    the step small."""
    from schnetpack_tpu_torch.train import AtomisticTask

    task, batch = train_task_and_batch("flat", dev)
    other = dict(batch)
    other["energy"] = batch["energy"] * 0.5
    other["forces"] = batch["forces"] * -0.5
    return AtomisticTask(task.model, task.outputs, learning_rate=1e-4,
                         optimizer="sgd", optimizer_args={"momentum": 0.9},
                         grad_clip=1.0), [batch, other]


def parallel_rank(rank, pos, cell, p, seed):
    """Phase 16 on one rank of two gloo ranks that share the card: the
    bench box's slab forces on each of ``PARALLEL_MESHES``, an NVE chunk
    on the x slabs and a Langevin chunk on the (x, y) blocks (timed, with
    the exchange's wall seconds), each rank's launches, then data-parallel
    train steps; numpy results, the slab arrays in the original atom
    order."""
    import torch.distributed as dist

    from schnetpack_tpu_torch.md import prng
    from schnetpack_tpu_torch.ops import _build
    from schnetpack_tpu_torch.ops import colblock_shard as shard
    from schnetpack_tpu_torch.parallel import (
        DataParallelTask, column_inputs, gather_slabs, make_column_mesh,
        make_mesh, make_sharded_column_chunk, make_sharded_column_eval,
        slab_of,
    )
    from schnetpack_tpu_torch.parallel.data_parallel import mean_over_ranks
    from schnetpack_tpu_torch.train import as_tensors

    dev = torch.device("cuda")
    _build.lib()
    launches = parallel_launches()
    sim = slab_simulator(pos, cell, dev)
    lay = sim.layout()
    m = lay.slot_mask > 0
    out = {"backend": dist.get_backend(), "meshes": {}}
    for name, dims in PARALLEL_MESHES.items():
        mesh = make_column_mesh(PARALLEL_RANKS, dims if len(dims) == 2
                                else None, device="cuda", backend="gloo")
        ins = column_inputs(lay, pos, sim.Z, mesh=mesh)
        r = {"device": str(mesh.device), "coords": mesh.coords,
             "slab": mesh.slab(*lay.qcol.shape[:2])}
        E, F = make_sharded_column_eval(sim.pot, None, ins, mesh)(ins)
        r["E"] = E.double().cpu().numpy()
        r["F"] = gather_slabs(lay, mesh, F.detach()).double().cpu().numpy()[
            lay.rank]

        def cut(a):
            return slab_of(lay, mesh, torch.as_tensor(
                a, dtype=torch.float32, device=dev))

        start = (cut(pos[lay.order] * m[:, None]),
                 cut(p[lay.order] * m[:, None]),
                 cut(sim.masses[lay.order] * m))
        nvt = name == "xy blocks"
        steps = PARALLEL_NVT_STEPS if nvt else PARALLEL_NVE_STEPS
        kw = (dict(gamma=0.5 / SLAB_DT / TAU_FS, kT=KB_EV * T_BATH) if nvt
              else {})
        chunk = make_sharded_column_chunk(sim.pot, None, mesh, SLAB_DT,
                                          steps, **kw)
        key = (prng.split(prng.prng_key(seed))[1].to(dev),) if nvt else ()
        mesh.barrier()
        reset(launches)
        x0 = dict(shard.EXCHANGES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        R1, p1 = chunk(ins, *start, *key)
        b.record()
        torch.cuda.synchronize()
        r["wall_ms"] = (time.perf_counter() - t0) * 1e3 / steps
        r["ms"] = a.elapsed_time(b) / steps
        r["exchanges"] = shard.EXCHANGES["calls"] - x0["calls"]
        r["exchange_ms"] = (shard.EXCHANGES["seconds"] - x0["seconds"]) \
            * 1e3 / steps
        r["launches"] = read_counts(launches)
        r["evaluations"] = steps + 1
        r["R"] = gather_slabs(lay, mesh, R1).double().cpu().numpy()[lay.rank]
        out["meshes"][name] = r
    # data-parallel training: rank r takes batch r, one all-reduce a step
    task, batches = dp_task(dev)
    mesh = make_mesh(PARALLEL_RANKS, ("data",), device="cuda",
                     backend="gloo")
    DataParallelTask(task, mesh)       # rank 0's weights on every rank
    state = task.create_state()
    reduce = mean_over_ranks(mesh)
    grads = []

    def record(g, metrics):
        g, metrics = reduce(g, metrics)
        grads.append({k: v.double().cpu().numpy() for k, v in g.items()})
        return g, metrics

    reset(launches)
    with deterministic():
        for _ in range(PARALLEL_TRAIN_STEPS):
            state, _ = task.train_step(state, as_tensors(batches[rank], dev),
                                       reduce=record)
    torch.cuda.synchronize()
    out["train"] = {"grads": grads, "params": {
        k: v.detach().double().cpu().numpy()
        for k, v in state.params.items()},
        "launches": sum(read_counts(launches).values())}
    return out


def leaf_err(got, want):
    """The worst leaf (name, max |got - want| / max |want|)."""
    errs = {k: float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30)) for k in want}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def parallel_phase(pos, cell, seed, dev, launches, smi):
    """Phase 16: two ranks on the one card through an explicit gloo group
    (``parallel.mesh.spawn_ranks``; the workers are ``parallel_rank``)
    against one rank: the slab forces of the bench box on x slabs (2,) and
    (x, y) blocks (1, 2) within 1e-5 eV/Ang of one rank's slab evaluation
    and within phase 4's gates of ``port_ref_painn_argon.npz``, at its
    positions; a 50-step NVE chunk on the
    x slabs and a 25-step Langevin chunk at 30 K on the blocks within 2e-4
    A of one rank's; each rank's launches (K11-K14 1, K20/K21/K3/K4 3 an
    evaluation); two data-parallel train steps (one batch a rank) against
    one rank on the mean of both batches' gradients, every leaf of the
    averaged gradient and of the parameters within 1e-5 (under PyTorch's
    deterministic algorithms, on both sides); the ms/step and the
    exchange's share beside one rank's."""
    import tempfile

    from schnetpack_tpu_torch.md import prng
    from schnetpack_tpu_torch.parallel import (
        make_sharded_column_chunk, make_sharded_column_eval, spawn_ranks,
    )
    from schnetpack_tpu_torch.train import as_tensors

    t_phase = time.perf_counter()
    ref = np.load(REFERENCE["full"])
    # the bench box as the fixture holds it (jittered by 0.1 A)
    pos, cell = ref["R"].astype(np.float64), ref["cell"].astype(np.float64)
    sim = slab_simulator(pos, cell, dev)
    slab_momenta(sim, seed)
    p = sim.p.copy()
    lay, inputs = slab_inputs(sim, pos, dev)
    _, F = make_sharded_column_eval(sim.pot, None, inputs, sim.mesh)(inputs)
    F_one = F.detach().double().cpu().numpy()[lay.rank]
    m = lay.slot_mask > 0

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    start = (t(pos[lay.order] * m[:, None]), t(p[lay.order] * m[:, None]),
             t(sim.masses[lay.order] * m))
    one = {}
    for name, nvt in (("x slabs", False), ("xy blocks", True)):
        steps = PARALLEL_NVT_STEPS if nvt else PARALLEL_NVE_STEPS
        kw = (dict(gamma=0.5 / SLAB_DT / TAU_FS, kT=KB_EV * T_BATH) if nvt
              else {})
        chunk = make_sharded_column_chunk(sim.pot, None, sim.mesh, SLAB_DT,
                                          steps, **kw)
        key = (prng.split(prng.prng_key(seed))[1].to(dev),) if nvt else ()
        ms, (R1, _) = median_ms(lambda: chunk(inputs, *start, *key), 1)
        one[name] = (ms / steps, R1.double().cpu().numpy()[lay.rank])
    task, batches = dp_task(dev)
    state = task.create_state()
    batches = [as_tensors(b, dev) for b in batches]
    ref_grads = []
    with deterministic():
        for _ in range(PARALLEL_TRAIN_STEPS):
            gs = [task.gradients(state, b)[2] for b in batches]
            g = {k: (gs[0][k] + gs[1][k]) / 2 for k in gs[0]}
            ref_grads.append({k: v.double().cpu().numpy()
                              for k, v in g.items()})
            with torch.no_grad():
                task.apply_gradients(state, g)
    ref_params = {k: v.detach().double().cpu().numpy()
                  for k, v in state.params.items()}
    del sim, inputs, task, state, batches
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn_ranks(parallel_rank, PARALLEL_RANKS,
                            (pos, cell, p, seed), tmp, backend="gloo")
        spawn_s = time.perf_counter() - t0
    print(f"parallel (phase 16): {PARALLEL_RANKS} ranks on one card, "
          f"backend {ranks[0]['backend']} (devices "
          f"{[r['meshes']['x slabs']['device'] for r in ranks]}), "
          f"{spawn_s:.1f} s with their start; {smi}", flush=True)
    assert all(r["backend"] == "gloo" for r in ranks)
    counts = {}
    for name, dims in PARALLEL_MESHES.items():
        per = [r["meshes"][name] for r in ranks]
        F_err = max(float(np.abs(q["F"] - F_one).max()) for q in per)
        F_fix = max(float(np.abs(q["F"] - ref["forces"]).max())
                    for q in per)
        F_rms = max(float(np.sqrt(np.mean((q["F"] - ref["forces"]) ** 2)))
                    for q in per)
        E_sum = float(per[0]["E"].sum())
        dE = abs(E_sum - float(ref["energy"])) / abs(float(ref["energy"]))
        R_err = max(float(np.abs(q["R"] - one[name][1]).max()) for q in per)
        steps = per[0]["evaluations"] - 1
        kind = ("Langevin at 30 K" if name == "xy blocks" else "NVE")
        print(f"parallel ({name}, dims {dims}, columns a rank "
              f"{[q['slab'] for q in per]}): forces max |F - F_one rank| "
              f"{F_err:.3e} eV/Ang, vs F_jax rms {F_rms:.3e} (max {F_fix:.3e}), "
              f"energy "
              f"sum of the partials {E_sum:.6f} vs {float(ref['energy']):.6f}"
              f" (rel {dE:.2e}); {steps}-step {kind} chunk max |R - "
              f"R_one rank| {R_err:.3e} A; ms/step per rank (CUDA events) "
              f"{[round(q['ms'], 3) for q in per]}, wall "
              f"{[round(q['wall_ms'], 3) for q in per]}, exchange "
              f"{[round(q['exchange_ms'], 3) for q in per]} ms/step "
              f"({[round(q['exchange_ms'] / q['wall_ms'], 3) for q in per]}"
              f" of the wall; {per[0]['exchanges']} exchanges), one rank "
              f"{one[name][0]:.3f} ms/step; launches per rank "
              f"{[{k: v for k, v in q['launches'].items() if v} for q in per]}"
              f"; {smi}", flush=True)
        assert F_err <= PARALLEL_FORCE_TOL, f"{name}: forces vs one rank"
        assert F_rms <= FORCE_RMS_TOL, f"{name}: forces vs the JAX fixture"
        assert F_fix <= PARALLEL_FIXTURE_TOL, f"{name}: max |F - F_jax|"
        assert dE <= ENERGY_RTOL, f"{name}: energy vs the JAX fixture"
        assert R_err <= PARALLEL_MD_TOL, f"{name}: chunk vs one rank"
        for r, q in enumerate(per):
            check_launches(f"parallel {name} rank {r}", q["launches"],
                           PER_STEP["painn_slab"], q["evaluations"])
            for k, v in q["launches"].items():
                counts[k] = counts.get(k, 0) + v
    worst = []
    for r, q in enumerate(ranks):
        tr = q["train"]
        assert len(tr["grads"]) == PARALLEL_TRAIN_STEPS
        for s, (g, w) in enumerate(zip(tr["grads"], ref_grads)):
            worst.append((f"rank {r} step {s + 1} gradient",) + leaf_err(g, w))
        worst.append((f"rank {r} parameters",) + leaf_err(tr["params"],
                                                          ref_params))
        assert tr["launches"] == 0, "the flat train step launched a kernel"
    print(f"parallel (data-parallel PaiNN-128x3, SGD, {PARALLEL_TRAIN_STEPS}"
          " steps, one batch a rank, vs one rank on the mean of both "
          f"batches' gradients): worst leaves {worst}", flush=True)
    for what, leaf, err in worst:
        assert err <= PARALLEL_LEAF_TOL, f"{what}: {leaf} {err}"
    print(f"parallel phase: {time.perf_counter() - t_phase:.1f} s; {smi}",
          flush=True)
    return counts


# --------------------------------------------------- phase 17: every width
#: the JAX fixtures of phase 17 (``scripts/make_port_reference_widths.py``:
#: forces, energy and the models' own seeded init parameters on the bench
#: box): PaiNN-30x3 and SchNet-30x3 (SchNetPack 2's tutorials' width, 20
#: Gaussians) and SchNet-64x3 with the SchNet paper's 300 Gaussians
WIDTH_REFERENCE = {
    name: os.path.join(ROOT, "tests", "data", f"port_ref_{name}_argon.npz")
    for name in ("painn_w30", "schnet_w30", "schnet_b300")}
#: (a) the sweep against the twins: the message family's (F, B), plain
#: and wgrad (at (512, 300) P3's warps split the n-tiles, at (30, 1000) the
#: basis arrays lie in global scratch); the reduced modes' F (B = 20); the
#: mixing's F on its row counts (the general K4's tiles in shared memory to
#: F = 255, in global scratch from 257); the cfconv's (F, B) (K9's weights
#: from L2 from (193, 20), its tiles in global scratch at (64, 1750) and
#: (64, 2000); K10's at (1024, 20) wgrad and (64, 2000))
WIDTH_MSG = ((30, 20), (50, 20), (130, 20), (288, 20), (512, 20), (30, 31),
             (30, 50), (512, 300), (30, 1000))
WIDTH_REDUCED = (30, 288)
WIDTH_MIX = (30, 50, 130, 255, 257, 288, 384, 512, 1024)
WIDTH_MIX_ROWS = (37, 12_800)
WIDTH_CF = ((30, 20), (96, 20), (192, 20), (193, 20), (256, 20), (512, 20),
            (64, 50), (128, 50), (64, 300), (128, 300), (1024, 20),
            (64, 1750), (64, 2000))
#: the tuned message backward's widths (B = 20) at which the general one is
#: timed beside it on the bench box
WIDTH_TUNED = (128, 256)
#: the widths of the tuned cfconv kernels (``schnet_columns.N_FILTERS``),
#: at which phase 17 times the general K9 and K10 beside them
CF_TUNED_WIDTHS = (64, 128)
#: the sweep's box: the bench box's layout at 2,048 atoms
WIDTH_BOX = 2_000
#: the widest swept F, whose general instances are timed beside F = 30
WIDTH_WIDE = 512
WIDTH_STEPS = 300
#: steps of the runs that drive the other layouts' and modes' general
#: instances on their main paths (launches only)
WIDTH_SHORT = 20
#: (b)'s NVE drift gate, eV/atom, set before the card ran from the CPU
#: twins' 300 steps of the same weights, start state and step on a 2,048-
#: atom box (PaiNN-30x3 full 1.5e-8, hybrid 3.0e-8; PERF.md, phase 17):
#: ~30x above them and the f32 energy's noise (~1e-8 an atom)
WIDTH_DRIFT_TOL = 1e-6
#: the message, mixing and cfconv counters the general instances take at
#: widths the tuned ones do not (``gen_per_step``)
GEN_FAMILIES = ("msg_", "cell_msg_", "mix_", "cf_")
#: the width of the short run whose PaiNN drives K3's general instance
#: (the tuned K3 takes F <= 352), one interaction of it
WIDTH_K3 = 384
#: the SchNet paper's filters and Gaussians, a sub-row of cf_bwd_gen on the
#: bench box
WIDTH_PAPER = (64, 300)
#: device ms of the redesigned general instances before their redesign
#: (PERF.md's kernel table, NVIDIA H100 80GB HBM3, 700 W): ((plain at F =
#: 30 on the bench box, plain at F = WIDTH_WIDE on the sweep's box),
#: (wgrad at F = 30, wgrad at F = WIDTH_WIDE)); K9 has no wgrad instance
BEFORE_REDESIGN_MS = {
    "cf_fwd_gen": ((0.5442, 5.5945), (None, None)),
    "mix_bwd_gen": ((0.3107, 12.2335), (1.0320, 13.5381)),
    "msg_bwd_gen": ((0.7407, 4.5285), (1.1115, 5.2274)),
    "msg_bwd_geores_gen": ((0.8238, 4.5550), (1.2405, 5.4549)),
    "msg_bwd_src_gen": ((1.0048, 5.8920), (1.7396, 9.6337)),
    "msg_bwd_edge_gen": ((0.8801, 5.9060), (1.6057, 9.5903)),
    "cell_msg_bwd_gen": ((0.8756, 5.6013), (1.5984, 9.1974)),
    "cf_bwd_gen": ((1.2012, 56.9767), (3.0595, 149.2195)),
}


def width_tree(name):
    """(flax tree, F, B) of a phase-17 fixture: its ``param.<path>``
    arrays as the nested parameter tree."""
    ref = np.load(WIDTH_REFERENCE[name])
    tree = {}
    for k in ref.files:
        if k.startswith("param."):
            *path, leaf = k.split(".")[1:]
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(ref[k])
    return tree, int(ref["n_atom_basis"]), int(ref["n_rbf"])


def width_potential(path, name="painn_w30", forces=True):
    """The model of fixture ``name`` on an MD path and its parameters:
    PaiNN-FxB (from "painn_w30") in the message form "full" or "hybrid",
    on the row-9 path with its Gaussians trainable ("painn_trbf"), on the
    27-cell layout ("painn_cell") or the slab path ("painn_slab"), or
    SchNet-FxB ("schnet")."""
    from schnetpack_tpu_torch.atomistic import (
        Atomwise, Forces, PairwiseDistances,
    )
    from schnetpack_tpu_torch.convert import (
        params_from_jax, with_radial_params,
    )
    from schnetpack_tpu_torch.model import NeuralNetworkPotential
    from schnetpack_tpu_torch.nn import GaussianRBF
    from schnetpack_tpu_torch.ops.radial import gaussian_rbf_params
    from schnetpack_tpu_torch.representation import PaiNN, SchNet

    tree, F, B = width_tree(name)
    inputs = []
    if path == "schnet":
        rep = SchNet(n_atom_basis=F, n_interactions=3, n_rbf=B,
                     cutoff=CUTOFF)
    elif path == "painn_trbf":
        rep = PaiNN(n_atom_basis=F, n_interactions=3, n_rbf=B,
                    cutoff=CUTOFF,
                    radial_basis=GaussianRBF(B, CUTOFF, trainable=True))
        inputs = [PairwiseDistances()]
        tree = with_radial_params(tree, *(np.asarray(a, np.float32) for a in
                                          gaussian_rbf_params(B, CUTOFF)))
    elif path in ("painn_cell", "painn_slab"):
        rep = PaiNN(n_atom_basis=F, n_interactions=3, n_rbf=B,
                    cutoff=CUTOFF)
        inputs = [PairwiseDistances()]
    else:
        rep = PaiNN(n_atom_basis=F, n_interactions=3, n_rbf=B,
                    cutoff=CUTOFF, fuse=path)
    heads = [Atomwise(n_in=F)] + ([Forces()] if forces else [])
    pot = NeuralNetworkPotential(rep, heads, input_modules=inputs)
    return pot, params_from_jax(tree)


def wide_potential(seed):
    """PaiNN-WIDTH_K3 x 1 ("full", 20 Gaussians) with the port's own init
    from ``seed`` and its parameters."""
    from schnetpack_tpu_torch.atomistic import Atomwise, Forces
    from schnetpack_tpu_torch.model import NeuralNetworkPotential
    from schnetpack_tpu_torch.representation import PaiNN

    torch.manual_seed(seed)
    pot = NeuralNetworkPotential(
        PaiNN(n_atom_basis=WIDTH_K3, n_interactions=1, n_rbf=20,
              cutoff=CUTOFF, fuse="full"),
        [Atomwise(n_in=WIDTH_K3), Forces()])
    return pot, {k: v.detach().clone() for k, v in pot.state_dict().items()}


def gen_per_step(per_step, F, B):
    """A path's launches a step at width F and basis B: the counters of
    the message, mixing and cfconv kernels under their general instances'
    names where the tuned ones do not take (F, B) (K3 takes F <= 352,
    padded; K5, K8 and the gathers any)."""
    from schnetpack_tpu_torch.ops import colblock_message as msg
    from schnetpack_tpu_torch.ops import painn_mixing as mix
    from schnetpack_tpu_torch.ops import schnet_columns as cf

    def tuned(k):
        if k.startswith("mix_"):
            return mix.tuned_width(F, bwd=k.startswith("mix_bwd"))
        if k.startswith("cf_"):
            return cf.tuned_width(F, B)
        return msg.tuned_width(F, B, "wgrad" in k)

    return {(msg.gen_name(k) if k.startswith(GEN_FAMILIES) and not tuned(k)
             else k): v for k, v in per_step.items()}


def held_compare(name, got, w32, w64, norm_from=None):
    """Each output against the float64 twin at phase 3's tolerances, or,
    where the f32 twin itself misses them on these inputs, within twice
    its miss (two f32 summation orders); from output ``norm_from`` on
    normwise; returns the max abs difference from the float64 twin."""
    err = 0.0
    for i, (g, a, w) in enumerate(zip(got, w32, w64)):
        if norm_from is not None and i >= norm_from:
            d = float((g.double() - w.double()).norm())
            assert d <= NORM_RTOL * float(w.double().norm()), (
                f"{name}: output {i} off by {d} (norm {w.norm()})")
        else:
            miss = float((g.double() - w.double()).abs().max())
            own = float((a.double() - w.double()).abs().max())
            if own <= ATOL:
                torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL,
                                           msg=lambda m: f"{name}: {m}")
            else:
                assert miss <= 2 * own, (
                    f"{name}: output {i} off by {miss:.3e}, the f32 twin "
                    f"by {own:.3e}")
        err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def width_sweep(seed, dev):
    """Phase 17 (a): every general instance against its twin at the swept
    shapes, on the column layout of the WIDTH_BOX box (random features,
    weights and cotangents from ``seed``) and, for K3/K4, on 37 and
    12,800 random rows; the backwards and gFW held to the float64 twins.
    Returns the reduced instances' sub-rows by row name (under the mode at
    F = 30, under "F288_<mode>" at 288) and the box's system."""
    from schnetpack_tpu_torch.md import load_molecules
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op
    from schnetpack_tpu_torch.ops import colblock_message as msg
    from schnetpack_tpu_torch.ops import painn_mixing as mix
    from schnetpack_tpu_torch.ops import schnet_columns as cf
    from schnetpack_tpu_torch.ops.radial import gaussian_rbf_table

    pos, cell = fcc_box(WIDTH_BOX)
    system = load_molecules([molecule(pos, cell)], device=dev)
    R, coff, refs = run_inputs(calculator(*width_potential("hybrid")),
                               system)
    Ap = R.shape[0]
    g = torch.Generator().manual_seed(seed + 17)

    def rnd(*shape, scale=0.3):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    checked = 0
    for F, B in WIDTH_MSG:
        cw = gaussian_rbf_table(B, CUTOFF, device=dev)
        x, mu, FW = rnd(Ap, 3 * F), rnd(Ap, 3 * F), rnd(B + 1, 3 * F)
        cots = (rnd(Ap, F, scale=1.0), rnd(Ap, 3 * F, scale=1.0))
        full = (x, mu, R, FW, coff, cw, refs, CUTOFF)
        gargs = (R, coff, refs, cw, CUTOFF)
        geo = geo_op.geo_fwd_kernel(*gargs)
        geo4 = geo_op.geo_fwd_kernel(*gargs, with_d=False)
        hyb = (x, mu, geo, FW, cw, refs, CUTOFF)
        src = (x, mu, geo4, FW, refs)
        tag = f"F={F} B={B}"
        for kern, plain, args in [
                (msg.msg_fwd_kernel, msg.msg_fwd_plain, full),
                (msg.msg_fwd_geo_kernel, msg.msg_fwd_geo_plain,
                 (x, mu, geo, FW, refs))]:
            held_compare(f"{kern.__name__} {tag}", kern(*args), plain(*args),
                         in_f64(plain, *args))
            checked += 1
        for kern, plain, args in [
                (msg.msg_bwd_kernel, msg.msg_bwd_plain, full),
                (msg.msg_bwd_geores_kernel, msg.msg_bwd_geores_plain, hyb),
                (msg.msg_bwd_src_kernel, msg.msg_bwd_src_plain, src)]:
            w32, w64 = plain(*args, *cots), in_f64(plain, *args, *cots)
            held_compare(f"{kern.__name__} {tag}", kern(*args, *cots),
                         w32[:3], w64[:3])
            held_compare(f"{kern.__name__} wgrad {tag}",
                         kern(*args, *cots, wgrad=True), w32, w64,
                         norm_from=3)
            checked += 2
        del x, mu, FW, cots, geo, geo4, full, hyb, src
    print(f"widths (a): message family at (F, B) {WIDTH_MSG}, plain and "
          f"wgrad, on {Ap} rows: {checked} instances match", flush=True)
    reduced = {}
    cw = gaussian_rbf_table(20, CUTOFF, device=dev)
    for F in WIDTH_REDUCED:
        x, mu, FW = rnd(Ap, 3 * F), rnd(Ap, 3 * F), rnd(21, 3 * F)
        cots = (rnd(Ap, F, scale=1.0), rnd(Ap, 3 * F, scale=1.0))
        margs = (x, mu, R, FW, coff, cw, refs, CUTOFF)
        geo = geo_op.geo_fwd_kernel(R, coff, refs, cw, CUTOFF)
        ni = live_edges(refs, geo[:, :, 24] < CUTOFF)
        ne = real_edges(refs)
        flops = ni * (6 * F * 21 + 16 * F)
        for precision in REDUCED:
            for r in reduced_kernel_rows(
                    precision, margs, (x, mu, geo, FW, refs),
                    (x, mu, geo, FW, cw, refs, CUTOFF, *cots), geo, cots,
                    (refs.qcol, refs.dcol), flops, 2 * flops,
                    ni * 6 * F * 21, ne, 20):
                key = precision if F == 30 else f"F{F}_{precision}"
                reduced.setdefault(msg.gen_name(r.pop("name")), {})[key] = r
    for F in WIDTH_MIX:
        for A in WIDTH_MIX_ROWS:
            w = 0.2 * (32.0 / F) ** 0.5
            ins = (rnd(A, F, scale=1.0), rnd(A, 3 * F, scale=1.0),
                   rnd(A, F, scale=0.5), rnd(A, 3 * F, scale=0.5),
                   rnd(F, 2 * F, scale=w), rnd(2 * F, F, scale=w),
                   rnd(F, scale=0.1), rnd(F, 3 * F, scale=w),
                   rnd(3 * F, scale=0.1), 1e-8, "ssp")
            cots = (rnd(A, F, scale=1.0), rnd(A, 3 * F, scale=1.0))
            tag = f"F={F} A={A}"
            held_compare(f"mix_fwd {tag}", mix.mix_fwd_kernel(*ins),
                         mix.painn_mixing_plain(*ins),
                         in_f64(mix.painn_mixing_plain, *ins))
            w32 = mix.painn_mixing_bwd_plain(*ins, *cots, wgrad=True)
            w64 = in_f64(lambda *a: mix.painn_mixing_bwd_plain(
                *a, wgrad=True), *ins, *cots)
            held_compare(f"mix_bwd {tag}", mix.mix_bwd_kernel(*ins, *cots),
                         w32[:2], w64[:2])
            held_compare(f"mix_bwd wgrad {tag}",
                         mix.mix_bwd_kernel(*ins, *cots, wgrad=True), w32,
                         w64, norm_from=2)
    print(f"widths (a): K3/K4 (plain and wgrad) at F {WIDTH_MIX} on "
          f"{WIDTH_MIX_ROWS} rows match", flush=True)
    for F, B in WIDTH_CF:
        cw = gaussian_rbf_table(B, CUTOFF, device=dev)
        geo = geo_op.geo_fwd_kernel(R, coff, refs, cw, CUTOFF, with_d=False,
                                    raw_phi=True)
        w1, w2 = (6.0 / (B + F)) ** 0.5, (3.0 / F) ** 0.5
        args = (rnd(Ap, F, scale=1.0), geo, rnd(B, F, scale=w1),
                rnd(F, scale=0.1), rnd(F, F, scale=w2), rnd(F, scale=0.1))
        gc = rnd(Ap, F, scale=1.0)
        tag = f"F={F} B={B}"

        def fwd(*a):
            return (cf.cf_fwd_plain(*a),)

        held_compare(f"cf_fwd {tag}", (cf.cf_fwd_kernel(*args, refs),),
                     fwd(*args, refs), in_f64(fwd, *args, refs))
        w32 = cf.cf_bwd_plain(*args, refs, gc)
        w64 = in_f64(cf.cf_bwd_plain, *args, refs, gc)
        held_compare(f"cf_bwd {tag}", cf.cf_bwd_kernel(*args, refs, gc),
                     w32[:2], w64[:2])
        held_compare(f"cf_bwd wgrad {tag}",
                     cf.cf_bwd_kernel(*args, refs, gc, wgrad=True), w32,
                     w64, norm_from=2)
    print(f"widths (a): K9/K10 (plain and wgrad) at (F, B) {WIDTH_CF} "
          "match", flush=True)
    return reduced, system


def width_layouts(system, dev):
    """The inputs of the general instances' rows on ``system``: the column
    layout of PaiNN-30x3 (positions, offsets, refs, the packed geometry of
    K6/K7, K15 and K9/K10 and the edge-major one of K20/K21) and the
    27-cell layout's refs, basis and directions (K18/K19)."""
    from schnetpack_tpu_torch.atomistic.distances import cell_refs
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op
    from schnetpack_tpu_torch.ops.colblock import column_geometry
    from schnetpack_tpu_torch.ops.radial import gaussian_rbf_table

    R, coff, refs = run_inputs(calculator(*width_potential("hybrid")),
                               system)
    cell_calc = calculator(*width_potential("painn_cell"), layout="atom")
    inputs = cell_calc.model_inputs(system, cell_calc.init_state(system))
    crefs = cell_refs(inputs)
    with torch.no_grad():
        crbf, cdir = cell_calc.model.representation._cell_geometry(
            cell_calc.model.input_modules[0](inputs))
    B = 20
    cw = gaussian_rbf_table(B, CUTOFF, device=dev)
    gargs = (R, coff, refs, cw, CUTOFF)
    geo = geo_op.geo_fwd_kernel(*gargs)
    with torch.no_grad():
        erbf, edir = column_geometry(*gargs)
    return dict(
        R=R, coff=coff, refs=refs, cw=cw, B=B, geo=geo,
        geo4=geo_op.geo_fwd_kernel(*gargs, with_d=False),
        graw=geo_op.geo_fwd_kernel(*gargs, with_d=False, raw_phi=True),
        erbf=erbf.contiguous(), edir=edir.contiguous(), crefs=crefs,
        crbf=crbf.contiguous(), cdir=cdir.contiguous(),
        ne=real_edges(refs), ni=live_edges(refs, geo[:, :, B + 4] < CUTOFF),
        cne=int((crefs.qidx >= 0).sum()),
        cni=int(((crefs.qidx.reshape(crbf.shape[:2]) >= 0)
                 & (crbf[..., -1] != 0)).sum()))


def width_cases(F, L, seed, dev):
    """The general instances' ``case``s at width F on the layouts ``L``
    (``width_layouts``), held to their float64 twins; K3's at 384 where F
    is 30 (its general instance serves F > 352)."""
    from schnetpack_tpu_torch.ops import colblock_edge as edge
    from schnetpack_tpu_torch.ops import colblock_message as msg
    from schnetpack_tpu_torch.ops import painn_fused as pf
    from schnetpack_tpu_torch.ops import painn_mixing as mix
    from schnetpack_tpu_torch.ops import schnet_columns as cf

    R, coff, refs, cw, B = L["R"], L["coff"], L["refs"], L["cw"], L["B"]
    geo, crefs, crbf, cdir = L["geo"], L["crefs"], L["crbf"], L["cdir"]
    erbf, edir = L["erbf"], L["edir"]
    ne, ni, cne, cni = L["ne"], L["ni"], L["cne"], L["cni"]
    Ap, CAp = R.shape[0], crbf.shape[0]
    idx = (refs.qcol, refs.dcol)
    g = torch.Generator().manual_seed(seed + 28 + F)

    def rnd(*shape, scale=0.3):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    def f64(fn, *args, n=None):
        return lambda: in_f64(fn, *args)[:n]

    x, mu, FW = rnd(Ap, 3 * F), rnd(Ap, 3 * F), rnd(B + 1, 3 * F)
    cots = (rnd(Ap, F, scale=1.0), rnd(Ap, 3 * F, scale=1.0))
    xmu = torch.cat([x, mu], 1)
    cx = rnd(CAp, 6 * F)
    ccots = (rnd(CAp, F, scale=1.0), rnd(CAp, 3 * F, scale=1.0))
    margs = (x, mu, R, FW, coff, cw, refs, CUTOFF, *cots)
    hargs = (x, mu, geo, FW, refs)
    bargs = (x, mu, geo, FW, cw, refs, CUTOFF, *cots)
    sargs = (x, mu, L["geo4"], FW, refs, *cots)
    eargs = (xmu, erbf, edir, FW, refs, *cots)
    cargs = (cx, crbf, cdir, FW, crefs, *ccots)
    per_edge, gfw_edge = 6 * F * (B + 1) + 16 * F, 6 * F * (B + 1)
    fwd, gfw = ni * per_edge, ni * gfw_edge

    def bwd(name, src, replaces, kern, plain, args, inputs, flops, wflops):
        return case(name, src, replaces, lambda: kern(*args),
                    lambda: plain(*args)[:3], inputs, flops,
                    wgrad={"kern": lambda: kern(*args, wgrad=True),
                           "plain": lambda: plain(*args),
                           "ref64": f64(plain, *args), "flops": wflops,
                           "norm_from": 3}) | {"ref64": f64(plain, *args,
                                                            n=3)}

    def fwd_case(name, src, replaces, kern, plain, args, inputs, flops):
        return case(name, src, replaces, lambda: kern(*args),
                    lambda: plain(*args), inputs, flops) | {
            "ref64": f64(plain, *args)}

    gsrc = "colblock_message_gen.cu"
    out = [
        fwd_case("msg_fwd_gen", gsrc, "colblock_pallas.py:1889",
                 msg.msg_fwd_kernel, msg.msg_fwd_plain, margs[:8],
                 (x, mu, R, FW, coff, cw, idx), fwd + ne * geo_flops(B)),
        bwd("msg_bwd_gen", gsrc, "colblock_pallas.py:1239",
            msg.msg_bwd_kernel, msg.msg_bwd_plain, margs,
            (x, mu, R, FW, coff, cw, idx, *cots),
            2 * fwd + 2 * ne * geo_flops(B),
            2 * fwd + 2 * ne * geo_flops(B) + gfw),
        fwd_case("msg_fwd_geo_gen", gsrc, "colblock_pallas.py:687",
                 msg.msg_fwd_geo_kernel, msg.msg_fwd_geo_plain, hargs,
                 (x, mu, geo, FW, idx), fwd),
        bwd("msg_bwd_geores_gen", gsrc, "colblock_pallas.py:1570",
            msg.msg_bwd_geores_kernel, msg.msg_bwd_geores_plain, bargs,
            (x, mu, geo, FW, cw, idx, *cots), 2 * fwd + ne * geo_flops(B),
            2 * fwd + ne * geo_flops(B) + gfw),
        bwd("msg_bwd_src_gen", gsrc, "colblock_pallas.py:834",
            msg.msg_bwd_src_kernel, msg.msg_bwd_src_plain, sargs,
            (x, mu, L["geo4"], FW, idx, *cots), 2 * ne * per_edge,
            2 * ne * per_edge + ne * gfw_edge),
        fwd_case("msg_fwd_edge_gen", gsrc, "colblock_pallas.py:322",
                 edge.msg_fwd_edge_kernel, edge.msg_fwd_edge_plain,
                 eargs[:5], (xmu, erbf, edir, FW, idx), fwd),
        bwd("msg_bwd_edge_gen", gsrc, "colblock_pallas.py:391",
            edge.msg_bwd_edge_kernel, edge.msg_bwd_edge_plain, eargs,
            (xmu, erbf, edir, FW, idx, *cots), 2 * ne * per_edge,
            2 * ne * per_edge + ne * gfw_edge),
        fwd_case("cell_msg_fwd_gen", gsrc, "painn_fused.py:116",
                 pf.cell_msg_fwd_kernel, pf.cell_msg_fwd_plain, cargs[:5],
                 (cx, crbf, cdir, FW, crefs.qidx), cni * per_edge),
        bwd("cell_msg_bwd_gen", gsrc, "painn_fused.py:185",
            pf.cell_msg_bwd_kernel, pf.cell_msg_bwd_plain, cargs,
            (cx, crbf, cdir, FW, crefs.qidx, *ccots), 2 * cne * per_edge,
            2 * cne * per_edge + cne * gfw_edge),
    ]
    FX = 384 if F == 30 else F
    xargs = (rnd(Ap, FX, scale=1.0), rnd(Ap, 3 * FX), rnd(Ap, FX),
             rnd(Ap, 3 * FX), rnd(FX, 2 * FX, scale=FX ** -0.5),
             rnd(2 * FX, FX, scale=FX ** -0.5), rnd(FX, scale=0.1),
             rnd(FX, 3 * FX, scale=FX ** -0.5), rnd(3 * FX, scale=0.1),
             1e-8, "ssp")
    margs4 = (rnd(Ap, F, scale=1.0), mu, cots[0] * 0.3, cots[1] * 0.3,
              rnd(F, 2 * F, scale=F ** -0.5), rnd(2 * F, F, scale=F ** -0.5),
              rnd(F, scale=0.1), rnd(F, 3 * F, scale=F ** -0.5),
              rnd(3 * F, scale=0.1), 1e-8, "ssp", *cots)

    def mix_w(*a):
        return mix.painn_mixing_bwd_plain(*a, wgrad=True)

    out += [
        fwd_case("mix_fwd_gen", "painn_mixing_gen.cu", "painn_mixing.py:73",
                 mix.mix_fwd_kernel, mix.painn_mixing_plain, xargs,
                 xargs[:9], 22 * FX * FX * Ap) | {
            "tc_flops": 3 * 22 * FX * FX * Ap},
        case("mix_bwd_gen", "painn_mixing_gen.cu", "painn_mixing.py:83",
             lambda: mix.mix_bwd_kernel(*margs4),
             lambda: mix.painn_mixing_bwd_plain(*margs4),
             (margs4[:9], *cots), 42 * F * F * Ap,
             tc_flops=3 * 42 * F * F * Ap,
             wgrad={"kern": lambda: mix.mix_bwd_kernel(*margs4, wgrad=True),
                    "plain": lambda: mix_w(*margs4),
                    "ref64": f64(mix_w, *margs4), "flops": 64 * F * F * Ap,
                    "norm_from": 2}) | {
            "ref64": f64(mix.painn_mixing_bwd_plain, *margs4)},
    ]
    cargs2 = (rnd(Ap, F, scale=1.0), L["graw"],
              rnd(B, F, scale=(6.0 / (B + F)) ** 0.5), rnd(F, scale=0.1),
              rnd(F, F, scale=(3.0 / F) ** 0.5), rnd(F, scale=0.1), refs,
              rnd(Ap, F, scale=1.0))
    mlp = B * F + F * F

    def cf_fwd(*a):
        return (cf.cf_fwd_plain(*a),)

    out += [
        case("cf_fwd_gen", "schnet_columns_gen.cu", "schnet_columns.py:79",
             lambda: (cf.cf_fwd_kernel(*cargs2[:7]),),
             lambda: cf_fwd(*cargs2[:7]), (cargs2[:6], idx),
             2 * ni * mlp + 2 * ni * F, tc_flops=3 * 2 * ni * mlp) | {
            "ref64": f64(cf_fwd, *cargs2[:7])},
        case("cf_bwd_gen", "schnet_columns_gen.cu", "schnet_columns.py:145",
             lambda: cf.cf_bwd_kernel(*cargs2),
             lambda: cf.cf_bwd_plain(*cargs2)[:2],
             (cargs2[:6], idx, cargs2[7]), 4 * ne * mlp,
             tc_flops=3 * 4 * ne * mlp,
             wgrad={"kern": lambda: cf.cf_bwd_kernel(*cargs2, wgrad=True),
                    "plain": lambda: cf.cf_bwd_plain(*cargs2),
                    "ref64": f64(cf.cf_bwd_plain, *cargs2),
                    "flops": 6 * ne * mlp, "norm_from": 2}) | {
            "ref64": f64(cf.cf_bwd_plain, *cargs2, n=2)},
    ]
    for c in out:
        c["tag"] = f" (F = {FX if c['name'] == 'mix_fwd_gen' else F})"
    return out


def width_kernel_rows(system, sweep_layouts, seed, dev):
    """The general instances' rows: each held to its float64 twin and
    timed (per call, on the device, its bound) at the main path's shapes,
    F = 30 and B = 20 on the bench box ``system`` (K3's at F = 384), with
    a sub-row at F = WIDTH_WIDE on the sweep's box (``sweep_layouts``, a
    fifth of the bench box's rows: its float64 twins fit the card), the
    operations as phase 3 counts them.  K20/K21 in the wrap mode on the
    column layout (the slab path's bodies), K18/K19 on the 27-cell
    layout."""
    bench = width_layouts(system, dev)
    rows = check_kernels(width_cases(30, bench, seed, dev))
    for row, wide in zip(rows, check_kernels(width_cases(
            WIDTH_WIDE, sweep_layouts, seed, dev))):
        row[f"F{WIDTH_WIDE}"] = dict(
            sub_row(wide), box_rows=int(sweep_layouts["R"].shape[0]))
    F, B = WIDTH_PAPER
    paper = check_kernels(paper_cf_cases(bench, seed, dev))
    by_name = {r["name"]: r for r in rows}
    for p in paper:
        by_name[p["name"]][f"F{F}_B{B}"] = sub_row(p)

    def redesigned(name, tag, r, before=None):
        was = "" if before is None else f" (before {before:.4f})"
        floor = r.get("tf32x3_floor_ms")
        floor = "" if floor is None else f", 3xTF32 floor {floor:.4f} ms"
        print(f"redesigned {name} ({tag}): device {r['device_ms']:.4f} ms"
              f"{was}, per call {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} "
              f"ms{floor}, {r['device_ms'] / r['bound_ms']:.1f}x",
              flush=True)

    for name, ((f30, wide), (wf30, wwide)) in BEFORE_REDESIGN_MS.items():
        row = by_name[name]
        redesigned(name, "F = 30", row, f30)
        redesigned(name, f"F = {WIDTH_WIDE}", row[f"F{WIDTH_WIDE}"], wide)
        if wf30 is not None:
            redesigned(name, "F = 30 wgrad", row["wgrad"], wf30)
            redesigned(name, f"F = {WIDTH_WIDE} wgrad",
                       row[f"F{WIDTH_WIDE}"]["wgrad"], wwide)
    for p in paper:
        redesigned(p["name"], f"F = {F}, B = {B}", p)
        if "wgrad" in p:
            redesigned(p["name"], f"F = {F}, B = {B} wgrad", p["wgrad"])
    for F in WIDTH_TUNED:
        tuned, gen = general_at_tuned_width(bench, sweep_layouts, F, seed)
        print(f"general at a tuned width: msg_bwd (K2) F = {F}, B = 20: "
              f"tuned {tuned:.4f} ms, general {gen:.4f} ms (device), "
              f"{gen / tuned:.2f}x", flush=True)
    for F in CF_TUNED_WIDTHS:
        for name, (tuned, gen) in cfconv_general_at_tuned_width(
                bench, sweep_layouts, F, seed).items():
            print(f"general at a tuned width: {name} F = {F}, B = 20: "
                  f"tuned {tuned:.4f} ms, general {gen:.4f} ms (device), "
                  f"{gen / tuned:.2f}x", flush=True)
    return rows


def general_at_tuned_width(bench, small, F, seed):
    """K2's device ms at a width F the tuned body takes (B = 20) on the
    bench box's layout ``bench``: (tuned, general), the general instance
    run by turning the wrapper's dispatch to it, and held to the float64
    twin on the smaller layout ``small`` (``width_layouts``)."""
    from schnetpack_tpu_torch.ops import colblock_message as msg

    g = torch.Generator().manual_seed(seed + F)

    def args(L):
        R, dev = L["R"], L["R"].device
        Ap = R.shape[0]

        def rnd(*shape, scale=0.3):
            return (torch.randn(shape, generator=g) * scale).to(dev)

        return (rnd(Ap, 3 * F), rnd(Ap, 3 * F), R, rnd(21, 3 * F),
                L["coff"], L["cw"], L["refs"], CUTOFF, rnd(Ap, F, scale=1.0),
                rnd(Ap, 3 * F, scale=1.0))

    big, check = args(bench), args(small)
    assert msg.tuned_width(F, 20) and not msg.tuned_width(F + 1, 20)
    tuned = device_ms(lambda: msg.msg_bwd_kernel(*big))
    dispatch = msg._tuned_bwd
    msg._tuned_bwd = lambda *a, **k: False
    try:
        before = msg.LAUNCHES["msg_bwd_gen"]
        got = msg.msg_bwd_kernel(*check)
        gen = device_ms(lambda: msg.msg_bwd_kernel(*big))
        assert msg.LAUNCHES["msg_bwd_gen"] > before
    finally:
        msg._tuned_bwd = dispatch
    held_compare(f"msg_bwd_gen at tuned F = {F}", got,
                 msg.msg_bwd_plain(*check)[:3],
                 in_f64(msg.msg_bwd_plain, *check)[:3])
    return tuned, gen


def cfconv_general_at_tuned_width(bench, small, F, seed):
    """K9's and K10's device ms at a width F the tuned kernels take (B =
    20) on the bench box's layout ``bench``: {"cf_fwd (K9)": (tuned,
    general), "cf_bwd (K10)": ...}, the general instances run by turning
    the wrappers' dispatch to them, and held to the float64 twins on the
    smaller layout ``small`` (``width_layouts``).  The general K9 skips the
    slots with fcut = 0, the tuned one computes their exact zeros."""
    from schnetpack_tpu_torch.ops import schnet_columns as cf

    g = torch.Generator().manual_seed(seed + 2 * F)
    B = bench["B"]

    def args(L):
        dev = L["R"].device
        Ap = L["R"].shape[0]

        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=g) * scale).to(dev)

        return (rnd(Ap, F), L["graw"],
                rnd(B, F, scale=(6.0 / (B + F)) ** 0.5), rnd(F, scale=0.1),
                rnd(F, F, scale=(3.0 / F) ** 0.5), rnd(F, scale=0.1),
                L["refs"], rnd(Ap, F))

    big, check = args(bench), args(small)
    assert cf.tuned_width(F, B)
    # name: (kernel, plain version, counter of the general instance)
    ops = {"cf_fwd (K9)": (lambda a: (cf.cf_fwd_kernel(*a[:7]),),
                           lambda a: (cf.cf_fwd_plain(*a[:7]),),
                           "cf_fwd_gen"),
           "cf_bwd (K10)": (lambda a: cf.cf_bwd_kernel(*a),
                            lambda a: cf.cf_bwd_plain(*a)[:2], "cf_bwd_gen")}
    tuned = {k: device_ms(lambda: kern(big))
             for k, (kern, _, _) in ops.items()}
    dispatch = cf.tuned_width
    cf.tuned_width = lambda F, B: False
    try:
        before = {k: cf.LAUNCHES[c] for k, (_, _, c) in ops.items()}
        got = {k: kern(check) for k, (kern, _, _) in ops.items()}
        gen = {k: device_ms(lambda: kern(big))
               for k, (kern, _, _) in ops.items()}
        assert all(cf.LAUNCHES[c] > before[k] for k, (_, _, c) in ops.items())
    finally:
        cf.tuned_width = dispatch
    for k, (_, plain, c) in ops.items():
        held_compare(f"{c} at tuned F = {F}", got[k], plain(check),
                     in_f64(lambda *a: plain(a), *check))
    return {k: (tuned[k], gen[k]) for k in ops}


def paper_cf_cases(L, seed, dev):
    """cf_fwd_gen's and cf_bwd_gen's ``case``s at the SchNet paper's (F, B)
    = WIDTH_PAPER on the layout ``L`` (``width_layouts``), its raw-phi
    geometry at B Gaussians, held to their float64 twins."""
    from schnetpack_tpu_torch.ops import colblock_geo as geo_op
    from schnetpack_tpu_torch.ops import schnet_columns as cf
    from schnetpack_tpu_torch.ops.radial import gaussian_rbf_table

    F, B = WIDTH_PAPER
    R, refs = L["R"], L["refs"]
    Ap = R.shape[0]
    cw = gaussian_rbf_table(B, CUTOFF, device=dev)
    graw = geo_op.geo_fwd_kernel(R, L["coff"], refs, cw, CUTOFF,
                                 with_d=False, raw_phi=True)
    g = torch.Generator().manual_seed(seed + 300)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    args = (rnd(Ap, F), graw, rnd(B, F, scale=(6.0 / (B + F)) ** 0.5),
            rnd(F, scale=0.1), rnd(F, F, scale=(3.0 / F) ** 0.5),
            rnd(F, scale=0.1), refs, rnd(Ap, F))
    mlp, ne = B * F + F * F, L["ne"]
    ni = live_edges(refs, graw[:, :, B] > 0)
    idx = (refs.qcol, refs.dcol)

    def fwd(*a):
        return (cf.cf_fwd_plain(*a),)

    tag = {"tag": f" (F = {F}, B = {B})"}
    return [
        case("cf_fwd_gen", "schnet_columns_gen.cu", "schnet_columns.py:79",
             lambda: (cf.cf_fwd_kernel(*args[:7]),),
             lambda: fwd(*args[:7]), (args[:6], idx),
             2 * ni * mlp + 2 * ni * F, tc_flops=3 * 2 * ni * mlp) | {
            "ref64": lambda: in_f64(fwd, *args[:7]), **tag},
        case("cf_bwd_gen", "schnet_columns_gen.cu", "schnet_columns.py:145",
             lambda: cf.cf_bwd_kernel(*args),
             lambda: cf.cf_bwd_plain(*args)[:2],
             (args[:6], idx, args[7]), 4 * ne * mlp,
             tc_flops=3 * 4 * ne * mlp,
             wgrad={"kern": lambda: cf.cf_bwd_kernel(*args, wgrad=True),
                    "plain": lambda: cf.cf_bwd_plain(*args),
                    "ref64": lambda: in_f64(cf.cf_bwd_plain, *args),
                    "flops": 6 * ne * mlp, "norm_from": 2}) | {
            "ref64": lambda: in_f64(cf.cf_bwd_plain, *args)[:2], **tag}]


def width_md_phase(pos, cell, seed, dev, launches):
    """Phase 17 (b)-(c): PaiNN-30x3 (full and hybrid) and SchNet-30x3
    through ``SchNetPackCalculator`` on the column layout against their
    JAX fixtures at phase 4's gates, then WIDTH_STEPS NVE steps each with
    the general instances' launches a step and the drift gate; SchNet-64x3
    at 300 Gaussians against its fixture; and WIDTH_SHORT steps each of
    PaiNN-30x3 on the row-9, 27-cell and slab paths, of PaiNN-384x1 (K3's
    general instance) and of PaiNN-30x3 in the mixed and bf16 modes (phase
    13's drift gate), which drive the other general instances; returns
    the launch counts and the ms/step of the three WIDTH_STEPS runs."""
    from schnetpack_tpu_torch.md import load_molecules

    for path, name in (("full", "painn_w30"), ("hybrid", "painn_w30"),
                       ("schnet", "schnet_w30"), ("schnet", "schnet_b300")):
        ref = np.load(WIDTH_REFERENCE[name])
        calc = calculator(*width_potential(path, name))
        system = load_molecules([molecule(ref["R"].astype(np.float64),
                                          ref["cell"])], device=dev)
        reset(launches)
        system = calc.calculate(system, calc.init_state(system))
        F = (system.forces[0] / calc.force_conversion).cpu().numpy()
        E = float(system.energy[0, 0]) / calc.energy_conversion
        rms = float(np.sqrt(np.mean((F - ref["forces"]) ** 2)))
        dE = abs(E - float(ref["energy"])) / abs(float(ref["energy"]))
        moved = sorted(k for k, v in read_counts(launches).items() if v)
        print(f"widths (b/c) reference ({name}, {path}): force rms err "
              f"{rms:.3e} eV/Ang (max {np.abs(F - ref['forces']).max():.3e},"
              f" |F| max {np.abs(ref['forces']).max():.3e}), energy "
              f"{E:.6f} vs {float(ref['energy']):.6f} eV (rel {dE:.2e}); "
              f"kernels {moved}", flush=True)
        assert np.isfinite(F).all() and F.shape == ref["forces"].shape
        assert rms <= FORCE_RMS_TOL, f"{name}: force rms {rms}"
        assert dE <= ENERGY_RTOL, f"{name}: energy rel err {dE}"
    total, ms_step = {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    for path, name in (("full", "painn_w30"), ("hybrid", "painn_w30"),
                       ("schnet", "schnet_w30")):
        _, F, B = width_tree(name)
        counts, ms_step[path] = md_phase(
            path, pos, cell, WIDTH_STEPS, seed, dev, launches,
            model=width_potential(path, name),
            per_step=gen_per_step(PER_STEP[path], F, B),
            drift_tol=WIDTH_DRIFT_TOL, tag=f" {name}")
        add(counts)
    for path in ("painn_trbf", "painn_cell"):
        counts, _ = md_phase(
            path, pos, cell, WIDTH_SHORT, seed, dev, launches,
            model=width_potential(path),
            per_step=gen_per_step(PER_STEP[path], 30, 20),
            drift_tol=WIDTH_DRIFT_TOL, tag=" painn_w30")
        add(counts)
    counts, _ = slab_md_phase(
        pos, cell, SLAB_CHUNK, seed, dev, launches,
        model=width_potential("painn_slab"),
        per_step=gen_per_step(PER_STEP["painn_slab"], 30, 20),
        drift_tol=WIDTH_DRIFT_TOL, tag=" painn_w30")
    add(counts)
    pot, params = wide_potential(seed)   # K3's general instance
    counts, _ = md_phase(
        "full", pos, cell, WIDTH_SHORT, seed, dev, launches,
        model=(pot, params),
        per_step=gen_per_step({k: v // 3 for k, v in PER_STEP["full"].items()},
                              WIDTH_K3, 20),
        drift_tol=WIDTH_DRIFT_TOL, tag=f" PaiNN-{WIDTH_K3}x1")
    add(counts)
    for path in ("full", "hybrid"):   # the reduced modes: phase 13's gate
        for precision in REDUCED:
            counts, _ = md_phase(
                path, pos, cell, WIDTH_SHORT, seed, dev, launches,
                precision=precision, model=width_potential(path),
                per_step=gen_per_step(PER_STEP[path], 30, 20),
                tag=" painn_w30")
            add(counts)
    return total, ms_step


def width_grad_launches(dev, launches):
    """The general wgrad instances on their main path: one energy
    parameter gradient of PaiNN-30x3 (full), SchNet-30x3 and PaiNN-30x3 on
    the slab path on the WIDTH_REFERENCE box; returns the launches
    (counts set to 0 just before each, read just after)."""
    from schnetpack_tpu_torch import properties as P
    from schnetpack_tpu_torch.md import load_molecules

    total = {}
    for path, name in (("full", "painn_w30"), ("schnet", "schnet_w30"),
                       ("painn_slab", "painn_w30")):
        ref = np.load(WIDTH_REFERENCE[name])
        pot, params = width_potential(path, name, forces=False)
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
        leaves = [p for _, p in pot.named_parameters()]
        reset(launches)
        E = pot(dict(inputs))[P.energy][0]
        grads = torch.autograd.grad(E, leaves)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts(launches).items() if v}
        print(f"widths (b) parameter gradient ({name}, {path}): launches "
              f"{counts}", flush=True)
        assert all(bool(torch.isfinite(t).all()) for t in grads)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    for k in ("mix_bwd_wgrad_gen", "cf_bwd_wgrad_gen",
              "msg_bwd_edge_wgrad_gen"):
        assert total.get(k, 0) > 0, f"{k} never ran"
    return total


def widths_phase(pos, cell, seed, dev, launches, smi):
    """Phase 17, every width on the card: (a) ``width_sweep``; the general
    instances' rows (``width_kernel_rows``); (b)-(c) ``width_md_phase``
    and ``width_grad_launches``.  Returns (rows, launch counts, wgrad
    launch counts)."""
    from schnetpack_tpu_torch.md import load_molecules

    t0 = time.perf_counter()
    reduced, sweep_system = width_sweep(seed, dev)
    system = load_molecules([molecule(pos, cell)], device=dev)
    rows = width_kernel_rows(system, width_layouts(sweep_system, dev), seed,
                             dev)
    by_name = {r["name"]: r for r in rows}
    for name, subs in reduced.items():
        by_name[name].update(subs)
    for name, key in (("mix_bwd_gen", "mix_bwd_wgrad_gen"),
                      ("cf_bwd_gen", "cf_bwd_wgrad_gen"),
                      ("msg_bwd_edge_gen", "msg_bwd_edge_wgrad_gen")):
        by_name[name]["wgrad"]["launch_key"] = key
    print(f"widths: the rows took {time.perf_counter() - t0:.1f} s",
          flush=True)
    total, ms_step = width_md_phase(pos, cell, seed, dev, launches)
    wgrad = width_grad_launches(dev, launches)
    print(f"widths: md ms/step PaiNN-30x3 full {ms_step['full']:.3f}, "
          f"hybrid {ms_step['hybrid']:.3f}, SchNet-30x3 "
          f"{ms_step['schnet']:.3f}; phase 17 took "
          f"{time.perf_counter() - t0:.1f} s; {smi}", flush=True)
    return rows, total, wgrad


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
          f"again (lost kernels), {TRACES['estimated']} estimated",
          flush=True)
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
    t13 = time.perf_counter()
    for k, v in precision_phase(pos, cell, args.seed, dev, launches,
                                smi).items():
        total[k] = total.get(k, 0) + v
    print(f"precision phase: {time.perf_counter() - t13:.1f} s", flush=True)
    interfaces_phase(args.seed, dev, launches, smi)
    for k, v in engine_phase(pos, cell, args.seed, dev, launches,
                             smi).items():
        total[k] = total.get(k, 0) + v
    parallel_phase(pos, cell, args.seed, dev, launches, smi)
    width_rows, counts, width_wgrad = widths_phase(pos, cell, args.seed, dev,
                                                   launches, smi)
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    for k, v in width_wgrad.items():
        wgrad_launches[k] = wgrad_launches.get(k, 0) + v
    rows += width_rows
    for row in rows:
        row["launches"] = total[row["name"]]
        assert row["launches"] > 0, f"{row['name']} never ran in the MD"
        for precision in REDUCED:
            if precision in row:   # a mixed or bf16 instance's sub-row
                key = f"{row['name']}_{precision}"
                row[precision]["launches"] = total[key]
                assert total[key] > 0, f"{key} never ran in the MD"
        key = row.get("wgrad", {}).pop("launch_key",
                                       row["name"] + "_wgrad")
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
