"""Where the time of the port's MD step goes, on one GPU.

Sets up one MD run of ``chip_smoke.py`` (10,976-atom FCC argon box, the
trained model of the path: PaiNN-128x3 with the ``full`` or ``hybrid``
message form, SchNet-128x3, SO3net-64x3, or PaiNN-128x3 with a trainable
Gaussian basis on the row-9 path (``painn_trbf``), FieldSchNet-128x5
(``field_schnet``), or PaiNN-128x3 on the
27-cell atom layout (``painn_cell``); column or, for painn_cell, atom
neighbor list with a 0.6 A skin, 30 K), warms up and retightens the
capacities, then traces STEPS steps with ``torch.profiler`` and prints,
per step: CUDA-event time, device-busy time (sum of kernel times), idle
share, the host rebuilds in the window, the peak device memory, the
host's work (the main thread's CPU time, the aten ops it called, the
kernel launches it made and the device ops that ran), and device time by
kernel name (also at the head of the table it writes).  Then it times ``--plain STEPS`` more steps
without the profiler: CUDA-event time and the main thread's CPU time per
step.  ``--root DIR`` runs the package of another tree (e.g. an archive
of a parent commit unpacked under ``_scratch/``) with this script and
this repository's ``chip_smoke.py``, for an A/B inside one call.
``painn_rpmd`` runs ``chip_smoke.py``'s ring polymer: PaiNN-128x3
(``full``) on 8 beads of the box, ``RingPolymer`` at 30 K, NVE, with a
20-step warm-up.  ``painn_slab`` (PaiNN-128x3 on the slab path) runs the port's
``SpatialColumnSimulator`` instead: a 50-step warm-up chunk, then one
traced chunk of STEPS steps, timed without its host re-bin.
The full table goes to ``chiprun_out/profile_port_md_<path>.txt``.  Run from
the repository root:

    python3 scripts/profile_port_md.py [--steps 20] [--plain 300] \
        [--path full] [--root DIR]
"""
import argparse
import os
import time

from kernel_timing import ROOT, open_tree

#: the host's calls that launch a kernel (runtime and driver API)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--plain", type=int, default=300, metavar="STEPS",
                    help="steps timed after the trace, without profiler")
    ap.add_argument("--root", default=ROOT,
                    help="the tree whose package runs")
    ap.add_argument("--path", default="full",
                    choices=("full", "hybrid", "schnet", "so3net",
                             "painn_trbf", "painn_cell", "painn_slab",
                             "field_schnet", "painn_rpmd"))
    args = ap.parse_args()
    torch, cs, smi = open_tree(args, "profile_port_md", {})
    from schnetpack_tpu_torch.md import (
        MaxwellBoltzmannInit, RingPolymer, Simulator, VelocityVerlet,
        load_molecules,
    )
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    pos, cell = cs.fcc_box(10_000)
    if args.path == "painn_slab":
        return profile_slab(cs, pos, cell, args, smi, dev)
    rpmd = args.path == "painn_rpmd"
    pot, params = cs.potential("full" if rpmd else args.path)
    calc = cs.calculator(pot, params, layout=cs.layout_of(args.path))
    system = load_molecules([cs.molecule(pos, cell)],
                            n_replicas=cs.N_BEADS if rpmd else 1, device=dev)
    system = MaxwellBoltzmannInit(30.0).initialize_system(
        system, torch.Generator().manual_seed(1))
    integrator = (RingPolymer(0.5, cs.N_BEADS, cs.T_BATH) if rpmd
                  else VelocityVerlet(0.5))
    sim = Simulator(system, integrator, calc)
    sim.simulate(20 if rpmd else 100, chunk_size=100)
    calc.nbl.retighten(sim.system, jitter_fraction=0.05,
                       bucket_headroom=1.0 / 24.0)
    sim.calc_state = calc.nbl.state()
    sim.simulate(10, chunk_size=10)

    n = args.steps
    builds0 = (calc.nbl.n_builds, calc.nbl.build_seconds)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        cpu0 = time.thread_time()
        start.record()
        sim.simulate(n, chunk_size=n)
        end.record()
        torch.cuda.synchronize()
        cpu_ms = 1e3 * (time.thread_time() - cpu0) / n
    step_ms = start.elapsed_time(end) / n
    host_builds = calc.nbl.n_builds - builds0[0]
    host_s = calc.nbl.build_seconds - builds0[1]
    layout = cs.layout_str(calc.nbl.state())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lines = report(prof, n, step_ms, cpu_ms, f"{layout}, host builds "
                   f"{host_builds} ({host_s:.3f} s), peak device memory "
                   f"{peak:.2f} GiB", args.path, smi, args.root)
    if args.plain:
        torch.cuda.synchronize()
        cpu0 = time.thread_time()
        start.record()
        sim.simulate(args.plain, chunk_size=args.plain)
        end.record()
        torch.cuda.synchronize()
        plain(lines, args, start.elapsed_time(end),
              time.thread_time() - cpu0,
              f"host builds {calc.nbl.n_builds - builds0[0] - host_builds}")
    write(lines, args.path)


def plain(lines, args, ms, cpu_s, note):
    """Add (and print) the unprofiled window's step and host CPU times."""
    n = args.plain
    line = (f"unprofiled: step {ms / n:.3f} ms (CUDA events, {n} steps), "
            f"host CPU {1e3 * cpu_s / n:.3f} ms/step (main thread), {note} "
            f"(tree {args.root})")
    lines.insert(3, line)
    print(line, flush=True)


def report(prof, n, step_ms, cpu_ms, note, path, smi, root):
    """Print the step's device time by kernel and the host's work per
    step; returns the lines, for the table ``write`` puts under them."""
    import torch

    averages = prof.key_averages()
    events = [e for e in averages
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3 / n
    launches = sum(e.count for e in averages if e.key in LAUNCH_CALLS)
    aten = sum(e.count for e in averages if e.key.startswith("aten::"))
    lines = [f"card: {smi}; path {path}; tree {root}",
             f"step {step_ms:.3f} ms (CUDA events), device busy "
             f"{busy_ms:.3f} ms, idle share {1 - busy_ms / step_ms:.3f}, "
             f"{note}",
             f"host per step: CPU {cpu_ms:.3f} ms (main thread, profiled), "
             f"{aten / n:.1f} aten ops, {launches / n:.1f} kernel launches, "
             f"{sum(e.count for e in events) / n:.1f} device ops"]
    lines += [f"  {e.device_time_total / 1e3 / n:8.3f} ms/step "
              f"{e.count // n:4d}/step  {e.key[:90]}"
              for e in sorted(events, key=lambda e: -e.device_time_total)[:15]]
    print("\n".join(lines), flush=True)
    lines.append(f"steps {n}\n" + averages.table(
        sort_by="device_time_total", row_limit=40))
    return lines


def write(lines, path):
    """The report and the profiler's table, to chiprun_out/."""
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_port_md_{path}.txt"),
              "w") as f:
        f.write("\n".join(lines) + "\n")


def profile_slab(cs, pos, cell, args, smi, dev):
    """One traced chunk of the slab path's simulator; the step time is the
    chunk's CUDA-event time over its steps (``chunk_ms``), without the host
    re-bin before it (its wall seconds printed apart, its few copies to
    the card in the device time)."""
    from torch.profiler import ProfilerActivity, profile

    n = args.steps
    sim = cs.slab_simulator(pos, cell, dev)
    cs.slab_momenta(sim, 0)
    sim.simulate(50, chunk_size=50)
    host0 = sim.host_seconds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cpu0 = time.thread_time()
        sim.simulate(n, chunk_size=n)
        cpu_ms = 1e3 * (time.thread_time() - cpu0) / n
    lay = sim.layout()
    lines = report(prof, n, sim.chunk_ms[-1] / n, cpu_ms,
                   f"dims={lay.dims[:3]} Ktot={lay.qcol.shape[2]}, host "
                   f"re-bin {sim.host_seconds - host0:.3f} s (not in the "
                   "step; its CPU time is)", "painn_slab", smi, args.root)
    if args.plain:
        host0 = sim.host_seconds
        cpu0 = time.thread_time()
        sim.simulate(args.plain, chunk_size=args.plain)
        plain(lines, args, sim.chunk_ms[-1], time.thread_time() - cpu0,
              f"host re-bin {sim.host_seconds - host0:.3f} s (not in the "
              "step; its CPU time is)")
    write(lines, "painn_slab")


if __name__ == "__main__":
    main()
