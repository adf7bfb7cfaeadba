"""Where the time of the port's MD step goes, on one GPU.

Sets up one MD run of ``chip_smoke.py`` (10,976-atom FCC argon box, the
trained model of the path: PaiNN-128x3 with the ``full`` or ``hybrid``
message form, SchNet-128x3, SO3net-64x3, or PaiNN-128x3 with a trainable
Gaussian basis on the row-9 path (``painn_trbf``); column neighbor list with a
0.6 A skin, 30 K), warms up and retightens the capacities, then traces
STEPS steps with ``torch.profiler`` and prints, per step: CUDA-event time,
device-busy time (sum of kernel times), idle share, and device time by
kernel name.  The
full table goes to ``chiprun_out/profile_port_md_<path>.txt``.  Run from
the repository root:

    python3 scripts/profile_port_md.py [--steps 20] [--path full]
"""
import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--path", default="full",
                    choices=("full", "hybrid", "schnet", "so3net",
                             "painn_trbf"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_port_md: no CUDA device")
    import chip_smoke as cs
    from schnetpack_tpu_torch.md import (
        MaxwellBoltzmannInit, Simulator, VelocityVerlet, load_molecules,
    )
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    pos, cell = cs.fcc_box(10_000)
    pot, params = cs.potential(args.path)
    calc = cs.calculator(pot, params)
    system = load_molecules([cs.molecule(pos, cell)], device=dev)
    system = MaxwellBoltzmannInit(30.0).initialize_system(
        system, torch.Generator().manual_seed(1))
    sim = Simulator(system, VelocityVerlet(0.5), calc)
    sim.simulate(100, chunk_size=100)
    calc.nbl.retighten(sim.system, jitter_fraction=0.05,
                       bucket_headroom=1.0 / 24.0)
    sim.calc_state = calc.nbl.state()
    sim.simulate(10, chunk_size=10)

    n = args.steps
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start.record()
        sim.simulate(n, chunk_size=n)
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3 / n
    table = prof.key_averages().table(sort_by="device_time_total",
                                      row_limit=40)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_port_md_{args.path}.txt"),
              "w") as f:
        f.write(f"{smi}\nsteps {n}, Ktot {sum(calc.nbl._K)}, "
                f"dims {calc.nbl._layout.dims[:3]}\n{table}\n")
    print(f"card: {smi}; path {args.path}")
    print(f"step {step_ms:.3f} ms (CUDA events), device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / step_ms:.3f}, "
          f"Ktot {sum(calc.nbl._K)}")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:15]:
        print(f"  {e.device_time_total / 1e3 / n:8.3f} ms/step "
              f"{e.count // n:4d}/step  {e.key[:90]}")


if __name__ == "__main__":
    main()
