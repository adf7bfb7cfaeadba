"""Where the power spectrum of ``chip_smoke.py``'s ``spkmd_water`` run
puts SPC/Fw's O-H stretch, on the CPU, with the JAX package.

Runs the JAX ``spkmd`` on the gate-5 NVT configuration
(``tests/test_gate5_water.py``: 8 waters in a 6.21 A box, SPC/Fw, NHC at
300 K with a 20 fs time constant, 0.5 fs, 600 steps, Maxwell-Boltzmann at
300 K) for three seeds, reads each trajectory with the JAX ``HDF5Loader``
and ``PowerSpectrum`` (resolution 4096, which the 600 frames cut to 599
lags), and prints the largest peak above 2,500 cm^-1 and the mean
temperature of the second half.  Run from the repository root (about a
minute per seed):

    JAX_PLATFORMS=cpu python3 scripts/water_spectrum_study.py
"""
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import water_box_xyz  # noqa: E402

BAND_FROM = 2500.0   # cm^-1: above the bend (~1,600) and the librations


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from schnetpack_tpu.md.cli import main as spkmd_main
    from schnetpack_tpu.md.data import HDF5Loader, PowerSpectrum

    for seed in (42, 0, 1):
        with tempfile.TemporaryDirectory() as tmp:
            xyz = os.path.join(tmp, "water.xyz")
            water_box_xyz(xyz)
            sim_dir = os.path.join(tmp, "nvt")
            spkmd_main([
                f"system.molecule_file={xyz}", f"simulation_dir={sim_dir}",
                "calculator=spcfw", "dynamics=nvt",
                "dynamics.thermostat.temperature_bath=300.0",
                "dynamics.thermostat.time_constant=20.0",
                "dynamics.n_steps=600", "dynamics.chunk_size=100",
                "dynamics.integrator.time_step=0.5",
                "system.initializer.temperature=300.0", f"seed={seed}"])
            data = HDF5Loader(os.path.join(sim_dir, "simulation.hdf5"))
            T = np.asarray(data.get_temperature()).reshape(-1)
            spec = PowerSpectrum(data, resolution=4096)
            spec.compute_spectrum(0)
            (freq, inten), = spec.get_spectrum()
            data.close()
        hi = freq > BAND_FROM
        peak = float(freq[hi][np.argmax(inten[hi])])
        print(f"seed {seed}: largest peak above {BAND_FROM:.0f} cm^-1 at "
              f"{peak:.1f} cm^-1 (bins of {freq[1]:.1f} cm^-1), mean T of "
              f"the second half {T[len(T) // 2:].mean():.1f} K", flush=True)


if __name__ == "__main__":
    main()
