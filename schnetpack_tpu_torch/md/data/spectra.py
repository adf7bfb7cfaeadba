"""Vibrational spectra from MD trajectories.

Parity: ``schnetpack_tpu/md/data/spectra.py`` (numpy) — autocorrelation via
FFT, Hann window, cosine transform; ``PowerSpectrum`` (velocity
autocorrelation / VDOS), ``IRSpectrum`` (dipole derivative), and
``RamanSpectrum`` (polarizability derivative with isotropic/anisotropic
components, laser frequency and depolarization ratio).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ...units import md_units
from .hdf5 import HDF5Loader


def fft_autocorrelation(x: np.ndarray, n_lags: int) -> np.ndarray:
    """Normalized autocorrelation of a 1-D series via FFT."""
    n = len(x)
    x = x - x.mean()
    f = np.fft.fft(x, n=2 * n)
    acf = np.fft.ifft(f * np.conj(f))[:n_lags].real
    if acf[0] != 0:
        acf = acf / acf[0]
    return acf


def _spectrum_from_autocorrelation(acf: np.ndarray, time_step_internal: float):
    """Windowed cosine transform -> (frequencies [cm^-1], intensities)."""
    n = len(acf)
    window = np.hanning(2 * n)[n:]
    data = np.zeros(2 * n)
    data[:n] = acf * window
    intensities = np.abs(np.fft.rfft(data))
    # frequency axis: internal time -> cm^-1
    md = md_units()
    dt = time_step_internal
    freq = np.fft.rfftfreq(2 * n, d=dt)  # cycles per internal time
    # omega = 2 pi f; E = hbar omega; wavenumber = E / (invcm in internal units)
    from ...units import invcm

    icm = invcm * md.energy
    wavenumbers = md.hbar * 2.0 * np.pi * freq / icm
    return wavenumbers, intensities


class VibrationalSpectrum:
    def __init__(self, data: HDF5Loader, resolution: int = 4096):
        self.data = data
        self.resolution = resolution
        self.frequencies: List[np.ndarray] = []
        self.intensities: List[np.ndarray] = []

    def _series(self, mol_idx: int) -> List[np.ndarray]:
        raise NotImplementedError

    def _process(self, specs: List[np.ndarray], freq: np.ndarray) -> List[np.ndarray]:
        return specs

    def compute_spectrum(self, molecule_idx: int = 0):
        series = self._series(molecule_idx)
        n_lags = min(self.resolution, series[0].shape[0] - 1)
        specs = []
        freq = None
        for comp in series:
            # sum autocorrelations over the component's trailing dims
            flat = comp.reshape(comp.shape[0], -1)
            acf = np.zeros(n_lags)
            for k in range(flat.shape[1]):
                acf += fft_autocorrelation(flat[:, k], n_lags)
            freq, inten = _spectrum_from_autocorrelation(acf, self.data.time_step)
            specs.append(inten)
        specs = self._process(specs, freq)
        self.frequencies = [freq] * len(specs)
        self.intensities = specs

    def get_spectrum(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        return list(zip(self.frequencies, self.intensities))


class PowerSpectrum(VibrationalSpectrum):
    """VDOS from the velocity autocorrelation (parity: spectra.py:60-130)."""

    def _series(self, mol_idx):
        v = self.data.get("velocities", mol_idx=mol_idx)
        return [v]


class IRSpectrum(VibrationalSpectrum):
    """IR spectrum from the dipole-moment time derivative
    (parity: spectra.py:133-240)."""

    def __init__(self, data: HDF5Loader, resolution: int = 4096,
                 dipole_moment_handle: str = "dipole_moment"):
        super().__init__(data, resolution)
        self.handle = dipole_moment_handle

    def _series(self, mol_idx):
        mu = self.data.get(self.handle, mol_idx=mol_idx)
        dmu = np.gradient(mu, axis=0) / self.data.time_step
        return [dmu]


class RamanSpectrum(VibrationalSpectrum):
    """Raman spectra from polarizability derivatives
    (parity: spectra.py:243-458): isotropic + anisotropic components, laser
    frequency weighting, optional depolarized spectrum."""

    def __init__(
        self,
        data: HDF5Loader,
        incident_frequency: float,  # cm^-1 laser line
        temperature: float = 300.0,
        polarizability_handle: str = "polarizability",
        resolution: int = 4096,
        averaged: bool = False,
    ):
        super().__init__(data, resolution)
        self.incident_frequency = incident_frequency
        self.temperature = temperature
        self.handle = polarizability_handle
        self.averaged = averaged

    def _series(self, mol_idx):
        alpha = self.data.get(self.handle, mol_idx=mol_idx)  # [T, 3, 3]
        dalpha = np.gradient(alpha, axis=0) / self.data.time_step
        iso = np.trace(dalpha, axis1=1, axis2=2) / 3.0  # [T]
        delta = dalpha - iso[:, None, None] * np.eye(3)
        # anisotropic invariant components
        aniso = np.stack(
            [
                delta[:, 0, 0], delta[:, 1, 1], delta[:, 2, 2],
                np.sqrt(2.0) * delta[:, 0, 1],
                np.sqrt(2.0) * delta[:, 0, 2],
                np.sqrt(2.0) * delta[:, 1, 2],
            ],
            axis=1,
        )
        return [iso[:, None], aniso]

    def _process(self, specs, freq):
        # frequency/temperature-dependent Raman cross-section
        # (parity: reference spectra.py:430-446): (nu_in - nu)^4 / nu
        # weighted by the Bose occupation factor 1/(1 - exp(-h c nu / kB T)).
        # The Bose argument h c nu / kB T is frame-independent:
        # nu[cm^-1] * (1 cm^-1 in ASE energy) / (kB[ASE] * T).
        from ... import units as U

        with np.errstate(divide="ignore", invalid="ignore"):
            x = freq * U.invcm / (U.kB * self.temperature)
            cross = (self.incident_frequency - freq) ** 4 / freq / (1.0 - np.exp(-x))
        cross[0] = 0.0
        specs = [s * cross for s in specs]
        iso, aniso = specs
        parallel = iso + 4.0 / 45.0 * aniso
        orthogonal = aniso / 15.0
        if self.averaged:
            return [parallel + 2.0 * orthogonal]
        return [parallel, orthogonal]
