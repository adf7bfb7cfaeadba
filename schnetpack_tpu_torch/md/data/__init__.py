from .hdf5 import HDF5Loader
from .spectra import (
    IRSpectrum, PowerSpectrum, RamanSpectrum, VibrationalSpectrum,
    fft_autocorrelation,
)
from .store import open_store

__all__ = [
    "HDF5Loader", "IRSpectrum", "PowerSpectrum", "RamanSpectrum",
    "VibrationalSpectrum", "fft_autocorrelation", "open_store",
]
