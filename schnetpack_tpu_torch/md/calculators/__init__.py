from .base import MDCalculator, PairwiseMDCalculator
from .lj import LJCalculator
from .orca import OrcaCalculator
from .schnetpack_calculator import EnsembleCalculator, SchNetPackCalculator
from .spcfw import SPCFwCalculator

__all__ = ["EnsembleCalculator", "LJCalculator", "MDCalculator",
           "OrcaCalculator", "PairwiseMDCalculator", "SPCFwCalculator",
           "SchNetPackCalculator"]
