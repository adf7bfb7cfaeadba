from .base import MDCalculator, PairwiseMDCalculator
from .lj import LJCalculator
from .schnetpack_calculator import EnsembleCalculator, SchNetPackCalculator
from .spcfw import SPCFwCalculator

__all__ = ["EnsembleCalculator", "LJCalculator", "MDCalculator",
           "PairwiseMDCalculator", "SPCFwCalculator", "SchNetPackCalculator"]
