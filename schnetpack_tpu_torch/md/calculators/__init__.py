from .base import MDCalculator, PairwiseMDCalculator
from .lj import LJCalculator
from .schnetpack_calculator import SchNetPackCalculator

__all__ = ["LJCalculator", "MDCalculator", "PairwiseMDCalculator",
           "SchNetPackCalculator"]
