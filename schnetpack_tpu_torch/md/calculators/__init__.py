from .schnetpack_calculator import SchNetPackCalculator

__all__ = ["SchNetPackCalculator"]
