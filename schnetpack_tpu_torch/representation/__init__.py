from .field_schnet import FieldSchNet
from .painn import PaiNN
from .schnet import SchNet
from .so3net import SO3net

__all__ = ["FieldSchNet", "PaiNN", "SchNet", "SO3net"]
