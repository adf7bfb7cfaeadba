from .painn import PaiNN
from .schnet import SchNet
from .so3net import SO3net

__all__ = ["PaiNN", "SchNet", "SO3net"]
