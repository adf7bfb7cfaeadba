from .painn import PaiNN
from .schnet import SchNet

__all__ = ["PaiNN", "SchNet"]
