from .painn import PaiNN

__all__ = ["PaiNN"]
