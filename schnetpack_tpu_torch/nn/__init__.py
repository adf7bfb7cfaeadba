from .base import MLP, Dense
from .cutoff import CosineCutoff, MollifierCutoff, SwitchFunction
from .radial import BesselRBF, GaussianRBF, GaussianRBFCentered

__all__ = ["BesselRBF", "CosineCutoff", "Dense", "GaussianRBF",
           "GaussianRBFCentered", "MLP", "MollifierCutoff", "SwitchFunction"]
