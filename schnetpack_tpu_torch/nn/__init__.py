from .base import MLP, Dense, Residual, ResidualMLP
from .cutoff import CosineCutoff, MollifierCutoff, SwitchFunction
from .embedding import (
    ElectronicEmbedding, NuclearEmbedding, electron_config_matrix,
)
from .radial import BesselRBF, GaussianRBF, GaussianRBFCentered

__all__ = ["BesselRBF", "CosineCutoff", "Dense", "ElectronicEmbedding",
           "GaussianRBF", "GaussianRBFCentered", "MLP", "MollifierCutoff",
           "NuclearEmbedding", "Residual", "ResidualMLP", "SwitchFunction",
           "electron_config_matrix"]
