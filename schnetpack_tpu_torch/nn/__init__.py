from .base import MLP, Dense, Residual, ResidualMLP
from .cutoff import CosineCutoff, MollifierCutoff, SwitchFunction
from .embedding import (
    ElectronicEmbedding, NuclearEmbedding, electron_config_matrix,
)
from .equivariant import (
    GatedEquivariantBlock, GatedEquivariantMLP, build_gated_equivariant_mlp,
)
from .radial import BesselRBF, GaussianRBF, GaussianRBFCentered

__all__ = ["BesselRBF", "CosineCutoff", "Dense", "ElectronicEmbedding",
           "GatedEquivariantBlock", "GatedEquivariantMLP", "GaussianRBF",
           "GaussianRBFCentered", "MLP", "MollifierCutoff",
           "NuclearEmbedding", "Residual", "ResidualMLP", "SwitchFunction",
           "build_gated_equivariant_mlp", "electron_config_matrix"]
