from .base import NeuralNetworkPotential

__all__ = ["NeuralNetworkPotential"]
