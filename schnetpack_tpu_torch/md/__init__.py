from .initial_conditions import Initializer, MaxwellBoltzmannInit, UniformInit
from .integrators import (
    NPTRingPolymer, NPTVelocityVerlet, RingPolymer, VelocityVerlet,
)
from .neighborlist_md import (
    AllPairsNeighborListMD, CellBlockNeighborListMD, DenseNeighborListMD,
)
from .simulator import Simulator
from .system import System, load_molecules

__all__ = ["AllPairsNeighborListMD", "CellBlockNeighborListMD",
           "DenseNeighborListMD", "Initializer", "MaxwellBoltzmannInit",
           "NPTRingPolymer", "NPTVelocityVerlet", "RingPolymer", "Simulator",
           "System", "UniformInit", "VelocityVerlet", "load_molecules"]
