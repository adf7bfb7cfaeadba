from .initial_conditions import MaxwellBoltzmannInit, UniformInit
from .integrators import RingPolymer, VelocityVerlet
from .neighborlist_md import CellBlockNeighborListMD
from .simulator import Simulator
from .system import System, load_molecules

__all__ = ["CellBlockNeighborListMD", "MaxwellBoltzmannInit", "RingPolymer",
           "Simulator", "System", "UniformInit", "VelocityVerlet",
           "load_molecules"]
