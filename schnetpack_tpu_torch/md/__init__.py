from .initial_conditions import MaxwellBoltzmannInit
from .integrators import VelocityVerlet
from .neighborlist_md import CellBlockNeighborListMD
from .simulator import Simulator
from .system import System, load_molecules

__all__ = ["CellBlockNeighborListMD", "MaxwellBoltzmannInit", "Simulator",
           "System", "VelocityVerlet", "load_molecules"]
