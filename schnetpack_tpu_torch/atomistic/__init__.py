from .atomwise import Aggregation, Atomwise, DipoleMoment, Polarizability
from .distances import FilterShortRange, PairwiseDistances
from .electrostatic import (
    CoulombPotential, DampedCoulombPotential, EnergyCoulomb, EnergyEwald,
)
from .nuclear_repulsion import ZBLRepulsionEnergy
from .response import Forces, Response, StaticExternalFields, Strain

__all__ = ["Aggregation", "Atomwise", "CoulombPotential",
           "DampedCoulombPotential", "DipoleMoment", "EnergyCoulomb",
           "EnergyEwald", "FilterShortRange", "Forces", "PairwiseDistances",
           "Polarizability", "Response", "StaticExternalFields", "Strain",
           "ZBLRepulsionEnergy"]
