"""Inference interfaces on the port (parity: ``schnetpack_tpu/interfaces``):
the ASE calculators and driver, batchwise relaxation, the import of
reference-trained models, and (``interfaces.lammps``) the LAMMPS model
server."""
from .ase_interface import (
    AbsoluteUncertainty,
    AseInterface,
    AtomsConverter,
    RelativeUncertainty,
    SpkCalculator,
    SpkEnsembleCalculator,
)
from .torch_import import import_painn, import_schnet, import_torch_model
from .batchwise import (
    ASEBatchwiseLBFGS,
    BatchwiseCalculator,
    BatchwiseEnsembleCalculator,
    batchwise_lbfgs,
)

__all__ = [
    "AbsoluteUncertainty", "AseInterface", "AtomsConverter",
    "RelativeUncertainty", "SpkCalculator", "SpkEnsembleCalculator",
    "ASEBatchwiseLBFGS", "BatchwiseCalculator", "BatchwiseEnsembleCalculator",
    "batchwise_lbfgs",
    "import_painn", "import_schnet", "import_torch_model",
]
