"""Datasets: extxyz files, the MD17/rMD17/MD22 data modules that build
their database from a raw file, QM9 from its archive, and ISO17, ANI-1,
QM7-X, the Materials Project, OMDB and tmQM from theirs (port of
``schnetpack_tpu/datasets``)."""
from .base import DownloadableDataModule
from .md17 import MD17, MD22, GDMLDataModule, rMD17
from .misc import (
    ANI1, ISO17, QM7X, TMQM, MaterialsProject, OrganicMaterialsDatabase,
)
from .qm9 import QM9, parse_qm9_xyz
from .xyz import (
    format_extxyz_frame, parse_extxyz_blocks, read_extxyz_file, symbol_to_z,
    write_extxyz, z_to_symbol,
)

__all__ = ["ANI1", "DownloadableDataModule", "GDMLDataModule", "ISO17",
           "MD17", "MD22", "MaterialsProject", "OrganicMaterialsDatabase",
           "QM7X", "QM9", "TMQM", "format_extxyz_frame", "parse_extxyz_blocks",
           "parse_qm9_xyz", "read_extxyz_file", "rMD17", "symbol_to_z",
           "write_extxyz", "z_to_symbol"]
