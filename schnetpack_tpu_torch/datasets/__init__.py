"""Datasets: extxyz files, and the MD17/rMD17/MD22 data modules that build
their database from a raw file, and QM9 from its archive (port of
``schnetpack_tpu/datasets``; the others of ``misc.py`` are not ported
yet)."""
from .base import DownloadableDataModule
from .md17 import MD17, MD22, GDMLDataModule, rMD17
from .qm9 import QM9, parse_qm9_xyz
from .xyz import (
    format_extxyz_frame, parse_extxyz_blocks, read_extxyz_file, symbol_to_z,
    write_extxyz, z_to_symbol,
)

__all__ = ["DownloadableDataModule", "GDMLDataModule", "MD17", "MD22",
           "QM9", "format_extxyz_frame", "parse_extxyz_blocks",
           "parse_qm9_xyz", "read_extxyz_file", "rMD17", "symbol_to_z",
           "write_extxyz", "z_to_symbol"]
