"""Datasets: extxyz files, and the MD17/rMD17/MD22 data modules that build
their database from a raw file (port of ``schnetpack_tpu/datasets``; QM9
and the others of ``misc.py`` are not ported yet)."""
from .base import DownloadableDataModule
from .md17 import MD17, MD22, GDMLDataModule, rMD17
from .xyz import (
    format_extxyz_frame, parse_extxyz_blocks, read_extxyz_file, symbol_to_z,
    write_extxyz, z_to_symbol,
)

__all__ = ["DownloadableDataModule", "GDMLDataModule", "MD17", "MD22",
           "rMD17", "format_extxyz_frame", "parse_extxyz_blocks",
           "read_extxyz_file", "symbol_to_z", "write_extxyz", "z_to_symbol"]
