from .xyz import (
    format_extxyz_frame, parse_extxyz_blocks, read_extxyz_file, symbol_to_z,
    write_extxyz, z_to_symbol,
)

__all__ = ["format_extxyz_frame", "parse_extxyz_blocks", "read_extxyz_file",
           "symbol_to_z", "write_extxyz", "z_to_symbol"]
