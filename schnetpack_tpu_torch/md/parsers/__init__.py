from .orca_parser import OrcaHessianFileParser, OrcaMainFileParser, OrcaParser

__all__ = ["OrcaHessianFileParser", "OrcaMainFileParser", "OrcaParser"]
