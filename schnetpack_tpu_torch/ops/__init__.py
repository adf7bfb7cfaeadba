"""Tensor ops: layout builder, plain twins and the CUDA kernel wrappers."""
