from .base import MLP, Dense

__all__ = ["Dense", "MLP"]
