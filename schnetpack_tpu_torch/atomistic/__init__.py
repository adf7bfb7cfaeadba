from .atomwise import Atomwise
from .response import Forces

__all__ = ["Atomwise", "Forces"]
