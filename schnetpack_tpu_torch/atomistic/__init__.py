from .atomwise import Atomwise
from .distances import PairwiseDistances
from .response import Forces

__all__ = ["Atomwise", "Forces", "PairwiseDistances"]
