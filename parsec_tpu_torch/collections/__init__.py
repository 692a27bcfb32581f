"""Data collections & distributions (SURVEY.md §2.6)."""
from .collection import DataCollection, DictCollection, LocalArrayCollection
from .matrix import (SymTwoDimBlockCyclic, SymTwoDimBlockCyclicBand,
                     TiledMatrix, TwoDimBlockCyclic, TwoDimBlockCyclicBand,
                     TwoDimTabular, VectorTwoDimCyclic)
from .subtile import SubtileView

__all__ = [
    "DataCollection", "DictCollection", "LocalArrayCollection", "TiledMatrix",
    "TwoDimBlockCyclic", "SymTwoDimBlockCyclic", "TwoDimBlockCyclicBand",
    "SymTwoDimBlockCyclicBand", "TwoDimTabular", "VectorTwoDimCyclic",
    "SubtileView",
]
