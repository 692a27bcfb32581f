"""Data collections & distributions (SURVEY.md §2.6)."""
from .collection import DataCollection, DictCollection, LocalArrayCollection
from .matrix import (SymTwoDimBlockCyclic, SymTwoDimBlockCyclicBand,
                     TiledMatrix, TwoDimBlockCyclic, TwoDimBlockCyclicBand,
                     TwoDimTabular, VectorTwoDimCyclic)
from .redistribute import redistribute, redistribute_ptg, reshard_array
from .subtile import SubtileView

__all__ = [
    "DataCollection", "DictCollection", "LocalArrayCollection", "TiledMatrix",
    "TwoDimBlockCyclic", "SymTwoDimBlockCyclic", "TwoDimBlockCyclicBand",
    "SymTwoDimBlockCyclicBand", "TwoDimTabular", "VectorTwoDimCyclic",
    "SubtileView", "redistribute", "redistribute_ptg", "reshard_array",
]
