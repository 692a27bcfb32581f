"""Sub-tiling of one tile for recursive task calls.

Reference behavior: the ``subtile`` descriptor views a single tile of a
parent matrix as a smaller tiled matrix so a nested taskpool can run tile
algorithms inside it (ref: parsec/data_dist/matrix/subtile.c, used by the
recursive-tasks machinery, parsec/recursive.h).

``SubtileView`` wraps a host ndarray (typically one tile's payload) without
copying: sub-tiles are numpy views, so the nested computation updates the
parent tile in place — exactly the recursive dpotrf/potrf-on-diagonal use.
All sub-tiles are local (``rank_of == rank``): recursion never crosses
ranks, matching the reference (a subtile descriptor lives on the rank that
owns the parent tile).
"""
from __future__ import annotations

import numpy as np

from ..data.data import Data, data_new_with_payload
from .matrix import TiledMatrix

__all__ = ["SubtileView"]


class SubtileView(TiledMatrix):
    def __init__(self, array: np.ndarray, mb: int, nb: int,
                 uplo: str = "full") -> None:
        if array.ndim != 2:
            raise ValueError("SubtileView wraps a 2-D tile")
        super().__init__(array.shape[0], array.shape[1], mb, nb,
                         dtype=array.dtype, nodes=1, rank=0, uplo=uplo)
        self.array = array

    def rank_of(self, m: int, n: int) -> int:
        return self.rank

    def pull_home(self, devices=None) -> None:
        """Fold the newest version of every sub-tile back into the parent
        array (the reference analog: the subtile descriptor unwinds into
        the parent tile when the nested taskpool finishes). Needed because
        device stage-out replaces host payload objects, breaking the view
        aliasing."""
        with self._tlock:
            items = list(self._tiles.items())
        for (m, n), d in items:
            host = d.sync_to_host(devices)
            if host.payload is None:
                continue
            tm, tn = self.tile_shape(m, n)
            region = self.array[m * self.mb:m * self.mb + tm,
                                n * self.nb:n * self.nb + tn]
            if host.payload is not region:
                np.copyto(region, np.asarray(host.payload))

    def data_of(self, m: int, n: int) -> Data:
        if not (0 <= m < self.mt and 0 <= n < self.nt):
            raise IndexError(f"subtile ({m},{n}) out of range")
        with self._tlock:
            d = self._tiles.get((m, n))
            if d is None:
                tm, tn = self.tile_shape(m, n)
                view = self.array[m * self.mb:m * self.mb + tm,
                                  n * self.nb:n * self.nb + tn]
                d = data_new_with_payload(view, device_id=0,
                                          key=(id(self), m, n))
                d.collection = self
                self._tiles[(m, n)] = d
            return d
