"""In-process SPMD thread harness.

One thread per rank over a shared fabric — the reference's CI strategy
(distributed behavior validated by oversubscribed mpiexec on one node,
SURVEY.md §4), except the "node" is one process.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Tuple


def spmd_threads(nb_ranks: int, fn: Callable[[int, Any], Any],
                 timeout: float = 120.0,
                 fabric: Optional[Any] = None) -> Tuple[List[Any], Any]:
    """Run ``fn(rank, fabric)`` on one daemon thread per rank.

    ``fabric`` defaults to a fresh ``LocalFabric``. Joins every thread
    with ``timeout`` (a still-alive thread is a hang and raises
    TimeoutError), then re-raises the first rank's error. Returns
    (results, fabric).
    """
    from ..comm import LocalFabric

    if fabric is None:
        fabric = LocalFabric(nb_ranks)
    if fabric.nb_ranks != nb_ranks:
        raise ValueError(f"fabric has {fabric.nb_ranks} ranks, asked for "
                         f"{nb_ranks}")
    results: List[Any] = [None] * nb_ranks
    errors: List[Optional[BaseException]] = [None] * nb_ranks

    def runner(r: int) -> None:
        try:
            results[r] = fn(r, fabric)
        except BaseException as e:  # noqa: BLE001 - propagated below
            errors[r] = e

    threads = [threading.Thread(target=runner, args=(r,), daemon=True)
               for r in range(nb_ranks)]
    for t in threads:
        t.start()
    for r, t in enumerate(threads):
        t.join(timeout)
        if t.is_alive():
            raise TimeoutError(f"rank {r} thread hung past {timeout} s")
    for e in errors:
        if e is not None:
            raise e
    return results, fabric
