"""Collection checkpoint/resume.

The reference has NO runtime-level checkpointing (SURVEY.md §5.4 —
"absent"; apps re-run from user data, with parsec_dtd_data_flush as the
only return-data-to-home building block). Since all application state
lives in data collections (tiles), a checkpoint is a consistent snapshot
of a collection's local tiles taken between taskpools (when no DAG is in
flight), and resume rebuilds the collection tile-by-tile. SPMD: each
rank writes only the tiles it owns; a restore on R ranks reads each
rank's own shard file set.

Format (the JAX package's, file for file: a snapshot written by either
package restores into the other's collections): one ``.npz`` per
(collection, rank) holding tile arrays keyed ``t<m>_<n>`` plus a
JSON-encoded manifest (geometry, dtype, distribution parameters, format
``version``) used to validate compatibility at restore time. Files are
written atomically (temp file + ``os.replace``) so a rank crashing
mid-snapshot can never leave a torn ``.npz`` under the published name —
the previous complete snapshot survives intact.

Device-resident tiles: the newest version of a tile may live on the
card. ``save_collection`` pulls it through the device module
(``Data.sync_to_host(context.devices)``: a D2H copy queued on the
module's stream behind the kernel that wrote the tile) and synchronises
every device stream before the file is written. ``restore_collection``
writes the host copy and bumps its version, so a stale device copy of
the same tile is never read again: the next device task stages the
restored values in.

Cross-grid restore (``reshard=True``): a snapshot written on another
rank count or process grid is redistributed onto the restoring
collection's grid (``ft.reshard_restore``, over
``collections/redistribute``); on the identical grid it takes the
per-rank path.
"""
from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..data.data import Data, is_device_array, to_host_array

#: manifest format version; bumped when the on-disk layout changes.
#: v2 = atomic writes + version field (v1 manifests have no version
#: key and still load).
CHECKPOINT_VERSION = 2

#: manifest keys that describe the GEOMETRY of the data (must always
#: match — resharding cannot reinterpret bytes) vs the DISTRIBUTION
#: (relaxed under reshard=True: that is exactly what resharding fixes)
GEOMETRY_KEYS = ("lm", "ln", "mb", "nb", "dtype", "uplo")
DISTRIBUTION_KEYS = ("kind", "nodes", "rank", "P", "Q", "krows", "kcols",
                     "members")


class CheckpointMismatchError(ValueError):
    """The snapshot's manifest does not match the restoring collection
    (different geometry, rank count, or process grid). Raised BEFORE
    any tile is loaded: a rank file holds only the tiles the saving
    rank owned under ITS distribution, so restoring under a different
    grid would silently leave foreign tiles empty / place tiles on the
    wrong ranks."""


class CheckpointCorruptError(ValueError):
    """A snapshot file exists but cannot be read (torn/partial write —
    e.g. a rank crashed mid-``np.savez`` before atomic writes, or the
    storage truncated it). Distinct from a manifest mismatch so the
    restart driver can SKIP the corrupt snapshot and fall back to the
    previous complete one instead of dead-ending."""


def _manifest_of(coll: Any) -> Dict[str, Any]:
    man = {"version": CHECKPOINT_VERSION,
           "lm": coll.lm, "ln": coll.ln, "mb": coll.mb, "nb": coll.nb,
           "dtype": np.dtype(coll.dtype).name,
           "kind": type(coll).__name__,
           # distribution identity: the shard set is only meaningful on
           # the identical rank count / process grid it was written with
           "nodes": getattr(coll, "nodes", 1),
           "rank": getattr(coll, "rank", 0)}
    # "members" = the logical-rank -> world-rank map of an elastic
    # (remapped) grid: a resharding restore needs it to replay the
    # snapshot's tile ownership
    for attr in ("P", "Q", "krows", "kcols", "uplo", "members"):
        if hasattr(coll, attr):
            v = getattr(coll, attr)
            man[attr] = list(v) if attr == "members" else v
    return man


def _grid_str(man: Dict[str, Any]) -> str:
    grid = ""
    if "P" in man and "Q" in man:
        grid = f", grid {man['P']}x{man['Q']}"
    return f"{man.get('nodes', '?')} rank(s){grid}"


def checkpoint_path(prefix: str, rank: int) -> str:
    return f"{prefix}.rank{rank}.npz"


def _atomic_savez(path: str, arrays: Dict[str, Any]) -> None:
    """Write ``path`` atomically: a crash mid-write leaves only a stale
    ``.tmp`` (ignored by every reader), never a torn published file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # pragma: no cover - only on write error
            os.unlink(tmp)


def _open_snapshot(path: str):
    """np.load with torn-file detection: any unreadable/half-written
    snapshot surfaces as CheckpointCorruptError (missing files stay
    FileNotFoundError — absent and torn are different failures)."""
    try:
        z = np.load(path, allow_pickle=False)
    except FileNotFoundError:
        raise
    except Exception as exc:  # noqa: BLE001 - zipfile/struct/OSError zoo
        raise CheckpointCorruptError(
            f"checkpoint {path} is torn or unreadable ({exc}); it was "
            f"likely half-written by a crashing rank — fall back to the "
            f"previous complete snapshot") from exc
    if "__manifest__" not in z.files:
        z.close()
        raise CheckpointCorruptError(
            f"checkpoint {path} has no manifest — torn or foreign file")
    return z


def read_manifest(path: str) -> Dict[str, Any]:
    with _open_snapshot(path) as z:
        try:
            return json.loads(str(z["__manifest__"]))
        except ValueError as exc:
            raise CheckpointCorruptError(
                f"checkpoint {path} manifest is not valid JSON") from exc


def find_manifest(prefix: str) -> Dict[str, Any]:
    """Manifest of any readable shard of ``prefix`` (a resharding
    restore cannot guess which writer ranks existed). Torn shards are
    skipped; all-torn or no shards raises."""
    paths = sorted(glob.glob(f"{glob.escape(prefix)}.rank*.npz"))
    if not paths:
        raise FileNotFoundError(f"no checkpoint shards at {prefix}.rank*")
    last: Optional[Exception] = None
    for p in paths:
        try:
            return read_manifest(p)
        except CheckpointCorruptError as exc:
            last = exc
    raise CheckpointCorruptError(
        f"every checkpoint shard at {prefix}.rank* is torn") from last


#: this process's snapshot accounting (tools and chip_smoke.py read it):
#: files written, tile bytes, seconds pulling the tiles to the host
#: (device D2H included) and seconds writing the ``.npz`` files
save_stats: Dict[str, float] = {"files": 0, "bytes": 0, "pull_s": 0.0,
                                "write_s": 0.0}


def _synchronize(devices) -> None:
    """Wait for every device stream: the pulls above queued their D2H
    copies behind the kernels that wrote the tiles."""
    for dev in devices or ():
        stream = getattr(dev, "stream", None)
        if stream is not None:
            stream.synchronize()


def save_collection(coll: Any, prefix: str, context: Optional[Any] = None) -> str:
    """Write this rank's local tiles. Call between taskpools (quiescent
    point); device-resident newest copies are pulled back first. The
    write is atomic: the file at the published path is always either
    the previous complete snapshot or this one, never a torn mix."""
    t0 = time.perf_counter()
    devices = context.devices if context is not None else None
    tiles: Dict[str, Any] = {}
    for (m, n) in coll.local_tiles():
        copy = coll.data_of(m, n).sync_to_host(devices)
        if copy.payload is not None:
            tiles[f"t{m}_{n}"] = copy.payload
    _synchronize(devices)
    tiles = {k: to_host_array(v) if is_device_array(v) else np.asarray(v)
             for k, v in tiles.items()}
    t1 = time.perf_counter()
    path = checkpoint_path(prefix, coll.rank)
    nbytes = sum(a.nbytes for a in tiles.values())
    tiles["__manifest__"] = json.dumps(_manifest_of(coll))
    _atomic_savez(path, tiles)
    save_stats["files"] += 1
    save_stats["bytes"] += nbytes
    save_stats["pull_s"] += t1 - t0
    save_stats["write_s"] += time.perf_counter() - t1
    return path


def _mismatches(man: Dict[str, Any], ours: Dict[str, Any]) -> List[str]:
    """Keys on which the snapshot and the restoring collection diverge.
    "nodes"/"rank" are absent from pre-ft manifests, "version"/"members"
    from pre-elastic ones: optional keys are only compared when the
    snapshot recorded them ("version" never — it is a format marker,
    not an identity)."""
    keys = ["lm", "ln", "mb", "nb", "dtype", "kind", "P", "Q",
            "krows", "kcols", "uplo"]
    keys += [k for k in ("nodes", "rank") if k in man]
    bad = [k for k in keys if man.get(k) != ours.get(k)]
    if "members" in man or "members" in ours:
        # an elastic (remapped) grid on either side: the absent side is
        # the identity map over its own logical grid
        def _norm(m):
            if m.get("members") is not None:
                return list(m["members"])
            return list(range((m.get("P") or 1) * (m.get("Q") or 1)))
        if _norm(man) != _norm(ours):
            bad.append("members")
    return bad


def restore_collection(coll: Any, prefix: str, reshard: bool = False,
                       context: Optional[Any] = None) -> int:
    """Load this rank's tiles back into ``coll``; returns #tiles restored.

    Geometry must match the manifest (same tiling and dtype). By
    default the distribution must match too — fail-fast, today's
    contract. With ``reshard=True`` a snapshot written on a DIFFERENT
    rank count / process grid is redistributed onto ``coll``'s grid
    (``ft.reshard_restore``; ``context`` is required when the current
    grid spans more than one rank). Geometry mismatches (tile size,
    dtype, extent) hard-fail either way.
    """
    if reshard:
        # "rank" is writer-local (find_manifest returns SOME shard's
        # manifest) — it cannot distinguish grids, only shards
        man = find_manifest(prefix)
        if [k for k in _mismatches(man, _manifest_of(coll))
                if k != "rank"]:
            from ..ft.elastic import reshard_restore
            return reshard_restore(coll, prefix, context=context)
        # identical grid: fall through to the plain per-rank fast path
    path = checkpoint_path(prefix, coll.rank)
    with _open_snapshot(path) as z:
        man = json.loads(str(z["__manifest__"]))
        ours = _manifest_of(coll)
        # geometry AND distribution must match: a rank file holds only
        # the tiles the saving rank owned, so restoring under a
        # different kind/grid/rank-count would silently leave foreign
        # tiles empty or place tiles on the wrong ranks. Collect EVERY
        # mismatch (one clear error beats a fix-one-rerun loop).
        bad = _mismatches(man, ours)
        if bad:
            detail = [f"{k}: snapshot {man.get(k)!r} != ours {ours.get(k)!r}"
                      for k in bad]
            # when ONLY the distribution diverged the data is
            # recoverable — name the escape hatch instead of
            # dead-ending the operator on a grid change
            hint = ""
            if all(k in DISTRIBUTION_KEYS for k in bad):
                hint = (" The tile geometry matches: pass reshard=True "
                        "(ft.reshard_restore) to redistribute the "
                        "snapshot onto the current grid, or run under "
                        "--mca ft_elastic shrink for automatic "
                        "grid-resize recovery.")
            raise CheckpointMismatchError(
                f"checkpoint {path} is incompatible with the restoring "
                f"collection ({'; '.join(detail)}). The snapshot was "
                f"written on {_grid_str(man)}; this collection spans "
                f"{_grid_str(ours)} — restore requires the identical "
                f"tiling, dtype, rank count, and process grid.{hint}")
        n = 0
        for name in z.files:
            if not name.startswith("t"):
                continue
            m_, n_ = (int(x) for x in name[1:].split("_"))
            # a host copy a remote writer left read-only takes a
            # writable buffer first (set_tile writes in place)
            Data.materialize_host(coll.data_of(m_, n_).host_copy())
            coll.set_tile(m_, n_, z[name])
            n += 1
    return n


def arrays_path(prefix: str, rank: int) -> str:
    """Namespaced separately from collection shards so the two can share
    one prefix without clobbering each other."""
    return f"{prefix}.arrays.rank{rank}.npz"


def save_arrays(prefix: str, rank: int = 0, **arrays: Any) -> str:
    """Checkpoint loose named arrays (e.g. model/optimizer state from
    parallel/ training) alongside collections. Atomic like
    :func:`save_collection`."""
    path = arrays_path(prefix, rank)
    _atomic_savez(path, {k: np.asarray(v) for k, v in arrays.items()})
    return path


def load_arrays(prefix: str, rank: int = 0) -> Dict[str, np.ndarray]:
    with np.load(arrays_path(prefix, rank), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
