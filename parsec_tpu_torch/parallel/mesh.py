"""Device mesh over the five canonical parallel axes: dp (data), pp
(pipeline stages), tp (tensor/heads), sp (sequence), ep (experts), the
shard_map entry points, and the reduced-precision collectives.

A mesh lays chips (:class:`Chip`) out over the axes.  Chips are told
apart by their index, not their torch device: ``device_cuda_virtual_chips``
logical chips on ``cuda:0`` (each with a CUDA stream of its own) are that
many chips, and without it the chip pool is the physical cards
(``devices.chip_pool``).  The device module's chip mesh (devices/cuda.py
``CudaMeshDevice``, ``device_mesh_shape``) lays its chips over a ("tp",
"sp") grid; a model's mesh (``make_mesh``) uses every axis.
:func:`shard_map_compat` runs a function over a mesh, one thread a shard
(parallel/shard_map.py, the executor and the collectives).  The JAX
package's varying-manual-axes helpers (:func:`vary_on`,
:func:`match_vma`) are identities here: the executor builds one autograd
graph for the whole mesh, so there is no per-shard type to promote.

Reduced-precision collectives (the EQuARX recipe, arxiv 2506.17615):
:class:`ErrorFeedback` with :func:`reduced_precision_sum` /
:func:`two_level_allreduce` quantize each contribution AT THE REDUCTION
BOUNDARY (blockwise bf16, or int8 with a per-block scale: the wire
codecs of comm/wire.py, so lane and wire round identically) and carry
the residual of each quantized send into the next contribution of the
same logical buffer.  The wave collective lane
(dsl/ptg/wave_dist.py, ``wave_reduce_dtype``) rides these helpers.
:func:`qdq` is the quantize-dequantize hop in tensor operations, on
whatever device its input lives, bit for bit ``wire.qdq_array``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("dp", "pp", "tp", "sp", "ep")

#: declared lock discipline (analysis/lock_check.py): the error-feedback
#: accumulator is per-instance mutable state shared between whichever
#: threads drive the reduction (SPMD rank threads deposit concurrently
#: into one lane) — residuals live under the instance lock
_GUARDED_BY = {
    "ErrorFeedback._resid": "_lock",
}


@dataclasses.dataclass(eq=False)
class Chip:
    """One chip of a mesh: its index in the chip pool, the torch device
    it launches on, and (on a card) the CUDA stream it owns.  Several
    chips may share one torch device (``device_cuda_virtual_chips``);
    equality is identity."""
    id: int
    device: torch.device
    stream: Any = None

    def __repr__(self) -> str:
        return f"Chip({self.id}, {self.device})"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The devices (torch devices, or :class:`Chip` s) of a mesh, laid
    out over ``axis_names``.  Hashes by identity, so a cache keyed by a
    mesh never confuses two meshes over the same devices."""
    devices: np.ndarray           # one dimension per axis
    axis_names: tuple = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The torch device of the mesh's first chip."""
        d = self.devices.flat[0]
        return d.device if isinstance(d, Chip) else d


class PartitionSpec(tuple):
    """How a tensor splits over a mesh, one entry per leading dimension:
    an axis name, a tuple of names (major first), or None (not split);
    missing trailing entries are None.  A tuple, so the plain tuples of
    ``models.param_specs`` are specs too; its own type marks a spec
    where a tuple of specs could be meant (``in_specs``, ``out_specs``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def spec(*axes) -> PartitionSpec:
    """PartitionSpec shorthand."""
    return PartitionSpec(*axes)


def _factor(n: int, order: Sequence[str]) -> Dict[str, int]:
    """Greedy power-of-small-primes factoring of n over the axes in
    ``order`` (round-robin halving keeps the mesh balanced)."""
    sizes = {a: 1 for a in AXES}
    remaining = n
    i = 0
    while remaining > 1:
        p = _smallest_prime(remaining)
        sizes[order[i % len(order)]] *= p
        remaining //= p
        i += 1
    return sizes


def _smallest_prime(n: int) -> int:
    for p in (2, 3, 5, 7, 11, 13):
        if n % p == 0:
            return p
    return n


def _chips(devs: Sequence[Any]) -> List[Chip]:
    """Each entry as a chip: a torch device becomes chip ``i``; a chip on
    a card without a stream gets one of its own, so that several chips
    of one card run side by side."""
    out = []
    for i, d in enumerate(devs):
        c = d if isinstance(d, Chip) else Chip(i, torch.device(d))
        if c.device.type == "cuda" and c.stream is None:
            c = Chip(c.id, c.device, torch.cuda.Stream(device=c.device))
        out.append(c)
    return out


def make_mesh(n_devices: Optional[int] = None,
              sizes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None,
              order: Sequence[str] = ("dp", "tp", "sp", "pp", "ep")) -> Mesh:
    """A mesh over ``devices`` (torch devices or chips), or over the first
    ``n_devices`` chips of ``devices.chip_pool()`` (the physical cards, or
    ``device_cuda_virtual_chips`` logical chips; it raises without a card
    and when the pool holds too few chips).  With ``sizes`` (axis ->
    size, missing axes 1) the product must be the device count; without,
    the count is factored over ``order`` (the JAX package's rule).  A
    mesh of several chips holds :class:`Chip` s, each on a card with a
    stream of its own; a mesh of one keeps its device as given."""
    if sizes is not None:
        unknown = set(sizes) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; axes "
                             f"are {AXES}")
    if devices is None:
        from ..devices import chip_pool, resolve_device
        want = n_devices if n_devices is not None else (
            int(np.prod([int(v) for v in sizes.values()])) if sizes
            else None)
        if want == 1:
            devs = [resolve_device()]
        else:
            pool = chip_pool()
            if want is not None and len(pool) < want:
                raise RuntimeError(
                    f"a mesh of {want} chips and the chip pool holds "
                    f"{len(pool)}; set device_cuda_virtual_chips={want} "
                    f"(or more) to declare logical chips on "
                    f"{pool[0].device}")
            devs = pool[:want]
    else:
        devs = list(devices)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} "
                             f"devices given")
    n = len(devs)
    full = _factor(n, order) if sizes is None else \
        {a: int(sizes.get(a, 1)) for a in AXES}
    if int(np.prod(list(full.values()))) != n:
        raise ValueError(f"mesh sizes {sizes} do not cover {n} devices")
    if n > 1:
        devs = _chips(devs)
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d if isinstance(d, Chip) else torch.device(d)
    return Mesh(arr.reshape([full[a] for a in AXES]))


def sync_axes(leaf_spec, mesh_axes: Sequence[str] = AXES) -> Tuple[str, ...]:
    """Mesh axes a parameter is REPLICATED over (the axes over which its
    gradient sums the shards' contributions)."""
    used = set()
    for entry in tuple(leaf_spec):
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            used.update(entry)
        else:
            used.add(entry)
    return tuple(a for a in mesh_axes if a not in used)


def vary_on(x, axes, like=None):
    """The identity: one graph for the whole mesh has no varying axes."""
    return x


def match_vma(x, ref):
    """The identity, as :func:`vary_on`."""
    return x


def has_shard_map() -> bool:
    """Always: the executor (parallel/shard_map.py) is this package's."""
    return True


def shard_map_compat(f, mesh: Mesh, in_specs, out_specs):
    """``f`` over ``mesh``: one thread a shard, each on its chip, its
    arguments split by ``in_specs`` and its outputs assembled by
    ``out_specs`` (parallel/shard_map.py).  Differentiable: every
    collective is one autograd node over its group, and the gradient of
    a replicated input sums its shards' contributions."""
    from .shard_map import shard_map
    return shard_map(f, mesh, in_specs, out_specs)


def shard_map_fwd(f, mesh: Mesh, in_specs, out_specs):
    """The forward-only seam of the JAX package: the same executor, as
    its autograd costs nothing where nothing needs a gradient."""
    return shard_map_compat(f, mesh, in_specs, out_specs)


# -- reduced-precision collectives with error feedback ------------------
class ErrorFeedback:
    """Per-boundary error-feedback accumulator (EQuARX): for each
    logical buffer (caller-chosen ``key``) the residual of the last
    quantized send is retained and folded into the NEXT contribution
    before it quantizes, so repeated reductions of the same buffer
    converge to the full-precision result instead of accumulating
    bias.  A key whose contribution shape or dtype changes starts fresh
    (it is a different buffer).  Contributions are numpy arrays or
    tensors; a residual keeps its contribution's type.  Thread-safe:
    SPMD rank threads share one lane."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._resid: Dict[Any, Any] = {}

    def compensate(self, key: Any, arr: Any, codec: str, qdq_fn) -> Any:
        """Quantize ``arr`` through ``qdq_fn(x, codec)`` with feedback:
        returns the quantized-dequantized values that should travel,
        retaining (folded contribution - sent values) for next time."""
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        with self._lock:
            prev = self._resid.get(key)
            same = (prev is not None and type(prev) is type(arr)
                    and tuple(prev.shape) == tuple(arr.shape)
                    and prev.dtype == arr.dtype)
            folded = arr + prev if same else arr
            out = qdq_fn(folded, codec)
            self._resid[key] = folded - out
        return out

    def reset(self, key: Any = None) -> None:
        with self._lock:
            if key is None:
                self._resid.clear()
            else:
                self._resid.pop(key, None)

    def keys(self) -> List[Any]:
        with self._lock:
            return list(self._resid)


def _quant_codec_of(reduce_dtype: Optional[str]) -> Optional[str]:
    """Map a ``wave_reduce_dtype`` knob value to a registered quantized
    wire codec name (None = full precision); raises on an unknown one."""
    from ..comm import wire
    return wire.normalize_quant_codec(reduce_dtype or "")


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float32 tensor as int64 values in [0, 2**32)."""
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _f32_of_bits(u: torch.Tensor) -> torch.Tensor:
    """float32 with the bit pattern of the int64 values ``u`` (< 2**32)."""
    signed = torch.where(u >= (1 << 31), u - (1 << 32), u)
    return signed.to(torch.int32).view(torch.float32)


def qdq(x: torch.Tensor, codec: str) -> torch.Tensor:
    """Quantize-dequantize in tensor operations on ``x``'s device, bit for
    bit the values ``wire.qdq_array`` delivers: the same round-to-nearest-
    even bf16 arithmetic on the raw bits, the same blockwise absmax/127
    float32 scales.  Float32 and float64 inputs narrow through float32 as
    the wire does and come back in their own dtype; any other dtype
    passes through unchanged."""
    from ..comm.wire import QUANT_BLOCK
    if x.dtype not in (torch.float32, torch.float64):
        return x
    dt, shape = x.dtype, x.shape
    f = x.to(torch.float32).reshape(-1)
    if codec == "qbf16":
        u = _u32(f)
        # RNE: add 0x7FFF + the LSB of the kept half, then truncate —
        # the wire's _enc_bf16, uint32 wraparound included
        q = (((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFFFFFF) >> 16) & 0xFFFF
        return _f32_of_bits(q << 16).to(dt).reshape(shape)
    if codec == "qint8":
        n = f.numel()
        nblocks = max(1, (n + QUANT_BLOCK - 1) // QUANT_BLOCK)
        xp = torch.zeros(nblocks * QUANT_BLOCK, dtype=torch.float32,
                         device=f.device)
        xp[:n] = f
        xb = xp.reshape(nblocks, QUANT_BLOCK)
        # tensor divisors: a Python-scalar divisor becomes a multiply by
        # its reciprocal on CUDA, one ulp off the wire's IEEE division
        amax = xb.abs().amax(dim=1)
        scales = amax / torch.full_like(amax, 127.0)
        inv = torch.where(scales > 0,
                          torch.ones_like(scales) / scales,
                          torch.zeros_like(scales))
        q = torch.clamp(torch.round(xb * inv[:, None]), -127, 127)
        deq = (q.to(torch.int8).to(torch.float32)
               * scales[:, None]).reshape(-1)[:n]
        return deq.to(dt).reshape(shape)
    raise ValueError(f"unknown quantized codec {codec!r}")


def _qdq_native(arr: np.ndarray, codec: str) -> np.ndarray:
    """Numpy in, numpy out over :func:`qdq` (host tensors): the boundary
    hop of the collective helpers below."""
    a = np.ascontiguousarray(arr)
    if a.dtype.name not in ("float32", "float64"):
        return a
    return qdq(torch.from_numpy(a), codec).numpy().reshape(a.shape)


def _zeros_like(x: Any) -> Any:
    return torch.zeros_like(x) if isinstance(x, torch.Tensor) \
        else np.zeros_like(np.asarray(x))


def reduced_precision_sum(contribs: Sequence[Any],
                          reduce_dtype: Optional[str] = None,
                          feedback: Optional[ErrorFeedback] = None,
                          keys: Optional[Sequence[Any]] = None,
                          native: bool = True) -> Any:
    """Sum of per-participant contributions (numpy arrays, or tensors on
    one device) with quantize-at-the-boundary: each contribution is
    quantized (bf16 / int8 blockwise, exactly the wire codecs) before it
    enters the reduction, and the accumulation stays full precision.
    ``feedback``/``keys`` enable per-contributor error feedback
    (``keys[i]`` names contributor i's logical buffer).  ``reduce_dtype``
    None/"" keeps the exact full-precision sum.  ``native`` (the
    default) quantizes through :func:`qdq`; ``native=False`` through the
    host numpy wire codec (kept for the parity tests)."""
    from ..comm import wire
    codec = _quant_codec_of(reduce_dtype)
    if codec is None:
        out = _zeros_like(contribs[0])
        for c in contribs:
            out = out + (c if isinstance(c, torch.Tensor) else np.asarray(c))
        return out
    out = None
    for i, c in enumerate(contribs):
        if isinstance(c, torch.Tensor):
            hop = qdq
        else:
            c = np.asarray(c)
            hop = _qdq_native if native else wire.qdq_array
        if feedback is not None and keys is not None:
            q = feedback.compensate(keys[i], c, codec, hop)
        else:
            q = hop(c, codec)
        out = q if out is None else out + q
    return out


def two_level_allreduce(shards: Sequence[Any], group_size: int,
                        reduce_dtype: Optional[str] = None,
                        feedback: Optional[ErrorFeedback] = None,
                        key: Any = None, native: bool = True) -> Any:
    """Hierarchical all-reduce: contributions reduce FULL precision inside
    each ``group_size``-wide group (level 1), each group's partial sum
    quantizes at the group boundary (level 2), and the quantized
    partials sum to the replicated result.  With ``feedback`` set, each
    group's boundary residual carries into its next partial under
    ``(key, group index)``.  With ``reduce_dtype`` None/"" this is
    exactly the flat sum.  ``native`` as in
    :func:`reduced_precision_sum`."""
    n = len(shards)
    groups = [list(range(g, min(g + group_size, n)))
              for g in range(0, n, group_size)]
    partials = []
    for members in groups:
        first = shards[members[0]]
        part = first.clone() if isinstance(first, torch.Tensor) \
            else np.asarray(first).copy()
        for m in members[1:]:
            s = shards[m]
            part += s if isinstance(s, torch.Tensor) else np.asarray(s)
        partials.append(part)
    keys = [(key, gi) for gi in range(len(groups))] \
        if feedback is not None else None
    return reduced_precision_sum(partials, reduce_dtype,
                                 feedback=feedback, keys=keys,
                                 native=native)


from .shard_map import axis_index, axis_size  # noqa: E402
