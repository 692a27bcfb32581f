"""Device mesh over the five canonical parallel axes: dp (data), pp
(pipeline stages), tp (tensor/heads), sp (sequence), ep (experts), and
the reduced-precision collectives.

A model's mesh spans one device, so every axis it reads has size 1: a
model over several chips (SPMD, ROADMAP Queue 1, part D2b) raises.  A
mesh over several CHIPS (:class:`Chip`) is what the device module's
chip mesh (devices/cuda.py ``CudaMeshDevice``, ``device_mesh_shape``)
lays out over its ("tp", "sp") grid: chips are told apart by their
index, not their torch device, so four logical chips on ``cuda:0`` are
four chips.

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
from typing import Any, Dict, List, Optional, Sequence

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


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """A mesh over ``devices``.  With ``sizes`` (axis -> size, missing
    axes 1; the product must be the device count) the devices, chips
    included, are laid out row-major over the axes: the chip mesh's
    ``sizes={"tp": P, "sp": Q}``.  Without ``sizes`` the mesh is a
    model's, over one device: ``devices[0]`` when given, else ``cuda:0``
    (which raises without a card), and more than one device raises
    (part D2b)."""
    if sizes is not None:
        if devices is None:
            raise ValueError("make_mesh(sizes=...) needs its devices")
        devs = [d if isinstance(d, Chip) else torch.device(d)
                for d in devices]
        unknown = set(sizes) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; axes "
                             f"are {AXES}")
        full = {a: int(sizes.get(a, 1)) for a in AXES}
        if int(np.prod(list(full.values()))) != len(devs) \
                or (n_devices is not None and n_devices != len(devs)):
            raise ValueError(f"mesh sizes {sizes} do not cover "
                             f"{len(devs)} devices")
        arr = np.empty(len(devs), dtype=object)
        for i, d in enumerate(devs):
            arr[i] = d
        return Mesh(arr.reshape([full[a] for a in AXES]))
    n = n_devices if n_devices is not None else (
        len(devices) if devices is not None else 1)
    if n != 1 or (devices is not None and len(devices) != 1):
        raise NotImplementedError(
            f"a model mesh over {n} devices is SPMD over torch.distributed "
            f"or rank threads (ROADMAP Queue 1, part D2b); this package "
            f"runs a model on one device")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the mesh defaults to cuda:0; pass "
                "devices=[torch.device('cpu')] to run on the CPU")
        devices = [torch.device("cuda", 0)]
    arr = np.empty((1,) * len(AXES), dtype=object)
    arr.flat[0] = torch.device(devices[0])
    return Mesh(arr)


def check_model_mesh(mesh: Mesh) -> None:
    """A model runs on a mesh of one device: a mesh over several chips
    raises, naming part D2b."""
    if mesh.size != 1:
        raise NotImplementedError(
            f"a model over a mesh of {mesh.size} chips ({mesh.shape}) is "
            f"SPMD (ROADMAP Queue 1, part D2b); this package runs a model "
            f"on a mesh of one device")


def axis_size(axis_name: str, mesh: Optional[Mesh] = None) -> int:
    """The size of a mesh axis: 1 for every axis, on one device.  The
    sp = 1 and pp = 1 forms of ring_attention, sequence and pipeline
    rest on it; given a ``mesh`` whose axis spans several chips it
    raises (part D2b)."""
    if axis_name not in AXES:
        raise ValueError(f"unknown mesh axis {axis_name!r}; axes are {AXES}")
    if mesh is not None and mesh.shape.get(axis_name, 1) != 1:
        raise NotImplementedError(
            f"mesh axis {axis_name!r} of size {mesh.shape[axis_name]}: "
            f"model axes above size 1 are SPMD (ROADMAP Queue 1, part "
            f"D2b)")
    return 1


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
