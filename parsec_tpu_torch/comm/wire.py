"""Wire framing for the TCP transport: the comm-engine fast path.

Frame format (v2). Every frame on a connection is::

    <u64 body_len> <body>

``body_len == GOODBYE`` (2**64-1) is the clean-shutdown sentinel (no
body follows). Otherwise the body's first byte is a *kind*:

- ``K_BATCH``: one or more complete active messages coalesced into a
  single frame (ONE syscall per batch on the send side). Each message
  segment is ``<u32 pickle_len> <u32 nbufs> [<u64 size>]*nbufs
  <pickle> <buf bytes>*`` — the pickle-5 frame plus its out-of-band
  buffers, copied in-band at enqueue time (all are below the chunk
  threshold by construction, so the copy is small and preserves the
  historical copy-at-send snapshot semantics).
- ``K_XFER_HDR``: header of a chunked message — a message whose
  payload carries at least one buffer >= the chunk threshold. The
  pickle frame and the small buffers ride in the header; each large
  buffer is announced (size only) and its bytes follow as ``K_CHUNK``
  frames, interleavable with control traffic.
- ``K_CHUNK``: one bounded segment of one announced buffer
  (``<u64 xfer_id> <u32 buf_index> <u64 offset> <bytes>``). The
  receiver reassembles; the message is delivered when every announced
  byte has landed. Chunks of one transfer are FIFO; *other* frames may
  interleave between them — that is the point (no head-of-line
  blocking of small control AMs behind a multi-MB payload).
- ``K_HELLO``: capability advertisement sent once per connection right
  after the rank handshake (``{"ver", "codecs", "rank"}``). A peer
  that never sends one (mixed version) simply never negotiates a
  codec, so compression silently stays off toward it.
- ``K_COMP``: a compressed *body* (kind byte included) of any of the
  above: ``<u8 codec_id> <u64 raw_len> <compressed>``. Only emitted
  toward peers that advertised the codec.

Quantized tile codecs (the ``"qz"`` HELLO capability):
LOSSY blockwise encodings for bulk float tile payloads, registered in
the same ``CODECS`` table as the lossless byte codecs but with
``lossless=False`` — they never ride ``K_COMP`` (a lossy transform of
a pickled body would corrupt it). Instead they apply per BUFFER on the
chunk lane: a pickle-5 out-of-band float buffer >= the chunk threshold
may be encoded before it is announced in the transfer header, its
bufspec flag gains the ``BUF_QUANT`` bit, the encoded bytes stream as
normal ``K_CHUNK`` frames, and the receiver dequantizes the
reassembled buffer back to the original dtype/length before the
message unpickles — transparent to every handler. Because the
encoding happens at ENQUEUE (before the K_SEQ envelope), the reliable
session's replay window retains the encoded bytes and a post-flap
replay is bit-identical for free. Only ever emitted toward peers whose
HELLO advertised the codec under ``"qz"`` (both ends must enable
``comm_quantize``); a mixed-version peer stays lossless.

- ``qbf16``: round-to-nearest-even bfloat16 (f64 narrows through f32)
  — 2 bytes/element, ~2x (f32) / 4x (f64) fewer payload bytes.
- ``qint8``: int8 with one f32 scale per ``QUANT_BLOCK``-element block
  (``scale = absmax/127``) — ~4x/8x fewer payload bytes.

Encoded buffer layout: ``<u8 codec_id> <u8 dtype_code> <u64 raw_len>
<u32 block_elems>`` then the codec payload (qbf16: u16 little-endian
elements; qint8: f32 scales[nblocks] + i8 elements).
- ``K_PING`` / ``K_PONG``: heartbeat probe and its echo
  (``<u32 seq> <u64 t_ns>``, the sender's monotonic clock — the pong
  echoes it back so the sender computes the round trip). Handled
  directly by the receiver THREAD (like K_HELLO), never queued through
  the inbox: a rank stuck in a long kernel still answers, so TCP
  liveness is independent of the progress cadence. Only sent toward
  peers whose HELLO advertised ``"hb"``.

Reliable-session framing (the ``"rs"`` HELLO capability — transient
link faults recover by reconnect + replay instead of rank eviction,
comm/tcp.py):

- ``K_SEQ``: envelope around any DATA frame body (``<u32 epoch>
  <u64 seq> <inner body>``). Each direction numbers its data frames
  (batches, transfer headers, chunks) with a per-link monotonically
  increasing ``seq``; the receiver delivers in order exactly once —
  a replayed frame it already delivered is dropped by seq (idempotent
  re-delivery: no active message ever runs twice). Session-less
  control frames (hello, ping/pong, ack, resume) are never
  wrapped: they are regenerated, not replayed.
- ``K_ACK``: cumulative delivery acknowledgment (``<u32 epoch>
  <u64 seq>``) — everything up to ``seq`` landed, so the sender may
  drop those frames from its bounded replay window.
- ``K_RESUME``: reconnect handshake (a pickled dict), sent right
  after the rank-identifying handshake on a RE-dialed connection:
  carries the proposed session ``epoch``, the last-delivered ``ack``
  both ways, and optionally a ``partial`` claim — how many bytes of
  the next expected frame already landed before the link tore, so the
  sender resumes that frame mid-body instead of resending it.
- ``K_FRAG``: the byte-level resume of one torn frame
  (``<u32 epoch> <u64 seq> <u64 offset> <bytes>``): the remainder of
  the frame the receiver holds a partial body of; receiver stitches
  partial + remainder and dispatches the whole as a normal K_SEQ
  frame.

All integers little-endian, matching the v1 framing.

The framing is byte-for-byte the JAX package's (a frame of numpy and
Python values is the same bytes from either package).  Payloads must be
host data: a ``torch.Tensor`` handed to :func:`dumps_message` raises
``TypeError`` — pickling it would ship a CUDA tensor through
``torch.save`` and rebuild it on the peer's card, a silent slow path;
the remote-dep layer stages tiles to numpy first (or moves them on the
device data plane, comm/xfer.py).
"""
from __future__ import annotations

import io
import pickle
import struct
import sys
import zlib
from typing import (Any, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np

GOODBYE = (1 << 64) - 1  # frame-size sentinel: clean shutdown, not a crash

K_BATCH = 0
K_XFER_HDR = 1
K_CHUNK = 2
K_HELLO = 3
K_COMP = 4
K_PING = 5
K_PONG = 6
K_ELASTIC = 7     # elastic membership (ft/elastic.py)
K_SEQ = 8
K_ACK = 9
K_RESUME = 10
K_FRAG = 11
K_TUNE = 12       # runtime tuning (tune/controller.py)

WIRE_VERSION = 2

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_SEG = struct.Struct("<II")          # pickle_len, nbufs
_BATCH = struct.Struct("<BI")        # kind, nmsgs
_XFER = struct.Struct("<BQII")       # kind, xfer_id, pickle_len, nbufs
_BUFSPEC = struct.Struct("<BQ")      # chunked?, size
_CHUNK = struct.Struct("<BQIQ")      # kind, xfer_id, buf_index, offset
_COMP = struct.Struct("<BBQ")        # kind, codec_id, raw_len
_PING = struct.Struct("<BIQ")        # kind, seq, t_ns (sender monotonic)
_PINGX = struct.Struct("<BIQQ")      # + responder clock (the "tr" ext)
_SEQHDR = struct.Struct("<BIQ")      # kind, epoch, seq (K_SEQ / K_ACK)
_FRAGHDR = struct.Struct("<BIQQ")    # kind, epoch, seq, byte offset


# -- codecs -------------------------------------------------------------
def _lz4_mod():
    try:
        import lz4.frame as _lz4
        return _lz4
    except ImportError:
        return None


class Codec(NamedTuple):
    """One registered wire codec. ``lossless`` entries are byte codecs
    (``comp``/``dec`` map bytes to bytes, the K_COMP path); lossy
    entries are QUANTIZED tile codecs applied per float buffer on the
    chunk lane (see the module docstring) and are excluded from the
    lossless negotiation paths by construction."""

    cid: int
    comp: Any
    dec: Any
    lossless: bool = True


#: name -> Codec; lz4 is optional — absent installs simply don't
#: advertise it at the handshake. The quantized (lossy) tile codecs
#: live in the same table under distinct wire ids; the HELLO
#: advertises them separately (``"qz"`` vs ``"codecs"``), so the two
#: families can never cross-negotiate.
CODECS: Dict[str, Codec] = {
    "zlib": Codec(1, lambda b: zlib.compress(b, 1), zlib.decompress),
}
if _lz4_mod() is not None:
    _l = _lz4_mod()
    CODECS["lz4"] = Codec(2, _l.compress, _l.decompress)

_CODEC_BY_ID = {c.cid: (name, c) for name, c in CODECS.items()}

#: preference order when both ends support several
_CODEC_PREF = ("lz4", "zlib")


def available_codecs() -> List[str]:
    """Lossless byte codecs (the HELLO ``"codecs"`` capability)."""
    return sorted(n for n, c in CODECS.items() if c.lossless)


def available_quant_codecs() -> List[str]:
    """Quantized tile codecs (the HELLO ``"qz"`` capability)."""
    return sorted(n for n, c in CODECS.items() if not c.lossless)


def negotiate_codec(mine: Sequence[str],
                    theirs: Sequence[str]) -> Optional[str]:
    """Pick the preferred codec both ends advertised (None: no common
    codec — e.g. a mixed-version peer that never sent a HELLO)."""
    common = set(mine) & set(theirs)
    for name in _CODEC_PREF:
        if name in common:
            return name
    return sorted(common)[0] if common else None


def normalize_quant_codec(name: str) -> Optional[str]:
    """Map a ``comm_quantize`` knob value to a registered quantized
    codec name (``bf16``/``int8`` shorthands accepted); None when the
    knob is empty. Raises on an unknown or lossless codec name."""
    name = (name or "").strip().lower()
    if not name or name in ("0", "off", "none"):
        return None
    if not name.startswith("q"):
        name = "q" + name
    ent = CODECS.get(name)
    if ent is None or ent.lossless:
        raise ValueError(
            f"comm_quantize={name!r}: not a registered quantized codec "
            f"(have {available_quant_codecs()})")
    return name


def negotiate_quant_codec(requested: Optional[str],
                          theirs: Sequence[str]) -> Optional[str]:
    """The quantized codec to use toward a peer: the locally requested
    one when the peer's HELLO advertised it under ``"qz"``, else None
    (mixed-version or knob-unset peers negotiate down to lossless)."""
    if requested is None or requested not in (theirs or ()):
        return None
    return requested


# -- message segments (K_BATCH) -----------------------------------------
def pack_segment(frame: bytes, bufs: Sequence[Any]) -> bytes:
    """One in-band message segment: pickle frame + copied buffers."""
    parts = [_SEG.pack(len(frame), len(bufs))]
    parts += [_U64.pack(len(b) if isinstance(b, (bytes, bytearray))
                        else b.nbytes) for b in bufs]
    parts.append(frame)
    parts += [bytes(b) for b in bufs]
    return b"".join(parts)


def pack_batch(segments: Sequence[bytes]) -> List[bytes]:
    """Body pieces of a K_BATCH frame holding ``segments`` messages."""
    return [_BATCH.pack(K_BATCH, len(segments)), *segments]


def parse_batch(body: memoryview) -> Iterator[Tuple[memoryview,
                                                    List[memoryview]]]:
    """Yield (pickle_frame, [buffers]) per coalesced message. The
    yielded views alias ``body`` — zero extra copy on the receive
    side; arrays reconstructed over them are read-only."""
    _kind, nmsgs = _BATCH.unpack_from(body, 0)
    off = _BATCH.size
    for _ in range(nmsgs):
        flen, nbufs = _SEG.unpack_from(body, off)
        off += _SEG.size
        sizes = [_U64.unpack_from(body, off + 8 * i)[0]
                 for i in range(nbufs)]
        off += 8 * nbufs
        frame = body[off:off + flen]
        off += flen
        bufs = []
        for sz in sizes:
            bufs.append(body[off:off + sz])
            off += sz
        yield frame, bufs
    if off != len(body):
        raise ValueError(
            f"batch frame desync: parsed {off} of {len(body)} bytes")


# -- chunked transfers (K_XFER_HDR / K_CHUNK) ---------------------------
def pack_xfer_hdr(xfer_id: int, frame: bytes,
                  bufspecs: Sequence[Tuple[int, int, Optional[Any]]]
                  ) -> bytes:
    """Header of a chunked message. ``bufspecs``: per pickle-5 buffer,
    (flags, size, inline_bytes-or-None) in buffer order; ``flags`` is
    a BUF_CHUNKED|BUF_QUANT bitmask (plain bools read as BUF_CHUNKED,
    the pre-quantization spelling). Chunked buffers announce size
    only, their bytes follow as K_CHUNK frames; a BUF_QUANT size is
    the ENCODED byte count (the self-describing raw length travels
    inside the encoding)."""
    parts = [_XFER.pack(K_XFER_HDR, xfer_id, len(frame), len(bufspecs))]
    parts += [_BUFSPEC.pack(int(flags), size)
              for (flags, size, _b) in bufspecs]
    parts.append(frame)
    parts += [bytes(b) for (flags, _s, b) in bufspecs
              if not int(flags) & BUF_CHUNKED]
    return b"".join(parts)


def parse_xfer_hdr(body: memoryview) -> Tuple[int, memoryview,
                                              List[Tuple[int, int,
                                                         Optional[memoryview]]]]:
    _kind, xfer_id, flen, nbufs = _XFER.unpack_from(body, 0)
    off = _XFER.size
    specs = []
    for i in range(nbufs):
        flags, size = _BUFSPEC.unpack_from(body, off)
        specs.append([int(flags), size, None])
        off += _BUFSPEC.size
    frame = body[off:off + flen]
    off += flen
    for spec in specs:
        if not spec[0] & BUF_CHUNKED:
            spec[2] = body[off:off + spec[1]]
            off += spec[1]
    if off != len(body):
        raise ValueError(
            f"xfer header desync: parsed {off} of {len(body)} bytes")
    return xfer_id, frame, [tuple(s) for s in specs]


def pack_chunk_hdr(xfer_id: int, buf_index: int, offset: int) -> bytes:
    return _CHUNK.pack(K_CHUNK, xfer_id, buf_index, offset)


def parse_chunk(body: memoryview) -> Tuple[int, int, int, memoryview]:
    _kind, xfer_id, buf_index, offset = _CHUNK.unpack_from(body, 0)
    return xfer_id, buf_index, offset, body[_CHUNK.size:]


class RxXfer:
    """Receive-side reassembly of one chunked message."""

    __slots__ = ("frame", "bufs", "remaining", "nbytes", "quant")

    def __init__(self, frame: memoryview,
                 bufspecs: Sequence[Tuple[int, int, Optional[memoryview]]]
                 ) -> None:
        # the pickle frame must outlive the enclosing frame body
        self.frame = bytes(frame)
        self.bufs: List[Any] = []
        self.quant: List[bool] = []     # buffer needs dequantization
        self.remaining = 0
        self.nbytes = len(self.frame)
        for (flags, size, inline) in bufspecs:
            self.nbytes += size
            self.quant.append(bool(int(flags) & BUF_QUANT))
            if int(flags) & BUF_CHUNKED:
                self.bufs.append(bytearray(size))
                self.remaining += size
            else:
                self.bufs.append(bytes(inline))

    def feed(self, buf_index: int, offset: int, data: memoryview) -> bool:
        """Land one chunk; True when the whole message has arrived."""
        buf = self.bufs[buf_index]
        if not isinstance(buf, bytearray):
            raise ValueError(f"chunk for non-chunked buffer {buf_index}")
        n = len(data)
        if offset + n > len(buf):
            raise ValueError(
                f"chunk overruns buffer {buf_index}: "
                f"{offset}+{n} > {len(buf)}")
        buf[offset:offset + n] = data
        self.remaining -= n
        return self.remaining <= 0

    def message(self) -> Any:
        bufs = [dequantize_buffer(b) if q else b
                for b, q in zip(self.bufs, self.quant)]
        return pickle.loads(self.frame, buffers=bufs)


class _HostPickler(pickle.Pickler):
    """pickle.Pickler that refuses torch tensors (see the module
    docstring); every other object pickles exactly as ``pickle.dumps``
    would, so the bytes match the JAX package's frames."""

    def reducer_override(self, obj: Any) -> Any:
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            raise TypeError(
                f"a torch.Tensor ({tuple(obj.shape)}, {obj.dtype}, "
                f"{obj.device}) reached the comm wire: stage it to a "
                f"numpy array (or move it on the device data plane)")
        return NotImplemented


def dumps_message(msg: Any, protocol: int = 5,
                  buffer_callback: Any = None) -> bytes:
    """``pickle.dumps(msg, protocol, buffer_callback=...)`` that raises
    TypeError on a torch tensor anywhere in ``msg``."""
    buf = io.BytesIO()
    _HostPickler(buf, protocol=protocol,
                 buffer_callback=buffer_callback).dump(msg)
    return buf.getvalue()


def load_message(frame: memoryview, bufs: Sequence[Any]) -> Any:
    """Unpickle one (src, tag, payload) message segment."""
    return pickle.loads(frame, buffers=list(bufs))


# -- heartbeats ----------------------------------------------------------
def pack_ping(seq: int, t_ns: int, pong: bool = False,
              clock_ns: Optional[int] = None) -> bytes:
    """One heartbeat frame; the pong echoes the ping's (seq, t_ns).

    ``clock_ns`` is the clock-alignment extension (the ``"tr"`` HELLO
    capability): when not None the frame grows a trailing u64 carrying
    the SENDER's monotonic clock.  An extended PING marks the exchange
    (the value itself is unused, 0 by convention); the answering pong
    stamps its responder clock there, which is the midpoint-method
    sample the receiver folds into its per-peer offset EWMA.
    ``clock_ns=None`` keeps the original 13-byte frame bit-for-bit, so
    a knob-unset build and every frame toward a peer without the
    capability are byte-identical; parsers read the leading fields
    positionally and ignore the trailing u64."""
    kind = K_PONG if pong else K_PING
    if clock_ns is None:
        return _PING.pack(kind, seq & 0xFFFFFFFF, t_ns)
    return _PINGX.pack(kind, seq & 0xFFFFFFFF, t_ns, clock_ns)


def parse_ping(body: memoryview) -> Tuple[int, int]:
    """-> (seq, t_ns); same layout for K_PING and K_PONG (extended
    frames carry a trailing clock word read via :func:`ping_clock`)."""
    _kind, seq, t_ns = _PING.unpack_from(body, 0)
    return seq, t_ns


def ping_clock(body: memoryview) -> Optional[int]:
    """The clock-alignment extension word of a K_PING/K_PONG frame
    (None on a plain 13-byte frame — a peer without the capability, or
    with the knob unset, never sends the extension)."""
    if len(body) < _PINGX.size:
        return None
    return _PINGX.unpack_from(body, 0)[3]


# -- elastic membership (ft/elastic.py) ---------------------------------
def pack_elastic(payload: Dict[str, Any]) -> bytes:
    """One membership frame (view / join / welcome / commit / abort)."""
    return bytes([K_ELASTIC]) + pickle.dumps(payload, protocol=4)


def parse_elastic(body: memoryview) -> Dict[str, Any]:
    return pickle.loads(body[1:])


# -- runtime tuning (tune/controller.py; the "tn" HELLO capability) -----
def pack_tune(payload: Dict[str, Any]) -> bytes:
    """One runtime-tuning control frame (e.g. a per-link quantized
    codec renegotiation, ``{"op": "codec", "codec": name-or-None}``).
    Session-less like K_ELASTIC: handled on the receiver THREAD, never
    wrapped in K_SEQ (a renegotiation is regenerated, not replayed —
    and quantization happens at enqueue, so the replay window already
    holds bytes encoded under the codec active at enqueue time)."""
    return bytes([K_TUNE]) + pickle.dumps(payload, protocol=4)


def parse_tune(body: memoryview) -> Dict[str, Any]:
    return pickle.loads(body[1:])


# -- multi-tenant serving (serve/; the "sv" HELLO capability) -----------
#: serve control protocol version — bumped when the envelope grows
#: fields an old server cannot ignore
SERVE_PROTO_VERSION = 1


def serve_request(op: str, req: int, tenant: Optional[str] = None,
                  **kw: Any) -> Dict[str, Any]:
    """Envelope of one serve control request (open/submit/wait/stats).
    Serve control rides TAG_SERVE active messages — the AM layer
    already frames and pickles dict payloads, so no new frame kind is
    needed; the envelope just pins the field names and a version so
    ServeClient and SessionServer agree across builds."""
    msg: Dict[str, Any] = {"sv": SERVE_PROTO_VERSION, "op": str(op),
                           "req": int(req)}
    if tenant is not None:
        msg["tenant"] = str(tenant)
    msg.update(kw)
    return msg


def serve_reply(req: int, ok: bool, **kw: Any) -> Dict[str, Any]:
    """Envelope of one serve control reply, correlated by ``req``."""
    msg: Dict[str, Any] = {"sv": SERVE_PROTO_VERSION, "req": int(req),
                           "ok": bool(ok)}
    msg.update(kw)
    return msg


def parse_serve(payload: Any) -> Dict[str, Any]:
    """Validate one serve envelope (either direction); raises
    ValueError on a malformed dict or an unsupported version so the
    endpoint can reply with a loud error instead of misbehaving."""
    if not isinstance(payload, dict) or "sv" not in payload:
        raise ValueError("not a serve envelope")
    v = int(payload.get("sv") or 0)
    if v < 1 or v > SERVE_PROTO_VERSION:
        raise ValueError(f"unsupported serve protocol version {v}")
    if "req" not in payload:
        raise ValueError("serve envelope missing req id")
    return payload


# -- reliable session (comm/tcp.py "rs" capability) ---------------------
SEQ_HDR_LEN = _SEQHDR.size


def pack_seq(epoch: int, seq: int) -> bytes:
    """Envelope header prepended to one data frame body."""
    return _SEQHDR.pack(K_SEQ, epoch & 0xFFFFFFFF, seq)


def parse_seq(body: memoryview) -> Tuple[int, int, memoryview]:
    """-> (epoch, seq, inner body)."""
    _kind, epoch, seq = _SEQHDR.unpack_from(body, 0)
    return epoch, seq, body[_SEQHDR.size:]


def parse_seq_prefix(buf) -> Optional[Tuple[int, int]]:
    """(epoch, seq) when ``buf`` begins with a complete K_SEQ header
    (the partial-frame resume claim), else None."""
    if len(buf) < _SEQHDR.size or buf[0] != K_SEQ:
        return None
    _kind, epoch, seq = _SEQHDR.unpack_from(buf, 0)
    return epoch, seq


def pack_ack(epoch: int, seq: int) -> bytes:
    """Cumulative ack: every seq up to ``seq`` was delivered."""
    return _SEQHDR.pack(K_ACK, epoch & 0xFFFFFFFF, seq)


def parse_ack(body: memoryview) -> Tuple[int, int]:
    _kind, epoch, seq = _SEQHDR.unpack_from(body, 0)
    return epoch, seq


def pack_resume(info: Dict[str, Any]) -> bytes:
    """Reconnect handshake frame ({"rank", "epoch", "ack", "partial"})."""
    return bytes([K_RESUME]) + pickle.dumps(info, protocol=4)


def parse_resume(body: memoryview) -> Dict[str, Any]:
    return pickle.loads(body[1:])


def pack_frag(epoch: int, seq: int, offset: int) -> bytes:
    """Header of a byte-level frame resume (remainder bytes follow)."""
    return _FRAGHDR.pack(K_FRAG, epoch & 0xFFFFFFFF, seq, offset)


def parse_frag(body: memoryview) -> Tuple[int, int, int, memoryview]:
    _kind, epoch, seq, offset = _FRAGHDR.unpack_from(body, 0)
    return epoch, seq, offset, body[_FRAGHDR.size:]


# -- hello / compression ------------------------------------------------
def pack_hello(info: Dict[str, Any]) -> bytes:
    return bytes([K_HELLO]) + pickle.dumps(info, protocol=4)


def parse_hello(body: memoryview) -> Dict[str, Any]:
    return pickle.loads(body[1:])


def compress_body(body: bytes, codec: str) -> Optional[List[bytes]]:
    """K_COMP pieces for ``body``, or None when compression does not
    pay (the compressed form is not smaller)."""
    ent = CODECS[codec]
    if not ent.lossless:
        raise ValueError(
            f"{codec}: quantized codecs never compress frame BODIES "
            f"(a lossy transform of a pickled body would corrupt it)")
    out = ent.comp(body)
    if len(out) + _COMP.size >= len(body):
        return None
    return [_COMP.pack(K_COMP, ent.cid, len(body)), out]


def decompress_body(body: memoryview) -> bytes:
    _kind, cid, raw_len = _COMP.unpack_from(body, 0)
    ent = _CODEC_BY_ID.get(cid)
    if ent is None or not ent[1].lossless:
        raise ValueError(f"unknown compression codec id {cid}")
    out = ent[1].dec(bytes(body[_COMP.size:]))
    if len(out) != raw_len:
        raise ValueError(
            f"decompressed length {len(out)} != announced {raw_len}")
    return out


# -- quantized tile codecs (lossy; the "qz" HELLO capability) -----------
#: elements per int8 scale block (one f32 scale each); a pure function
#: of the codec version — both ends derive block counts from it
QUANT_BLOCK = 512

#: flags of a transfer-header bufspec (``pack_xfer_hdr``): bit 0 = the
#: buffer's bytes follow as K_CHUNK frames, bit 1 = the announced bytes
#: are a quantized encoding the receiver must decode before unpickling
BUF_CHUNKED = 1
BUF_QUANT = 2

_QHDR = struct.Struct("<BBQI")   # codec_id, dtype_code, raw_len, block
_QDTYPES = {"d": (0, np.float64), "f": (1, np.float32)}
_QDTYPE_BY_CODE = {0: np.float64, 1: np.float32}


def _enc_bf16(x: np.ndarray) -> bytes:
    """Round-to-nearest-even bfloat16 of a float array (f64 narrows
    through f32 first, like an XLA bf16 cast would)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    # RNE: add 0x7FFF + the current LSB of the kept half, then truncate
    return (((u + np.uint32(0x7FFF) + ((u >> np.uint32(16))
                                       & np.uint32(1)))
             >> np.uint32(16)).astype(np.uint16)).tobytes()


def _dec_bf16(payload: memoryview, n: int, dt) -> bytes:
    u16 = np.frombuffer(payload, np.uint16, count=n)
    f32 = (u16.astype(np.uint32) << np.uint32(16)).view(np.float32)
    return np.ascontiguousarray(f32, dt).tobytes()


def _enc_int8(x: np.ndarray) -> bytes:
    """Blockwise int8: per QUANT_BLOCK-element block one f32 scale
    (absmax/127); values quantize to round(x/scale) in [-127, 127]."""
    n = x.size
    nblocks = max(1, (n + QUANT_BLOCK - 1) // QUANT_BLOCK)
    xp = np.zeros(nblocks * QUANT_BLOCK, np.float32)
    xp[:n] = np.ascontiguousarray(x, np.float32)
    xb = xp.reshape(nblocks, QUANT_BLOCK)
    scales = (np.abs(xb).max(axis=1) / 127.0).astype(np.float32)
    inv = np.zeros_like(scales)
    np.divide(1.0, scales, out=inv, where=scales > 0)
    q = np.clip(np.rint(xb * inv[:, None]), -127, 127).astype(np.int8)
    return scales.tobytes() + q.reshape(-1)[:n].tobytes()


def _dec_int8(payload: memoryview, n: int, dt) -> bytes:
    nblocks = max(1, (n + QUANT_BLOCK - 1) // QUANT_BLOCK)
    scales = np.frombuffer(payload, np.float32, count=nblocks)
    q = np.frombuffer(payload, np.int8, count=n, offset=4 * nblocks)
    xp = np.zeros(nblocks * QUANT_BLOCK, np.float32)
    xp[:n] = q
    out = (xp.reshape(nblocks, QUANT_BLOCK)
           * scales[:, None]).reshape(-1)[:n]
    return np.ascontiguousarray(out, dt).tobytes()


CODECS["qbf16"] = Codec(16, _enc_bf16, _dec_bf16, lossless=False)
CODECS["qint8"] = Codec(17, _enc_int8, _dec_int8, lossless=False)
_CODEC_BY_ID = {c.cid: (name, c) for name, c in CODECS.items()}


def quantize_buffer(view: Any, fmt: str, codec: str) -> bytes:
    """Encode one flat float buffer (``fmt`` = 'd'/'f', the buffer
    protocol format of the ORIGINAL array) with a quantized codec.
    The returned bytes are self-describing (``_QHDR`` leads them)."""
    ent = CODECS[codec]
    dcode, dt = _QDTYPES[fmt]
    x = np.frombuffer(view, dtype=dt)
    return _QHDR.pack(ent.cid, dcode, x.nbytes, QUANT_BLOCK) \
        + ent.comp(x)


def dequantize_buffer(buf: Any) -> bytes:
    """Decode one quantized buffer back to the exact raw bytes of the
    original dtype/length (lossy in VALUE, exact in layout — the
    unpickler reconstructs the array over them unchanged)."""
    mv = memoryview(buf)
    cid, dcode, raw_len, block = _QHDR.unpack_from(mv, 0)
    ent = _CODEC_BY_ID.get(cid)
    if ent is None or ent[1].lossless:
        raise ValueError(f"unknown quantized codec id {cid}")
    if block != QUANT_BLOCK:
        raise ValueError(
            f"quantized block size {block} != local {QUANT_BLOCK}")
    dt = _QDTYPE_BY_CODE.get(dcode)
    if dt is None:
        raise ValueError(f"unknown quantized dtype code {dcode}")
    n = raw_len // np.dtype(dt).itemsize
    out = ent[1].dec(mv[_QHDR.size:], n, dt)
    if len(out) != raw_len:
        raise ValueError(
            f"dequantized length {len(out)} != announced {raw_len}")
    return out


def quant_raw_len(buf: Any) -> int:
    """Raw (decoded) byte count a quantized buffer stands for, read
    from its self-describing header without decoding the payload."""
    return _QHDR.unpack_from(memoryview(buf), 0)[2]


def qdq_array(arr: np.ndarray, codec: str) -> np.ndarray:
    """Quantize-dequantize round trip of an array: exactly the values
    a quantized wire transfer would deliver (shared by the reduced-
    precision collective lane so wire and lane quantize identically)."""
    a = np.ascontiguousarray(arr)
    fmt = {"float64": "d", "float32": "f"}.get(a.dtype.name)
    if fmt is None:
        return arr
    raw = dequantize_buffer(
        quantize_buffer(memoryview(a).cast("B"), fmt, codec))
    return np.frombuffer(raw, dtype=a.dtype).reshape(a.shape).copy()
