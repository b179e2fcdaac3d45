"""Content-addressed streaming wire format for the offload fabric.

The port of ``repro.cloud.wire``. Workers must start fast and hold no
framework, so this module imports only numpy + stdlib: framing, the chunk
stores, ``encode`` / ``decode`` and the manifests never import torch. A
value is flattened by structural recursion (dict / list / tuple /
namedtuple); array leaves are lifted out as raw contiguous byte buffers,
and the remaining skeleton (containers, scalars, strings, ``None``) is
pickled.

Array leaves are numpy arrays and torch tensors. A tensor can exist only
in a process that has imported torch, so the tensor branch looks torch up
in ``sys.modules`` instead of importing it: a tensor on a device is copied
to the host, and a bfloat16 tensor (numpy has no bfloat16) travels as its
16-bit pattern tagged ``bfloat16`` in the skeleton, so it never collides
with an int16 array of the same bits. The receiver rebuilds such a buffer
as a :class:`BF16Bits` array — the same bits, still tagged — which a
worker without torch carries through unchanged: a value that crosses
into a worker and back encodes to the same bytes and the same digests.
Turning decoded arrays back into tensors on a device is the driver's job
(``rpc_transport``), which knows the dtype and device each leaf had.

Each buffer is split into ``CHUNK_BYTES`` windows tagged with a truncated
SHA-256 digest; the header frame (skeleton pickle + per-buffer chunk
manifest) goes first, then each chunk streams as its own wire unit — the
receiver allocates the destination buffer up front and ``recv_into``s
chunks directly. With a :class:`ChannelStore`, chunks the peer is known
to hold are sent as **digest references** instead of bytes. A reference
to a digest the receiver does not hold, a digest mismatch on an inline
chunk, or a malformed header raise :class:`WireError` immediately
instead of desynchronising or hanging the stream.

Dedup bookkeeping never negotiates: each direction of a socket is an
ordered stream, so the sender's record of what it has sent (``sent``)
and the receiver's cache of what it has received (``received``) see the
same chunk insertions in the same order and evict FIFO at the same cap —
the sender's copy is an exact mirror of the receiver's, and a chunk is
referenced only when the mirror still holds it. Cross-direction
references (echoing back a value just received) resolve against the
opposite store pair. A connection whose send was interrupted mid-plan
must discard its stores (the broker kills the worker instead).

``send_msg`` / ``recv_msg`` return the framed byte count so every
cross-process movement is accounted — these counts are what
``RPCTransport`` feeds back into the cost model as observed wire
bandwidth, and with dedup they reflect the bytes that *actually*
crossed, not the logical payload size.
"""
from __future__ import annotations

import hashlib
import pickle
import struct
import sys
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"EMW2"
_HEAD = struct.Struct("!4sQ")        # magic + header pickle length

CHUNK_BYTES = 1 << 20                # transfer/dedup granularity
DIGEST_BYTES = 16                    # truncated sha256
STORE_BYTES = 128 << 20              # per-direction chunk cache cap
_MAX_HEADER = 1 << 31

_INLINE, _REF = 0, 1


class WireError(ValueError):
    pass


def digest_of(data) -> bytes:
    """Truncated SHA-256 of a bytes-like (OpenSSL-accelerated)."""
    return hashlib.sha256(data).digest()[:DIGEST_BYTES]


# ------------------------------------------------------------- chunk stores
class ChunkStore:
    """One direction's content-addressed chunk cache.

    Mirrored FIFO: both endpoints of a socket direction insert the same
    chunks in the same (stream) order and evict oldest-first at the same
    byte cap, so a sender's ``sent`` store is an exact model of the
    receiver's ``received`` store — a sender never references a chunk
    the receiver has already evicted. Insertions never reorder (no LRU
    touch), which is what keeps the two copies in lockstep.
    """

    def __init__(self, max_bytes: int = STORE_BYTES):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._chunks: "OrderedDict[bytes, bytes]" = OrderedDict()
        self.bytes_held = 0
        self.evicted = 0

    def has(self, d: bytes) -> bool:
        with self._lock:
            return d in self._chunks

    def get(self, d: bytes) -> Optional[bytes]:
        with self._lock:
            return self._chunks.get(d)

    def add(self, d: bytes, data: bytes):
        with self._lock:
            if d in self._chunks:
                return
            self._chunks[d] = data
            self.bytes_held += len(data)
            while self.bytes_held > self.max_bytes and self._chunks:
                _, old = self._chunks.popitem(last=False)
                self.bytes_held -= len(old)
                self.evicted += 1

    def __len__(self):
        with self._lock:
            return len(self._chunks)


class ChannelStore:
    """Per-connection dedup state (one per socket endpoint).

    ``sent`` mirrors what the peer has received from us; ``received``
    holds what we received (and mirrors the peer's ``sent``). A sender
    may reference any chunk present in either — the peer's pair holds
    it — and a receiver resolves references against both.
    """

    def __init__(self, max_bytes: int = STORE_BYTES):
        self.sent = ChunkStore(max_bytes)
        self.received = ChunkStore(max_bytes)
        self.dedup_chunks = 0        # chunks sent as refs
        self.saved_bytes = 0         # payload bytes dedup kept off the wire

    def known(self, d: bytes) -> bool:
        return self.sent.has(d) or self.received.has(d)

    def lookup(self, d: bytes) -> Optional[bytes]:
        got = self.received.get(d)
        return got if got is not None else self.sent.get(d)

    def stats(self) -> dict:
        """Dedup effectiveness + cache occupancy for this connection."""
        return {
            "dedup_chunks": self.dedup_chunks,
            "saved_bytes": self.saved_bytes,
            "sent_chunks": len(self.sent),
            "sent_bytes_held": self.sent.bytes_held,
            "received_chunks": len(self.received),
            "received_bytes_held": self.received.bytes_held,
            "evicted": self.sent.evicted + self.received.evicted,
        }


# ------------------------------------------------------------- tree <-> wire
@dataclass(frozen=True)
class _Buf:
    """Skeleton placeholder for an array leaf lifted into ``buffers``."""
    idx: int
    dtype: str
    shape: Tuple[int, ...]


class BF16Bits(np.ndarray):
    """A bfloat16 array held by numpy as its 16-bit patterns (int16).

    What the receiver of a ``bfloat16``-tagged buffer gets: numpy has no
    bfloat16, and a worker has no torch. Encoding one again tags it
    ``bfloat16`` again, so the value crosses back bit for bit."""


def _as_bytes_view(a: np.ndarray) -> memoryview:
    """Flat byte view of a contiguous array — no copy on the happy path."""
    try:
        return memoryview(a.reshape(-1)).cast("B")
    except (TypeError, ValueError):
        return memoryview(a.tobytes())


def _host_array(obj) -> Optional[Tuple[np.ndarray, str]]:
    """``(contiguous host array, dtype tag)`` of an array leaf, else None.

    torch is looked up, never imported: a tensor exists only where torch
    is already loaded."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().contiguous().numpy(), _tensor_tag(obj)
    # ascontiguousarray makes a 0-d array 1-d: reshape keeps the shape, so
    # a scalar array that crosses a worker and back is still 0-d
    if isinstance(obj, BF16Bits):
        a = np.ascontiguousarray(obj.view(np.ndarray)).reshape(obj.shape)
        return a, "bfloat16"
    if isinstance(obj, np.ndarray) and obj.dtype != object:
        a = np.ascontiguousarray(obj).reshape(obj.shape)
        return a, a.dtype.str
    return None


def _tensor_tag(t) -> str:
    """The dtype tag of tensor ``t`` in a skeleton: its numpy dtype's
    ``str``, or ``"bfloat16"`` (whose bytes travel as int16)."""
    torch = sys.modules["torch"]
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return torch.empty(0, dtype=t.dtype).numpy().dtype.str


def on_device(obj) -> bool:
    """Whether ``obj`` is a tensor off the host (torch looked up, never
    imported)."""
    torch = sys.modules.get("torch")
    return (torch is not None and isinstance(obj, torch.Tensor)
            and not obj.is_cpu)


def _strip(obj, buffers: List[Any], moved: Optional[list] = None,
           leave_on_device: bool = False):
    """Skeleton of ``obj``; its array leaves' host bytes go to ``buffers``,
    and ``moved[0]`` (when given) counts the bytes copied off a device.
    With ``leave_on_device`` a tensor off the host goes to ``buffers`` as
    it is."""
    if leave_on_device and on_device(obj):
        buffers.append(obj)
        return _Buf(len(buffers) - 1, _tensor_tag(obj), tuple(obj.shape))
    got = _host_array(obj)
    if got is not None:
        a, tag = got
        buffers.append(_as_bytes_view(a))
        if moved is not None and on_device(obj):
            moved[0] += a.nbytes
        return _Buf(len(buffers) - 1, tag, tuple(a.shape))
    if isinstance(obj, dict):
        return {k: _strip(v, buffers, moved, leave_on_device)
                for k, v in obj.items()}
    if isinstance(obj, tuple):
        vals = [_strip(v, buffers, moved, leave_on_device) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    if isinstance(obj, list):
        return [_strip(v, buffers, moved, leave_on_device) for v in obj]
    return obj


def _fill(obj, buffers: List[Any]):
    if isinstance(obj, _Buf):
        try:
            if obj.dtype == "bfloat16":
                arr = np.frombuffer(buffers[obj.idx], dtype=np.int16)
                return arr.reshape(obj.shape).view(BF16Bits)
            arr = np.frombuffer(buffers[obj.idx], dtype=np.dtype(obj.dtype))
            return arr.reshape(obj.shape)     # bytearray-backed -> writable
        except (ValueError, TypeError) as e:
            raise WireError(f"buffer {obj.idx} does not fit "
                            f"{obj.dtype}{obj.shape}: {e}") from e
    if isinstance(obj, dict):
        return {k: _fill(v, buffers) for k, v in obj.items()}
    if isinstance(obj, tuple):
        vals = [_fill(v, buffers) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    if isinstance(obj, list):
        return [_fill(v, buffers) for v in obj]
    return obj


# ------------------------------------------------------------ send planning
@dataclass
class MsgPlan:
    """A fully planned message: wire parts + byte accounting.

    Planning marks referenced/sent chunks in the store, so a plan MUST be
    sent (or the connection's stores discarded) — the broker plans, stamps
    its byte counters, then streams, and kills the worker on any error.
    """
    parts: List[Any]                 # bytes / memoryview, sendall in order
    nbytes: int                      # bytes that will cross the wire
    payload_bytes: int               # logical size (before dedup)
    saved_bytes: int                 # payload bytes elided as refs
    _keepalive: List[Any] = field(default_factory=list)

    def send(self, sock):
        for p in self.parts:
            sock.sendall(p)


def plan_msg(value: Any, store: Optional[ChannelStore] = None,
             chunk_bytes: int = CHUNK_BYTES) -> MsgPlan:
    buffers: List[memoryview] = []
    skeleton = _strip(value, buffers)
    manifests: List[List[Tuple[Optional[bytes], int, int]]] = []
    chunk_parts: List[memoryview] = []
    saved = 0
    for mv in buffers:
        entries: List[Tuple[Optional[bytes], int, int]] = []
        n = mv.nbytes
        for off in range(0, n, chunk_bytes):
            piece = mv[off:off + chunk_bytes]
            if store is not None:
                d = digest_of(piece)
                if store.known(d):
                    entries.append((d, len(piece), _REF))
                    saved += len(piece)
                    continue
                store.sent.add(d, bytes(piece))
                entries.append((d, len(piece), _INLINE))
            else:
                entries.append((None, len(piece), _INLINE))
            chunk_parts.append(piece)
        manifests.append(entries)
    header = pickle.dumps(
        {"skel": skeleton, "chunks": manifests, "dedup": store is not None},
        protocol=pickle.HIGHEST_PROTOCOL)
    parts: List[Any] = [_HEAD.pack(MAGIC, len(header)), header]
    parts.extend(chunk_parts)
    inline = sum(len(p) for p in chunk_parts)
    payload = _HEAD.size + len(header) + inline + saved
    if store is not None and saved:
        store.dedup_chunks += sum(1 for ents in manifests
                                  for (_, _, m) in ents if m == _REF)
        store.saved_bytes += saved
    return MsgPlan(parts, _HEAD.size + len(header) + inline, payload, saved,
                   _keepalive=buffers)


def send_msg(sock, value: Any, store: Optional[ChannelStore] = None) -> int:
    """Stream ``value`` as header + chunk frames; returns wire bytes."""
    plan = plan_msg(value, store)
    plan.send(sock)
    return plan.nbytes


def encode(value: Any, store: Optional[ChannelStore] = None,
           chunk_bytes: int = CHUNK_BYTES) -> bytes:
    """One-shot encode (the full wire stream as a single bytes)."""
    plan = plan_msg(value, store, chunk_bytes)
    return b"".join(bytes(p) if not isinstance(p, bytes) else p
                    for p in plan.parts)


# ----------------------------------------------------------------- receiving
def _recvall(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise EOFError("socket closed mid-frame")
        buf += chunk
    return bytes(buf)


def _recvall_into(sock, mv: memoryview):
    while len(mv):
        r = sock.recv_into(mv)
        if r == 0:
            raise EOFError("socket closed mid-chunk")
        mv = mv[r:]


class _BytesSource:
    """Adapter so decode-from-bytes shares the streaming parser."""

    def __init__(self, data):
        self.data = memoryview(data)
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise WireError(f"short frame: wanted {n} more bytes")
        out = bytes(self.data[self.off:self.off + n])
        self.off += n
        return out

    def take_into(self, mv: memoryview):
        n = len(mv)
        if self.off + n > len(self.data):
            raise WireError(f"short frame: wanted {n} more bytes")
        mv[:] = self.data[self.off:self.off + n]
        self.off += n


class _SockSource:
    def __init__(self, sock):
        self.sock = sock

    def take(self, n: int) -> bytes:
        return _recvall(self.sock, n)

    def take_into(self, mv: memoryview):
        _recvall_into(self.sock, mv)


def _read_msg(src, store: Optional[ChannelStore]) -> Tuple[Any, int]:
    return _read_body(src.take(_HEAD.size), src, store)


def _read_body(head: bytes, src, store: Optional[ChannelStore]
               ) -> Tuple[Any, int]:
    magic, hlen = _HEAD.unpack(head)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if hlen > _MAX_HEADER:
        raise WireError(f"implausible header length {hlen}")
    try:
        meta = pickle.loads(src.take(hlen))
        skeleton = meta["skel"]
        manifests = meta["chunks"]
        dedup = bool(meta.get("dedup"))
    except WireError:
        raise
    except Exception as e:
        raise WireError(f"undecodable header: {e!r}") from e
    nread = _HEAD.size + hlen
    buffers: List[bytearray] = []
    for entries in manifests:
        total = sum(ln for _, ln, _ in entries)
        buf = bytearray(total)
        mv = memoryview(buf)
        off = 0
        for d, ln, mode in entries:
            dest = mv[off:off + ln]
            if mode == _INLINE:
                src.take_into(dest)
                nread += ln
                if d is not None:
                    if digest_of(dest) != d:
                        raise WireError(
                            f"chunk digest mismatch at offset {off} "
                            f"({ln} bytes): corrupted frame")
                    if dedup and store is not None:
                        store.received.add(d, bytes(dest))
            elif mode == _REF:
                data = store.lookup(d) if store is not None else None
                if data is None or len(data) != ln:
                    raise WireError(
                        f"reference to unknown chunk digest {d!r:.20} "
                        f"({ln} bytes): peer/receiver stores desynced")
                dest[:] = data
            else:
                raise WireError(f"unknown chunk mode {mode!r}")
            off += ln
        buffers.append(buf)
    return _fill(skeleton, buffers), nread


def recv_msg(sock, store: Optional[ChannelStore] = None,
             stats: Optional[Dict[str, float]] = None) -> Tuple[Any, int]:
    """Receive one message; returns ``(value, wire_bytes_read)``.

    With ``stats`` (a dict), fills ``recv_s`` — the wall time from the
    header's arrival to the last chunk, i.e. transfer time excluding the
    idle wait for the message to start. Workers report it back so the
    broker can attribute round-trip time per direction.
    """
    src = _SockSource(sock)
    head = src.take(_HEAD.size)       # blocks idle until a message starts
    t0 = time.perf_counter()
    value, nread = _read_body(head, src, store)
    if stats is not None:
        stats["recv_s"] = time.perf_counter() - t0
        stats["wire_bytes"] = nread
    return value, nread


def decode(data, store: Optional[ChannelStore] = None) -> Any:
    value, _ = _read_msg(_BytesSource(data), store)
    return value


# --------------------------------------------------------------- manifests
def host_buffers(value: Any, leave_on_device: bool = False
                 ) -> Tuple[Any, List[Any], int]:
    """``(skeleton, buffers, device_bytes)``: ``value``'s array leaves as
    host byte views (a tensor on a device is copied to the host), its
    skeleton, and how many of those bytes were on a device. With
    ``leave_on_device`` a tensor off the host is not copied: it stands in
    ``buffers`` as it is, in its place, for the caller to hash."""
    buffers: List[Any] = []
    moved = [0]
    skeleton = _strip(value, buffers, moved, leave_on_device)
    return skeleton, buffers, moved[0]


def digest_buffers(skeleton: Any, buffers: List[Any],
                   chunk_bytes: int = CHUNK_BYTES,
                   digests: Optional[Dict[int, List[bytes]]] = None
                   ) -> Tuple[bytes, List[Tuple[bytes, int]]]:
    """The manifest of :func:`host_buffers`' output: SHA-256 over the
    host bytes, no copy. ``digests`` maps the index of a buffer that was
    kept off the host to its chunk digests, hashed elsewhere over the same
    bytes in the same chunks."""
    h = hashlib.sha256(pickle.dumps(skeleton,
                                    protocol=pickle.HIGHEST_PROTOCOL))
    chunks: List[Tuple[bytes, int]] = []
    for i, buf in enumerate(buffers):
        done = digests.get(i) if digests else None
        n = buf.nbytes
        for k, off in enumerate(range(0, n, chunk_bytes)):
            d = (done[k] if done is not None
                 else digest_of(buf[off:off + chunk_bytes]))
            chunks.append((d, min(chunk_bytes, n - off)))
            h.update(d)
    return h.digest()[:DIGEST_BYTES], chunks


def manifest_of(value: Any, chunk_bytes: int = CHUNK_BYTES
                ) -> Tuple[bytes, List[Tuple[bytes, int]]]:
    """``(content_digest, [(chunk_digest, length), ...])`` of a value.

    The chunk list is what a content-addressed store indexes (which
    chunks are resident where); the content digest — skeleton pickle +
    chunk digests — identifies the whole value for step memoization.
    Here every leaf is copied to the host before the first digest; MDSS
    hashes a value's large CUDA leaves on the card instead
    (``repro_torch.kernels.sha256``), to the same digests.
    """
    skeleton, buffers, _ = host_buffers(value)
    return digest_buffers(skeleton, buffers, chunk_bytes)


def content_digest(value: Any) -> bytes:
    """Digest identifying a value's full content (structure + bytes)."""
    return manifest_of(value)[0]
