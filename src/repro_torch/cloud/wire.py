"""Content manifests of values, aware of torch tensors.

The manifest part of the reference's wire format
(``repro.cloud.wire``): a value is flattened by structural recursion
(dict / list / tuple / namedtuple); array leaves are lifted out as raw
contiguous byte buffers, each split into ``CHUNK_BYTES`` windows tagged
with a truncated SHA-256, and the remaining skeleton (containers,
scalars, strings, ``None``) is pickled. MDSS indexes the chunk digests per
tier (dedup-aware transfer accounting) and keys step memoization on the
content digest.

A tensor on a device is copied to the host to be hashed. A bfloat16
tensor, which numpy cannot hold, is hashed as its 16-bit pattern and
tagged ``bfloat16`` in the skeleton, so it never collides with an int16
array of the same bits. Framing and sockets come with the fabric.
"""
from __future__ import annotations

import hashlib
import pickle
from dataclasses import dataclass
from typing import Any, List, Tuple

import numpy as np
import torch

CHUNK_BYTES = 1 << 20                # transfer/dedup granularity
DIGEST_BYTES = 16                    # truncated sha256


def digest_of(data) -> bytes:
    """Truncated SHA-256 of a bytes-like (OpenSSL-accelerated)."""
    return hashlib.sha256(data).digest()[:DIGEST_BYTES]


@dataclass(frozen=True)
class _Buf:
    """Skeleton placeholder for an array leaf lifted into ``buffers``."""
    idx: int
    dtype: str
    shape: Tuple[int, ...]


def _as_bytes_view(a: np.ndarray) -> memoryview:
    """Flat byte view of a contiguous array — no copy on the happy path."""
    try:
        return memoryview(a.reshape(-1)).cast("B")
    except (TypeError, ValueError):
        return memoryview(a.tobytes())


def _tensor_host_bytes(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().contiguous().numpy(), "bfloat16"
    a = t.cpu().contiguous().numpy()
    return a, a.dtype.str


def _strip(obj, buffers: List[memoryview]):
    if isinstance(obj, torch.Tensor):
        a, tag = _tensor_host_bytes(obj)
        buffers.append(_as_bytes_view(a))
        return _Buf(len(buffers) - 1, tag, tuple(obj.shape))
    if isinstance(obj, np.ndarray) and obj.dtype != object:
        a = np.ascontiguousarray(obj)
        buffers.append(_as_bytes_view(a))
        return _Buf(len(buffers) - 1, a.dtype.str, a.shape)
    if isinstance(obj, dict):
        return {k: _strip(v, buffers) for k, v in obj.items()}
    if isinstance(obj, tuple):
        vals = [_strip(v, buffers) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    if isinstance(obj, list):
        return [_strip(v, buffers) for v in obj]
    return obj


def manifest_of(value: Any, chunk_bytes: int = CHUNK_BYTES
                ) -> Tuple[bytes, List[Tuple[bytes, int]]]:
    """``(content_digest, [(chunk_digest, length), ...])`` of a value.

    The chunk list is what a content-addressed store indexes (which
    chunks are resident where); the content digest — skeleton pickle +
    chunk digests — identifies the whole value for step memoization.
    """
    buffers: List[memoryview] = []
    skeleton = _strip(value, buffers)
    h = hashlib.sha256(pickle.dumps(skeleton,
                                    protocol=pickle.HIGHEST_PROTOCOL))
    chunks: List[Tuple[bytes, int]] = []
    for mv in buffers:
        n = mv.nbytes
        for off in range(0, n, chunk_bytes):
            piece = mv[off:off + chunk_bytes]
            d = digest_of(piece)
            chunks.append((d, len(piece)))
            h.update(d)
    return h.digest()[:DIGEST_BYTES], chunks


def content_digest(value: Any) -> bytes:
    """Digest identifying a value's full content (structure + bytes)."""
    return manifest_of(value)[0]
