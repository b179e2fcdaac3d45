"""SHA-256 of tensors' chunks on the card: build, bind and launch.

The CUDA source (``csrc/sha256_chunks.cu``) replaces no TPU kernel: the
JAX package hashes MDSS's values on the host. It computes what
``wire.digest_buffers`` computes for one leaf: the truncated SHA-256
(``wire.DIGEST_BYTES``) of each ``CHUNK_BYTES`` piece of the leaf's
C-order bytes, the bytes ``wire.host_buffers`` would copy to the host (a
bfloat16 leaf as its 16-bit patterns). Only the digests come back. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain
C entry point (``kernels/_build.py``, at first use) and loaded with
``ctypes``. Importing this module needs neither ``nvcc`` nor a card.

Bounds on one H100 (the source has the arithmetic): the train cell's
9.54 GB of state in ~9,100 chunks move in 2.85 ms at 3.35 TB/s; SHA-256's
1,400 integer operations per 64-byte block (in three-input instructions)
take 12.5 ms over 132 SMs x 64 ALU lanes; one chunk's chain of 16,385
compressions on one warp takes at least 11.6 ms at one instruction a
cycle (21-27 ms measured), and that is the kernel's time for any number
of chunks up to ~16,900.

``chunk_digests`` builds one table of (pointer, length, output) rows for
every chunk of every CUDA leaf it is given, in one ``torch.empty`` on the
card after the digests' slots, launches once per device and reads the
digests back with one synchronisation. A leaf that is not contiguous, or
whose address is not 16-byte aligned, is copied on the card first. CPU
tensors take the plain version, the host path itself. ``launches`` counts
launches of the kernel: it is incremented where the kernel is launched
and nowhere else.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.cloud.wire import (CHUNK_BYTES, DIGEST_BYTES, digest_buffers,
                                    host_buffers)
from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "sha256_chunks.cu"
_ROW = 3                 # int64 words of a table row: src, len, out
_OUT = DIGEST_BYTES // 8  # int64 words of a digest

launches = 0
_lib = None
_lib_lock = threading.Lock()


def build() -> Path:
    """The kernel's shared library, compiled if this source is new."""
    return _build.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                lib.sha256_chunks.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_void_p]
                lib.sha256_chunks.restype = ctypes.c_int
                _lib = lib
    return _lib


def plain(t: torch.Tensor) -> List[bytes]:
    """The chunk digests of a CPU tensor, as the host path takes them."""
    skeleton, buffers, _ = host_buffers(t)
    return [d for d, _ in digest_buffers(skeleton, buffers)[1]]


def chunk_digests(tensors: Sequence[torch.Tensor]) -> List[List[bytes]]:
    """Per tensor, the truncated SHA-256 of each ``CHUNK_BYTES`` piece of
    its C-order bytes, as ``wire.digest_buffers`` gives them.

    CUDA tensors are hashed by the kernel, one launch per device and one
    synchronisation to read the digests back; CPU tensors by the plain
    version. Raises for a tensor on any other device, if the build fails
    or if a launch is refused."""
    out: List[List[bytes]] = [[] for _ in tensors]
    on_card: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        if t.device.type == "cpu":
            out[i] = plain(t)
        elif t.device.type == "cuda":
            on_card.setdefault(t.device, []).append(i)
        else:
            raise ValueError(f"sha256_chunks takes CUDA or CPU tensors, got "
                             f"one on {t.device}")
    for idx in on_card.values():
        got = _run([tensors[i] for i in idx], CHUNK_BYTES, _launch)
        for i, ds in zip(idx, got):
            out[i] = ds
    return out


def _flat(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it on its device that is contiguous and 16-byte
    aligned: the bytes ``wire.host_buffers`` would copy to the host."""
    t = t.detach()
    if not t.is_contiguous():
        t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def _run(tensors: Sequence[torch.Tensor], chunk_bytes: int,
         launch: Callable[[torch.Tensor, int], None]) -> List[List[bytes]]:
    """Makes each tensor contiguous and aligned, builds the rows of its
    ``chunk_bytes`` chunks (``wire.digest_buffers``' boundaries; a
    multiple of 16, as the kernel's loads need), calls ``launch(table,
    n)`` once on the (n, 3) int64 table on the tensors' device and reads
    the digests back. Device-agnostic, so the CPU tests drive it with a
    stand-in for ``_launch`` and small chunks."""
    flat = [_flat(t) for t in tensors if t.nbytes]
    counts = [-(-t.nbytes // chunk_bytes) for t in flat]
    n = sum(counts)
    if n == 0:
        return [[] for _ in tensors]
    # one buffer: the digests first (16-byte aligned), then the table
    buf = torch.empty(n * (_OUT + _ROW), dtype=torch.int64,
                      device=flat[0].device)
    rows = np.empty((n, _ROW), dtype=np.int64)
    at = 0
    for t, k in zip(flat, counts):
        off = np.arange(k, dtype=np.int64) * chunk_bytes
        rows[at:at + k, 0] = t.data_ptr() + off
        rows[at:at + k, 1] = np.minimum(chunk_bytes, t.nbytes - off)
        at += k
    rows[:, 2] = buf.data_ptr() + DIGEST_BYTES * np.arange(n, dtype=np.int64)
    host = torch.from_numpy(rows)
    if buf.is_cuda:              # a pinned source copies without a sync
        host = host.pin_memory()
    table = buf[_OUT * n:].view(n, _ROW)
    table.copy_(host, non_blocking=True)
    launch(table, n)
    # the one synchronisation; ``flat`` is held until the kernel read it
    raw = buf[:_OUT * n].cpu().numpy().tobytes()
    digests = [raw[i:i + DIGEST_BYTES]
               for i in range(0, len(raw), DIGEST_BYTES)]
    out, at, it = [], 0, iter(counts)
    for t in tensors:
        k = next(it) if t.nbytes else 0
        out.append(digests[at:at + k])
        at += k
    return out


def _launch(table: torch.Tensor, n: int):
    """One launch over the ``n`` rows of ``table`` on its device's current
    stream."""
    global launches
    lib = _load()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.sha256_chunks(table.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"sha256_chunks launch failed: CUDA error {err}")
    launches += 1
