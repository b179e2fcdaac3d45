"""Hopper flash-attention forward: build, bind and launch.

The CUDA source (``csrc/flash_attention_fwd.cu``) replaces the TPU kernel
``flash_attention_fwd`` of ``src/repro/kernels/flash_attention/kernel.py``.
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C entry point (``kernels/_build.py``, at first use) and loaded with
``ctypes``. Importing this module needs neither ``nvcc`` nor a card.

``launches`` counts kernel launches: it is incremented where the kernel is
launched and nowhere else.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_fwd.cu"
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_lib = None
_lib_lock = threading.Lock()


def build() -> Path:
    """The kernel's shared library, compiled if this source is new."""
    return _build.build(SOURCE)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.fa_fwd
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                           + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(q, k, v, kv_len):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_fwd takes CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B,S,H,d)")
    B, Sq, H, dq = q.shape
    Bk, Skv, KV, dk = k.shape
    if Bk != B or dk != dq or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do not fit together")
    dv = v.shape[3]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} q heads are not a multiple of {KV} kv heads")
    if not (1 <= dq <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims dq={dq} dv={dv} outside 1..{MAX_HEAD_DIM}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    if not 1 <= kv_len <= Skv:
        raise ValueError(f"kv_len={kv_len} outside 1..{Skv}")
    return B, Sq, H, dq, Skv, KV, dv


def flash_attention_fwd(q, k, v, *, scale: float, causal: bool = True,
                        kv_len: int | None = None):
    """q (B,Sq,H,dq), k (B,Skv,KV,dq), v (B,Skv,KV,dv) -> (B,Sq,H,dv).

    Launches the Hopper kernel on the current stream; raises if the
    arguments do not fit it, if the build fails or if the launch is
    refused. Does not synchronise.
    """
    global launches
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    B, Sq, H, dq, Skv, KV, dv = _check(q, k, v, kv_len)
    lib = _load()
    o = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.fa_fwd(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), B, H, KV, Sq, Skv, dq, dv,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *o.stride()[:3], float(scale), int(bool(causal)),
                     kv_len, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return o
