"""Hopper flash-attention forward: build, bind and launch.

The CUDA source (``csrc/flash_attention_fwd.cu``) replaces the TPU kernel
``flash_attention_fwd`` of ``src/repro/kernels/flash_attention/kernel.py``.
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C entry point (``kernels/_build.py``, at first use) and loaded with
``ctypes``. Importing this module needs neither ``nvcc`` nor a card.

The source holds three bodies (see its header note). ``_body`` picks one
from the dtype, shapes, strides and alignment alone, never from a failed
launch: ``"tma"`` (TMA loads, wgmma) for bf16 that TMA can address,
``"mma"`` (mma.sync) for the rest of bf16, ``"f32"`` for float32.

``launches`` counts kernel launches and ``launches_by_body`` splits them by
body: both are incremented where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_fwd.cu"
MAX_DQ, MAX_DV = 256, 128         # the kernel's head-dim limits
_DTYPES = (torch.float32, torch.bfloat16)
_BODIES = {"f32": 0, "mma": 1, "tma": 2}
_TMA_ALIGN = 8                    # elements: TMA takes 16-B strides and bases

launches = 0
launches_by_body = dict.fromkeys(_BODIES, 0)
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
                fn = lib.fa_fwd
                fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                               + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
                               + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p])
                fn.restype = ctypes.c_int
                _lib = lib
    return _lib


def _strides(t):
    """(batch, seq, head) element strides; a size-1 dim gets the stride a
    contiguous tensor would give it, as its stride is never stepped."""
    (nb, ns, nh, nd), (sb, ss, sh, _) = t.shape, t.stride()
    sh = sh if nh > 1 else nd
    ss = ss if ns > 1 else sh * nh
    return (sb if nb > 1 else ss * ns), ss, sh


def _tma_addressable(t, strides) -> bool:
    return t.data_ptr() % 16 == 0 and not any(s % _TMA_ALIGN
                                              for s in strides)


def _pick(q, k, v, strides) -> str:
    if q.dtype == torch.float32:
        return "f32"
    ok = (q.shape[3] % _TMA_ALIGN == 0 and v.shape[3] % _TMA_ALIGN == 0
          and all(map(_tma_addressable, (q, k, v), strides)))
    return "tma" if ok else "mma"


def _body(q, k, v) -> str:
    """The body that runs these inputs: ``"f32"`` for float32; for bf16
    ``"tma"`` where TMA can address q, k, v and the output (bases 16-B
    aligned, strides multiples of 16 B, head dims multiples of 8), else
    ``"mma"``. Reads shapes, strides and pointers only."""
    return _pick(q, k, v, [_strides(t) for t in (q, k, v)])


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
    if not (1 <= dq <= MAX_DQ and 1 <= dv <= MAX_DV):
        raise ValueError(f"head dims dq={dq} dv={dv} outside 1..{MAX_DQ} "
                         f"and 1..{MAX_DV}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    if not 1 <= kv_len <= Skv:
        raise ValueError(f"kv_len={kv_len} outside 1..{Skv}")
    return B, Sq, H, dq, Skv, KV, dv


def flash_attention_fwd(q, k, v, *, scale: float, causal: bool = True,
                        kv_len: int | None = None):
    """q (B,Sq,H,dq), k (B,Skv,KV,dq), v (B,Skv,KV,dv) -> (B,Sq,H,dv).

    Launches the Hopper kernel's body for these inputs (``_body``) on the
    current stream; raises if the arguments do not fit it, if the build
    fails or if the launch is refused. Does not synchronise.
    """
    return _flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                kv_len=kv_len)


def _flash_attention_fwd(q, k, v, *, scale, causal=True, kv_len=None,
                         body=None):
    """``flash_attention_fwd`` with the body named: ``body="mma"`` runs the
    mma.sync body on inputs the tma body would take, so both bf16 bodies
    can be checked and timed side by side."""
    global launches
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    B, Sq, H, dq, Skv, KV, dv = _check(q, k, v, kv_len)
    strides = [_strides(t) for t in (q, k, v)]
    fits = _pick(q, k, v, strides)
    body = fits if body is None else body
    if (body == "tma" and fits != "tma") or (body == "f32") != (fits == "f32"):
        raise ValueError(f"the {body} body cannot take these inputs")
    lib = _load()
    o = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.fa_fwd(_BODIES[body], q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), B, H, KV, Sq, Skv, dq, dv,
                     *strides[0], *strides[1], *strides[2],
                     *o.stride()[:3], float(scale), int(bool(causal)),
                     kv_len, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd ({body} body) launch "
                           f"failed: CUDA error {err}")
    launches += 1
    launches_by_body[body] += 1
    return o
