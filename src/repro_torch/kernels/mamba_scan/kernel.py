"""Hopper Mamba-1 selective scan forward: build, bind and launch.

The CUDA source (``csrc/selective_scan_fwd.cu``) replaces the TPU kernel
``selective_scan_fwd`` of ``src/repro/kernels/mamba_scan/kernel.py``. It
is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C entry point (``kernels/_build.py``, at first use) and loaded with
``ctypes``. Importing this module needs neither ``nvcc`` nor a card.

x, B and C are taken through their (batch, time) strides, so B and C are
read straight out of the ``x_proj`` output they are slices of; no copy is
made. ``launches`` counts kernel launches: it is incremented where the
kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan_fwd.cu"
MAX_STATE = 16
MAX_BATCH = 65535                  # the grid's y dimension
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

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
                fn = lib.ss_fwd
                fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                               + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 8
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                lib.ss_fwd_lanes.argtypes = [ctypes.c_int]
                lib.ss_fwd_lanes.restype = ctypes.c_int
                _lib = lib
    return _lib


def lanes(dtype: torch.dtype) -> int:
    """Lanes that share one channel's state in the built kernel for x of
    ``dtype``; builds and loads the library if needed."""
    return _load().ss_fwd_lanes(_DTYPES[dtype])


def _check(x, dt, A, B, C, D, h0):
    ts = (x, dt, A, B, C, D, h0)
    if not all(t.is_cuda for t in ts):
        raise ValueError("selective_scan_fwd takes CUDA tensors")
    if any(t.device != x.device for t in ts):
        raise ValueError("x, dt, A, B, C, D and h0 must be on one device")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"selective_scan_fwd takes float32 or bfloat16 x, "
                        f"B, C of one dtype, got {x.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, D, h0)):
        raise TypeError("selective_scan_fwd takes float32 dt, A, D and h0")
    if x.dim() != 3:
        raise ValueError("x must be (Bt,L,di)")
    Bt, L, di = x.shape
    N = A.shape[-1] if A.dim() == 2 else 0
    want = {"dt": (dt, (Bt, L, di)), "A": (A, (di, N)), "B": (B, (Bt, L, N)),
            "C": (C, (Bt, L, N)), "D": (D, (di,)), "h0": (h0, (Bt, di, N))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}{tuple(t.shape)} does not fit x"
                             f"{tuple(x.shape)} (want {name}{shape})")
    if not (1 <= N <= MAX_STATE and 1 <= Bt <= MAX_BATCH and L >= 1
            and di >= 1):
        raise ValueError(f"shape (Bt={Bt}, L={L}, di={di}, N={N}) outside "
                         f"Bt 1..{MAX_BATCH}, L >= 1, di >= 1, "
                         f"N 1..{MAX_STATE}")
    if any(t.stride(2) != 1 for t in (x, dt, B, C)):
        raise ValueError("the last dim of x, dt, B and C must be contiguous")
    if not (A.is_contiguous() and D.is_contiguous() and h0.is_contiguous()):
        raise ValueError("A, D and h0 must be contiguous")
    return Bt, L, di, N


def selective_scan_fwd(x, dt, A, B, C, D, h0):
    """x, dt (Bt,L,di); A (di,N); B, C (Bt,L,N); D (di,); h0 (Bt,di,N) ->
    (y (Bt,L,di) in x's dtype, h_last (Bt,di,N) f32).

    Launches the Hopper kernel on the current stream; raises if the
    arguments do not fit it, if the build fails or if the launch is
    refused. Does not synchronise.
    """
    global launches
    Bt, L, di, N = _check(x, dt, A, B, C, D, h0)
    lib = _load()
    y = torch.empty((Bt, L, di), dtype=x.dtype, device=x.device)
    h_last = torch.empty((Bt, di, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ss_fwd(_DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(),
                     A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
                     h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                     Bt, L, di, N, *x.stride()[:2], *dt.stride()[:2],
                     *B.stride()[:2], *C.stride()[:2], stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_fwd launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return y, h_last
