"""Hopper Mamba-1 selective scan forward: build, bind and launch.

The CUDA source (``csrc/selective_scan_fwd.cu``) replaces the TPU kernel
``selective_scan_fwd`` of ``src/repro/kernels/mamba_scan/kernel.py``. It
is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C entry point (``kernels/_build.py``, at first use) and loaded with
``ctypes``. Importing this module needs neither ``nvcc`` nor a card.

x, B and C are taken through their (batch, time) strides, so B and C are
read straight out of the ``x_proj`` output they are slices of; no copy is
made (a last dim that is not contiguous is copied contiguous first). Any
state width N runs: up to 16 the kernel keeps today's body, above it a
wide body spreads the state over more lanes and, past one warp, over
state groups whose f32 partials a second kernel adds (``groups``; the
wrapper allocates their workspace). Batches past ``MAX_GRID`` rows run in
launches of at most that many. ``launches`` counts launches of the
kernel (one per ``ss_fwd`` call, whose grouped form also runs the
combine): it is incremented where the kernel is launched and nowhere
else.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build, contiguous_last

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan_fwd.cu"
MAX_GRID = 65535                   # batch rows of one launch (grid y)
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
                fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                               + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 8
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                for name in ("ss_fwd_lanes", "ss_fwd_groups"):
                    getattr(lib, name).argtypes = [ctypes.c_int] * 2
                    getattr(lib, name).restype = ctypes.c_int
                _lib = lib
    return _lib


def lanes(dtype: torch.dtype, N: int) -> int:
    """Lanes that share one channel's state in the built kernel for x of
    ``dtype`` and N state columns; builds and loads the library if
    needed."""
    return _load().ss_fwd_lanes(_DTYPES[dtype], N)


def groups(dtype: torch.dtype, N: int) -> int:
    """State groups of one launch (1 up to a warp of lanes' columns)."""
    return _load().ss_fwd_groups(_DTYPES[dtype], N)


def _on_card(*ts):
    if not all(t.is_cuda for t in ts):
        raise ValueError("selective_scan_fwd takes CUDA tensors")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("x, dt, A, B, C, D and h0 must be on one device")


def _check(x, dt, A, B, C, D, h0):
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
    if min(Bt, L, di, N) < 1:
        raise ValueError(f"shape (Bt={Bt}, L={L}, di={di}, N={N}) has an "
                         f"empty dim")
    return Bt, L, di, N


def selective_scan_fwd(x, dt, A, B, C, D, h0):
    """x, dt (Bt,L,di); A (di,N); B, C (Bt,L,N); D (di,); h0 (Bt,di,N) ->
    (y (Bt,L,di) in x's dtype, h_last (Bt,di,N) f32).

    Launches the Hopper kernel on the current stream, once per run of at
    most ``MAX_GRID`` batch rows; raises if the arguments do not fit
    together, if the build fails or if a launch is refused. Does not
    synchronise.
    """
    _on_card(x, dt, A, B, C, D, h0)
    return _run(x, dt, A, B, C, D, h0, _launch)


def _run(x, dt, A, B, C, D, h0, launch):
    """Checks the arguments, makes the last dims contiguous (A, D and h0
    whole), allocates the outputs and calls ``launch(x, dt, A, B, C, D,
    h0, y, h_last)`` once per run of at most ``MAX_GRID`` batch rows;
    returns (y, h_last). Device-agnostic, so the CPU tests drive it with a
    stand-in for ``_launch``."""
    Bt, L, di, N = _check(x, dt, A, B, C, D, h0)
    x, dt, B, C = map(contiguous_last, (x, dt, B, C))
    A, D, h0 = (t.contiguous() for t in (A, D, h0))
    y = torch.empty((Bt, L, di), dtype=x.dtype, device=x.device)
    h_last = torch.empty((Bt, di, N), dtype=torch.float32, device=x.device)
    if Bt <= MAX_GRID:              # no views: they cost the host ~20 us
        launch(x, dt, A, B, C, D, h0, y, h_last)
        return y, h_last
    for b0 in range(0, Bt, MAX_GRID):
        r = slice(b0, b0 + MAX_GRID)
        launch(x[r], dt[r], A, B[r], C[r], D, h0[r], y[r], h_last[r])
    return y, h_last


def _launch(x, dt, A, B, C, D, h0, y, h_last):
    """One launch on at most ``MAX_GRID`` batch rows; y and h_last are
    contiguous, with the f32 workspace of the state groups allocated here
    where there is more than one."""
    global launches
    lib = _load()
    Bt, L, di = x.shape
    N = A.shape[1]
    n_groups = lib.ss_fwd_groups(_DTYPES[x.dtype], N)
    part = (torch.empty((n_groups, Bt, L, di), dtype=torch.float32,
                        device=x.device) if n_groups > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ss_fwd(_DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(),
                     A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
                     h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                     None if part is None else part.data_ptr(),
                     Bt, L, di, N, *x.stride()[:2], *dt.stride()[:2],
                     *B.stride()[:2], *C.stride()[:2], stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_fwd launch failed: CUDA error "
                           f"{err}")
    launches += 1
