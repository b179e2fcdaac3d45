"""Hopper Mamba-1 selective scan, forward and backward: build, bind and
launch.

The CUDA source ``csrc/selective_scan_fwd.cu`` replaces the TPU kernel
``selective_scan_fwd`` of ``src/repro/kernels/mamba_scan/kernel.py``;
``csrc/selective_scan_bwd.cu`` is its gradient, which the TPU package
computes in XLA ops (``ops.closed_form_bwd`` is that plain version). Each
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
else. ``bwd_launches`` counts launches of the backward likewise (one per
``ss_bwd`` call, which also runs its combines; the sum over batch rows
after the last run is part of the call that needed it).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build, contiguous_last

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan_fwd.cu"
BWD_SOURCE = SOURCE.with_name("selective_scan_bwd.cu")
MAX_GRID = 65535                   # batch rows of one launch (grid y)
# the backward's layout (``ss_bwd_layout``): timesteps per tile, channels
# per block, state columns per group; its workspaces are sized by them
BWD_TILE, BWD_CHANNELS, BWD_COLS = 32, 32, 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0
_lib = None
_bwd_lib = None
_lib_lock = threading.Lock()


def build() -> Path:
    """The kernel's shared library, compiled if this source is new."""
    return _build.build(SOURCE)


def build_bwd() -> Path:
    """The backward kernel's shared library, compiled if its source is
    new."""
    return _build.build(BWD_SOURCE)


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


def _load_bwd():
    global _bwd_lib
    if _bwd_lib is None:
        with _lib_lock:
            if _bwd_lib is None:
                lib = ctypes.CDLL(str(build_bwd()))
                lib.ss_bwd.argtypes = ([ctypes.c_int]
                                       + [ctypes.c_void_p] * 19
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_longlong] * 10
                                       + [ctypes.c_void_p])
                lib.ss_bwd.restype = ctypes.c_int
                lib.ss_bwd_rows.argtypes = ([ctypes.c_void_p] * 4
                                            + [ctypes.c_int] * 3
                                            + [ctypes.c_void_p])
                lib.ss_bwd_rows.restype = ctypes.c_int
                lib.ss_bwd_layout.argtypes = [ctypes.c_int]
                lib.ss_bwd_layout.restype = ctypes.c_int
                built = tuple(lib.ss_bwd_layout(i) for i in range(3))
                if built != (BWD_TILE, BWD_CHANNELS, BWD_COLS):
                    raise RuntimeError(f"selective_scan_bwd was built with "
                                       f"the layout {built}, the wrapper "
                                       f"sizes its workspaces for "
                                       f"{(BWD_TILE, BWD_CHANNELS, BWD_COLS)}")
                _bwd_lib = lib
    return _bwd_lib


def lanes(dtype: torch.dtype, N: int) -> int:
    """Lanes that share one channel's state in the built kernel for x of
    ``dtype`` and N state columns; builds and loads the library if
    needed."""
    return _load().ss_fwd_lanes(_DTYPES[dtype], N)


def groups(dtype: torch.dtype, N: int) -> int:
    """State groups of one launch (1 up to a warp of lanes' columns)."""
    return _load().ss_fwd_groups(_DTYPES[dtype], N)


def _on_card(*ts, name="selective_scan_fwd"):
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{name} takes CUDA tensors")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{name}'s tensors must be on one device")


def _check(x, dt, A, B, C, D, h0, name="selective_scan_fwd"):
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 x, B, C of one "
                        f"dtype, got {x.dtype}, {B.dtype}, {C.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, D, h0)):
        raise TypeError(f"{name} takes float32 dt, A, D and h0")
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


# ------------------------------------------------------------------ backward
def _check_cot(x, h0, y_bar, hlast_bar):
    if y_bar.dtype != x.dtype or hlast_bar.dtype != torch.float32:
        raise TypeError(f"selective_scan_bwd takes y_bar in x's dtype "
                        f"({x.dtype}) and float32 hlast_bar, got "
                        f"{y_bar.dtype}, {hlast_bar.dtype}")
    for name, t, ref in (("y_bar", y_bar, x), ("hlast_bar", hlast_bar, h0)):
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}{tuple(t.shape)} does not fit "
                             f"{tuple(ref.shape)}")


def bwd_workspaces(Bt: int, L: int, di: int, N: int) -> dict:
    """Shapes of the backward's f32 workspaces. The first three serve one
    launch of at most ``MAX_GRID`` rows and are reused by the next:
    ``hb``, the state entering each time tile but the first; ``part``,
    each channel block's partial of dB and dC; ``sums``, each group of
    ``BWD_COLS`` state columns' partials of d(dt) and dx, where N needs
    more than one group (else None). ``dA_rows`` and ``dD_rows`` hold
    every batch row's dA and dD until they are added up."""
    R = min(Bt, MAX_GRID)
    tiles, blocks = -(-L // BWD_TILE), -(-di // BWD_CHANNELS)
    groups = -(-N // BWD_COLS)
    return {"hb": (R, tiles - 1, di, N), "part": (R, blocks, L, 2 * N),
            "sums": (groups, 2, R, L, di) if groups > 1 else None,
            "dA_rows": (Bt, di, N), "dD_rows": (Bt, di)}


def selective_scan_bwd(x, dt, A, B, C, D, h0, y_bar, hlast_bar):
    """Cotangents of (x, dt, A, B, C, D, h0) from those of (y, h_last),
    each in its input's dtype: the math of ``ops.closed_form_bwd``.
    Shapes as ``selective_scan_fwd`` takes them; y_bar (Bt,L,di) in x's
    dtype, hlast_bar (Bt,di,N) f32.

    Launches the Hopper kernel on the current stream, once per run of at
    most ``MAX_GRID`` batch rows, then adds the rows' dA and dD; raises if
    the arguments do not fit together, if the build fails or if a launch
    is refused. Does not synchronise.
    """
    _on_card(x, dt, A, B, C, D, h0, y_bar, hlast_bar,
             name="selective_scan_bwd")
    return _run_bwd(x, dt, A, B, C, D, h0, y_bar, hlast_bar, _launch_bwd,
                    _add_rows)


def _run_bwd(x, dt, A, B, C, D, h0, y_bar, hlast_bar, launch, add_rows):
    """Checks the arguments, makes the last dims contiguous (A, D, h0 and
    hlast_bar whole), allocates the outputs and workspaces, calls
    ``launch(ins, outs, ws)`` once per run of at most ``MAX_GRID`` batch
    rows (each a tuple of the run's views: ins x, dt, A, B, C, D, h0,
    y_bar, hlast_bar; outs dx, ddt, dB, dC, dh0; ws dA_rows, dD_rows, hb,
    part, sums) and ``add_rows(dA_rows, dD_rows, dA, dD)`` once; returns
    (dx, ddt, dA, dB, dC, dD, dh0). Device-agnostic, so the CPU tests
    drive it with stand-ins for ``_launch_bwd`` and ``_add_rows``."""
    Bt, L, di, N = _check(x, dt, A, B, C, D, h0, "selective_scan_bwd")
    _check_cot(x, h0, y_bar, hlast_bar)
    x, dt, B, C, y_bar = map(contiguous_last, (x, dt, B, C, y_bar))
    A, D, h0, hlast_bar = (t.contiguous() for t in (A, D, h0, hlast_bar))
    dev, f32 = x.device, torch.float32

    def empty(shape, dtype=f32):
        return None if shape is None else torch.empty(shape, dtype=dtype,
                                                      device=dev)
    outs = (empty((Bt, L, di), x.dtype), empty((Bt, L, di)),
            empty((Bt, L, N), B.dtype), empty((Bt, L, N), C.dtype),
            empty((Bt, di, N)))
    shapes = bwd_workspaces(Bt, L, di, N)
    rows = (empty(shapes["dA_rows"]), empty(shapes["dD_rows"]))
    runs = tuple(empty(shapes[k]) for k in ("hb", "part", "sums"))
    ins = (x, dt, A, B, C, D, h0, y_bar, hlast_bar)
    if Bt <= MAX_GRID:              # no views: they cost the host ~20 us
        launch(ins, outs, rows + runs)
    else:
        for b0 in range(0, Bt, MAX_GRID):
            r = slice(b0, b0 + MAX_GRID)
            launch(tuple(t if i in (2, 5) else t[r]      # not A, D
                         for i, t in enumerate(ins)),
                   tuple(t[r] for t in outs),
                   (rows[0][r], rows[1][r]) + runs)
    dA, dD = empty((di, N)), empty((di,))
    add_rows(*rows, dA, dD)
    dx, ddt, dB, dC, dh0 = outs
    return dx, ddt, dA, dB, dC, dD, dh0


def _launch_bwd(ins, outs, ws):
    """One launch on at most ``MAX_GRID`` batch rows (``_run_bwd``'s
    views; a run shorter than the workspaces uses their first rows)."""
    global bwd_launches
    lib = _load_bwd()
    x, dt, A, B, C, D, h0, y_bar, hlast_bar = ins
    Bt, L, di = x.shape
    N = A.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [t.data_ptr() for t in ins + outs + ws[:2]]
    ptrs += [None if t is None or t.numel() == 0 else t.data_ptr()
             for t in ws[2:]]
    err = lib.ss_bwd(_DTYPES[x.dtype], *ptrs, Bt, L, di, N,
                     *x.stride()[:2], *dt.stride()[:2], *B.stride()[:2],
                     *C.stride()[:2], *y_bar.stride()[:2], stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd launch failed: CUDA error "
                           f"{err}")
    bwd_launches += 1


def _add_rows(dA_rows, dD_rows, dA, dD):
    Bt, di, N = dA_rows.shape
    stream = torch.cuda.current_stream(dA.device).cuda_stream
    err = _load_bwd().ss_bwd_rows(dA_rows.data_ptr(), dD_rows.data_ptr(),
                                  dA.data_ptr(), dD.data_ptr(), Bt, di, N,
                                  stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd's sum over batch rows "
                           f"failed: CUDA error {err}")
