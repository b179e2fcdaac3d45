"""Hopper flash-attention forward: build, bind and launch.

The CUDA source (``csrc/flash_attention_fwd.cu``) replaces the TPU kernel
``flash_attention_fwd`` of ``src/repro/kernels/flash_attention/kernel.py``.
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C entry point (``kernels/_build.py``, at first use) and loaded with
``ctypes``. Importing this module needs neither ``nvcc`` nor a card.

The source holds three bodies (see its header note). ``_body`` picks one
from the dtype, shapes, strides and alignment alone, never from a failed
launch: ``"tma"`` (TMA loads, wgmma) for bf16 that TMA can address with
dq <= 256, ``"mma"`` (mma.sync) for the rest of bf16, ``"f32"`` for float32.

Any head dims and batch run, as the reference's wrapper pads any head dim:
the kernel streams dq past 256 through shared memory itself, and
``_passes`` cuts a call into launches of at most ``MAX_DV`` columns of v
and o and ``MAX_GRID`` batch rows and q heads. A call within those limits
is one launch, as before. A last dim that is not contiguous is copied
contiguous first.

``launches`` counts kernel launches and ``launches_by_body`` splits them by
body: both are incremented where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build, contiguous_last

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_fwd.cu"
MAX_DQ = 256      # the tma body's dq; wider bf16 goes to the mma body
MAX_DV = 128      # v columns of one launch
MAX_GRID = 65535  # batch rows (grid z) and q heads (grid y) of one launch
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
    ok = (q.shape[3] <= MAX_DQ and q.shape[3] % _TMA_ALIGN == 0
          and v.shape[3] % _TMA_ALIGN == 0
          and all(map(_tma_addressable, (q, k, v), strides)))
    return "tma" if ok else "mma"


def _body(q, k, v) -> str:
    """The body that runs these inputs: ``"f32"`` for float32; for bf16
    ``"tma"`` where TMA can address q, k, v and the output (bases 16-B
    aligned, strides multiples of 16 B, head dims multiples of 8, dq at
    most ``MAX_DQ``), else ``"mma"``. Reads shapes, strides and pointers
    only, of q, k and v as the kernel gets them (last dims contiguous)."""
    q, k, v = map(contiguous_last, (q, k, v))
    return _pick(q, k, v, [_strides(t) for t in (q, k, v)])


def _on_card(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_fwd takes CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _check(q, k, v, kv_len):
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
    if dq < 1 or dv < 1:
        raise ValueError(f"head dims dq={dq} dv={dv} must be at least 1")
    if not 1 <= kv_len <= Skv:
        raise ValueError(f"kv_len={kv_len} outside 1..{Skv}")
    return B, Sq, H, dq, Skv, KV, dv


def flash_attention_fwd(q, k, v, *, scale: float, causal: bool = True,
                        kv_len: int | None = None):
    """q (B,Sq,H,dq), k (B,Skv,KV,dq), v (B,Skv,KV,dv) -> (B,Sq,H,dv).

    Launches the Hopper kernel's body for these inputs (``_body``) on the
    current stream, once per pass (``_passes``: one for dv <= ``MAX_DV``
    and B, H <= ``MAX_GRID``); raises if the arguments do not fit
    together, if the build fails or if a launch is refused. Does not
    synchronise.
    """
    return _flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                kv_len=kv_len)


def _flash_attention_fwd(q, k, v, *, scale, causal=True, kv_len=None,
                         body=None):
    """``flash_attention_fwd`` with the body named: ``body="mma"`` runs the
    mma.sync body on inputs the tma body would take, so both bf16 bodies
    can be checked and timed side by side."""
    _on_card(q, k, v)
    return _run(q, k, v, scale, causal, kv_len, body, _launch)


def _passes(q, k, v, o):
    """The (q, k, v, o) views that one launch each takes: runs of at most
    ``MAX_GRID`` batch rows and q heads (a run's q heads read whole kv
    groups, or one group's share of at most ``MAX_GRID``), and blocks of at
    most ``MAX_DV`` columns of v and o. O = P V is independent per output
    column and P does not depend on v, so the blocks are exact. A call
    within every limit is one pass."""
    B, H, KV, dv = q.shape[0], q.shape[2], k.shape[2], v.shape[3]
    if B <= MAX_GRID and H <= MAX_GRID and dv <= MAX_DV:
        yield q, k, v, o            # no views: they cost the host ~20 us
        return
    G = H // KV
    kv_run = max(1, MAX_GRID // G)      # kv heads whose q heads fit a pass
    g_run = min(G, MAX_GRID)            # q heads of one kv head in a pass
    for b0 in range(0, B, MAX_GRID):
        b = slice(b0, b0 + MAX_GRID)
        for kv0 in range(0, KV, kv_run):
            kv = slice(kv0, kv0 + kv_run)
            for g0 in range(0, G, g_run):
                h = (slice(kv0 * G, (kv0 + kv_run) * G) if g_run == G else
                     slice(kv0 * G + g0, kv0 * G + min(g0 + g_run, G)))
                for c0 in range(0, dv, MAX_DV):
                    c = slice(c0, c0 + MAX_DV)
                    yield q[b, :, h], k[b, :, kv], v[b, :, kv, c], o[b, :, h, c]


def _run(q, k, v, scale, causal, kv_len, body, launch):
    """Checks the arguments, picks the body, allocates the output and
    calls ``launch(body, q, k, v, o, scale, causal, kv_len)`` once per
    pass (``_passes``); returns the output. Device-agnostic, so the CPU
    tests drive it with a stand-in for ``_launch``."""
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    B, Sq, H, dq, Skv, KV, dv = _check(q, k, v, kv_len)
    q, k, v = map(contiguous_last, (q, k, v))
    fits = _pick(q, k, v, [_strides(t) for t in (q, k, v)])
    body = fits if body is None else body
    if (body == "tma" and fits != "tma") or (body == "f32") != (fits == "f32"):
        raise ValueError(f"the {body} body cannot take these inputs")
    o = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    for qp, kp, vp, op in _passes(q, k, v, o):
        launch(body, qp, kp, vp, op, scale, causal, kv_len)
    return o


def _launch(body, q, k, v, o, scale, causal, kv_len):
    """One launch of ``body`` on views within the kernel's limits."""
    global launches
    lib = _load()
    B, Sq, H, dq = q.shape
    _, Skv, KV, dv = v.shape
    strides = [_strides(t) for t in (q, k, v)]
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
