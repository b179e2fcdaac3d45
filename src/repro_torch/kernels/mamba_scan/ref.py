"""Plain PyTorch Mamba-1 selective scan: the kernel's plain versions, with
the shapes and math of ``repro.kernels.mamba_scan.ref`` and ``ops``.

Recurrence (diagonal SSM):
    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t        h: (di, N)
    y_t = <h_t, C_t> + D * x_t

  * ``selective_scan_ref``  — chunked associative scan; the oracle the
    Hopper kernel is held against on the card.
  * ``cf_scan``             — the forward of the reference's closed-form
    path (``_fwd_states`` + ``_cf_scan``), whose scan pairs are
    materialized in ``sdt``: the port's CPU path.
  * ``selective_scan_blocked`` — the reference's two-level blocked scan:
    a sequential recurrence inside blocks of time, a scan over the block
    boundaries, then one combine. Not on any path yet: the plain form of
    a kernel that splits time across threads, for batches too small to
    fill the card with channels. Held against the JAX function and
    ``selective_scan_ref`` by the CPU tests.
  * ``selective_step_ref``  — one decode token.

``_chunk_scan`` is the odd/even recursion of ``jax.lax.associative_scan``,
so the pairs combine in the reference's order.
"""
from __future__ import annotations

import torch


def _combine(l, r):
    return l[0] * r[0], r[0] * l[1] + r[1]


def _interleave(even, odd):
    """Elements of ``even`` at even positions of axis 1, ``odd`` at odd."""
    shape = list(even.shape)
    shape[1] += odd.shape[1]
    out = even.new_empty(shape)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _chunk_scan(a, b):
    """Associative scan over axis 1 of (decay, value) pairs."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = _chunk_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], 1),
            torch.cat([b[:, :1], even[1]], 1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def selective_scan_ref(x, dt, A, B, C, D, h0, *, chunk: int = 512):
    """x,dt: (Bt,L,di); A: (di,N); B,C: (Bt,L,N); D: (di,); h0: (Bt,di,N).

    Returns (y: (Bt,L,di) x.dtype, h_last: (Bt,di,N) f32).
    """
    L = x.shape[1]
    chunk = min(chunk, L)
    # ragged final chunk is handled by the slice bounds below
    xf, dtf, Af, Bf, Cf = (t.float() for t in (x, dt, A, B, C))
    h = h0.float()
    ys = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, c0 + chunk)
        dt_c, x_c = dtf[:, sl], xf[:, sl]
        a = torch.exp(dt_c[..., None] * Af)                    # (Bt,Lc,di,N)
        b = (dt_c * x_c)[..., None] * Bf[:, sl][:, :, None, :]
        a_cum, s = _chunk_scan(a, b)
        hc = s + a_cum * h[:, None]                            # (Bt,Lc,di,N)
        y = torch.einsum("blds,bls->bld", hc, Cf[:, sl])
        ys.append(y + D.float() * x_c)
        h = hc[:, -1]
    return torch.cat(ys, 1).to(x.dtype), h


def selective_scan_blocked(x, dt, A, B, C, D, h0, *, block: int = 32,
                           chunk: int = 8192):
    """Shapes and result as ``selective_scan_ref``; the association order
    of ``repro.kernels.mamba_scan.ref.selective_scan_blocked``.

    Level 1 runs the recurrence inside each block of ``block`` steps from a
    zero state, keeping the running product of the decays (``A_cum``) and
    the accumulated input (``B_cum``); level 2 takes an exclusive scan over
    the blocks' last pairs, giving each block's starting state; level 3
    combines, ``h = B_cum + A_cum * h_start``. A ragged tail shorter than a
    block runs through ``selective_scan_ref``.
    """
    Bt, L, di = x.shape
    N = A.shape[1]
    chunk = min(chunk, L)
    h = h0.float()
    Af, Df = A.float(), D.float()
    ys = []
    for c0 in range(0, L, chunk):
        Lc = min(chunk, L - c0)
        bs = min(block, Lc)
        nb = Lc // bs
        rem = Lc - nb * bs
        sl = slice(c0, c0 + nb * bs)
        dt_c, x_c = dt[:, sl].float(), x[:, sl].float()
        a = torch.exp(dt_c[..., None] * Af).reshape(Bt, nb, bs, di, N)
        b = ((dt_c * x_c)[..., None] * B[:, sl].float()[:, :, None, :]
             ).reshape(Bt, nb, bs, di, N)
        As, Bs = [a[:, :, 0]], [b[:, :, 0]]          # level 1
        for t in range(1, bs):
            As.append(a[:, :, t] * As[-1])
            Bs.append(a[:, :, t] * Bs[-1] + b[:, :, t])
        A_cum, B_cum = torch.stack(As, 2), torch.stack(Bs, 2)
        Ap, Bp = _chunk_scan(A_cum[:, :, -1], B_cum[:, :, -1])   # level 2
        Ap = torch.cat([torch.ones_like(Ap[:, :1]), Ap[:, :-1]], 1)
        Bp = torch.cat([torch.zeros_like(Bp[:, :1]), Bp[:, :-1]], 1)
        h_start = Bp + Ap * h[:, None]
        hc = B_cum + A_cum * h_start[:, :, None]                 # level 3
        h = hc[:, -1, -1]
        hc = hc.reshape(Bt, nb * bs, di, N)
        y = torch.einsum("blds,bls->bld", hc, C[:, sl].float())
        ys.append(y + Df * x_c)
        if rem:
            tail = slice(c0 + nb * bs, c0 + Lc)
            y_t, h = selective_scan_ref(x[:, tail], dt[:, tail], A,
                                        B[:, tail], C[:, tail], D, h,
                                        chunk=rem)
            ys.append(y_t.float())
    return torch.cat(ys, 1).to(x.dtype), h


def _fwd_states(x, dt, A, B, h0, chunk, sdt=torch.float32):
    """All states h_{1..T}, chunked associative scans over pairs
    materialized in ``sdt`` (bf16 halves their bytes at ~1e-2 relative
    output error, as in the reference)."""
    L = x.shape[1]
    hs = []
    h = h0.to(sdt)
    for c0 in range(0, L, chunk):
        sl = slice(c0, min(c0 + chunk, L))
        a = torch.exp(dt[:, sl, :, None] * A).to(sdt)          # (Bt,Lc,d,N)
        b = ((dt[:, sl] * x[:, sl])[..., None]
             * B[:, sl, None, :]).to(sdt)
        a_cum, s = _chunk_scan(a, b)
        hc = s + a_cum * h[:, None]
        hs.append(hc)
        h = hc[:, -1]
    return torch.cat(hs, 1)


def cf_scan(x, dt, A, B, C, D, h0, *, chunk: int, sdt=torch.float32):
    """The closed-form path's forward (``repro ... ops._cf_scan``):
    (y: (Bt,L,di) x.dtype, h_last: (Bt,di,N) f32)."""
    xf, dtf = x.float(), dt.float()
    h = _fwd_states(xf, dtf, A.float(), B.float(), h0.float(), chunk, sdt)
    y = torch.einsum("blds,bls->bld", h.float(), C.float())
    y = y + D.float() * xf
    return y.to(x.dtype), h[:, -1].float()


def selective_step_ref(x, dt, A, B, C, D, h):
    """Single-token decode step. x,dt: (Bt,di); B,C: (Bt,N); h: (Bt,di,N)."""
    xf, dtf = x.float(), dt.float()
    a = torch.exp(dtf[..., None] * A.float())
    h = a * h + (dtf * xf)[..., None] * B.float()[:, None, :]
    y = torch.einsum("bds,bs->bd", h, C.float())
    return (y + D.float() * xf).to(x.dtype), h
