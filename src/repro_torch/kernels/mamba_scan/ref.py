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
