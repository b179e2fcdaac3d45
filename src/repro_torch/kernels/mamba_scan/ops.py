"""Selective-scan dispatch, with its gradient.

The linear recurrence  h_t = a_t h_{t-1} + b_t  has a closed-form adjoint
(the reference's ``_closed_form_bwd``):

    lam_t = g_t + a_{t+1} lam_{t+1}        (reverse linear scan)
    db_t  = lam_t
    da_t  = lam_t * h_{t-1}
    dh_0  = a_1 lam_1

so the backward is one more associative scan plus elementwise ops, here
in torch ops. Two ``autograd.Function``s carry it, as the reference's two
``custom_vjp``s do:

  * CUDA tensors: the Hopper kernel forward (``kernel.selective_scan_fwd``,
    whose ``launches`` counter records it) or a raise, with the
    closed-form backward at float32 (``_scan``/``_scan_bwd``). The kernel
    keeps its state in f32 registers, so ``scan_dtype`` does not apply,
    just as the reference's TPU kernel ignores it.
  * CPU tensors: the closed-form path's forward (``ref.cf_scan``) and
    backward, chunked by ``_mem_chunk`` and with the scan pairs
    materialized in ``scan_dtype`` (``_cf_scan``).

The launch is the custom op ``repro_torch::selective_scan_fwd``: on real
CUDA tensors it calls the kernel, on fake ones (``FakeTensorMode``, the
dry run) it gives the outputs' shapes only, and ``FlopCounterMode`` counts
it by ``flops``. DTensors (tensor parallelism) go through ``local_map``:
each process scans its own batch rows and channels.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.mamba_scan import kernel, ref
from repro_torch.parallel.sharding import (as_dtensor, is_dtensor,
                                           keep_shards, redistribute)


def flops(Bt, L, di, N) -> int:
    """The recurrence's f32 FLOPs, four per (row, step, channel, state)
    element, as many as its exponentials."""
    return 4 * Bt * L * di * N


@torch.library.custom_op("repro_torch::selective_scan_fwd",
                         mutates_args=())
def _launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
            h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return kernel.selective_scan_fwd(x, dt, A, B, C, D, h0)


@_launch.register_fake
def _(x, dt, A, B, C, D, h0):
    return x.new_empty(x.shape), h0.new_empty(h0.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.selective_scan_fwd)
def _launch_flops(x_shape, dt_shape, A_shape, *_, **__) -> int:
    return flops(*x_shape, A_shape[1])


def _mem_chunk(chunk: int, x) -> int:
    """Outer chunk bounding the (B, chunk, d, N) working set."""
    return min(x.shape[1], max(chunk, 4096))


def closed_form_bwd(x, dt, A, B, C, D, h0, y_bar, hlast_bar, *, chunk: int,
                    sdt=torch.float32):
    """Cotangents of (x, dt, A, B, C, D, h0) from those of (y, h_last),
    each in its input's dtype (the reference's ``_closed_form_bwd``)."""
    xf, dtf = x.float(), dt.float()
    Af, Bf, Cf = A.float(), B.float(), C.float()
    yb = y_bar.float()
    L = x.shape[1]

    h = ref._fwd_states(xf, dtf, Af, Bf, h0.float(), chunk, sdt)
    h_prev = torch.cat([h0.to(sdt)[:, None], h[:, :-1]], 1)
    a = torch.exp(dtf[..., None] * Af).to(sdt)

    # g_t = ybar_t (x) C_t  (+ final-state cotangent at T)
    g = (yb[..., None] * Cf[:, :, None, :]).to(sdt)
    g[:, -1] += hlast_bar.to(sdt)
    # lam_t = g_t + a_{t+1} lam_{t+1}: reverse linear scan, shifted decay
    a_shift = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], 1)
    lam_chunks = []
    lam_carry = torch.zeros(h0.shape, dtype=sdt, device=x.device)
    for c0 in reversed(range(0, L, chunk)):
        sl = slice(c0, min(c0 + chunk, L))
        a_cum, s = ref._chunk_scan(torch.flip(a_shift[:, sl], [1]),
                                   torch.flip(g[:, sl], [1]))
        lam_r = s + a_cum * lam_carry[:, None]
        del a_cum, s
        lam_carry = lam_r[:, -1]
        lam_chunks.append(torch.flip(lam_r, [1]))
    del g, a_shift
    lam = torch.cat(lam_chunks[::-1], 1).float()        # (Bt,L,d,N)
    del lam_chunks

    a, h = a.float(), h.float()
    # a = exp(dt A):  dt_bar += sum_n a_bar a A ;  A_bar += sum_t a_bar a dt
    aa = lam * h_prev.float() * a
    del h_prev
    dt_bar = torch.einsum("blds,ds->bld", aa, Af)
    A_bar = torch.einsum("blds,bld->ds", aa, dtf)
    del aa
    # b = (dt x) (x) B: lam is b_bar
    lamB = torch.einsum("blds,bls->bld", lam, Bf)
    dt_bar = dt_bar + xf * lamB
    x_bar = dtf * lamB + D.float() * yb
    B_bar = torch.einsum("blds,bld->bls", lam, dtf * xf)
    C_bar = torch.einsum("blds,bld->bls", h, yb)
    D_bar = torch.einsum("bld,bld->d", yb, xf)
    h0_bar = a[:, 0] * lam[:, 0]
    return (x_bar.to(x.dtype), dt_bar.to(dt.dtype), A_bar.to(A.dtype),
            B_bar.to(B.dtype), C_bar.to(C.dtype), D_bar.to(D.dtype),
            h0_bar.to(h0.dtype))


class _KernelScan(torch.autograd.Function):
    """The Hopper kernel's forward, the closed-form backward at f32."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0, chunk):
        out = _launch(x, dt, A, B, C, D, h0)
        ctx.save_for_backward(x, dt, A, B, C, D, h0)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, y_bar, hlast_bar):
        saved = ctx.saved_tensors
        return (*closed_form_bwd(*saved, y_bar, hlast_bar,
                                 chunk=_mem_chunk(ctx.chunk, saved[0])),
                None)


class _ClosedFormScan(torch.autograd.Function):
    """The closed-form path, forward and backward, pairs in ``sdt``."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0, chunk, sdt):
        out = ref.cf_scan(x, dt, A, B, C, D, h0, chunk=chunk, sdt=sdt)
        ctx.save_for_backward(x, dt, A, B, C, D, h0)
        ctx.chunk, ctx.sdt = chunk, sdt
        return out

    @staticmethod
    def backward(ctx, y_bar, hlast_bar):
        return (*closed_form_bwd(*ctx.saved_tensors, y_bar, hlast_bar,
                                 chunk=ctx.chunk, sdt=ctx.sdt), None, None)


def _sharded(x, dt, A, B, C, D, h0, chunk, scan_dtype):
    """DTensor inputs: each process's batch rows and channels (``di``)
    through the scan (``local_map``), the channels being independent. x
    keeps its batch and channel splits and gathers the rest (time is
    never split); dt, A, D and h0 follow it, B and C take its batch split
    only. Gradients of the inputs a split leaves whole on a process are
    partial sums over the mesh dims of that split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x = keep_shards(x, (0, 2))
    mesh, x_pl = x.device_mesh, list(x.placements)
    h0 = as_dtensor(h0, mesh)

    def pl(batch, chan, none=Replicate()):
        """Placements: ``batch`` on x's batch split, ``chan`` on its
        channel split, ``none`` elsewhere."""
        return [batch if p == Shard(0) else chan if p == Shard(2) else none
                for p in x_pl]

    R, P = Replicate(), Partial()
    chan = pl(R, Shard(0))                      # A, D: (di, ...)
    rows = pl(Shard(0), R)                      # B, C: (Bt, L, N)
    h_pl = pl(Shard(0), Shard(1))               # h0: (Bt, di, N)
    ins = (x_pl, x_pl, chan, rows, rows, chan, h_pl)
    grads = (x_pl, x_pl, pl(P, Shard(0)), pl(Shard(0), P), pl(Shard(0), P),
             pl(P, Shard(0)), h_pl)
    args = [x] + [redistribute(t, want) for t, want in
                  zip((dt, A, B, C, D, h0), ins[1:])]
    fn = local_map(
        lambda *a: selective_scan(*a, chunk=chunk, scan_dtype=scan_dtype),
        out_placements=(x_pl, h_pl), in_placements=ins,
        in_grad_placements=grads, device_mesh=mesh)
    return fn(*args)


def selective_scan(x, dt, A, B, C, D, h0, *, chunk: int = 512,
                   scan_dtype: str = "float32"):
    """Shapes as in ``ref.selective_scan_ref``. Returns (y, h_last)."""
    if is_dtensor(x):
        return _sharded(x, dt, A, B, C, D, h0, chunk, scan_dtype)
    if x.is_cuda:
        return _KernelScan.apply(x, dt, A, B, C, D, h0, chunk)
    if x.device.type != "cpu":
        raise ValueError(f"selective_scan: no path for {x.device} tensors")
    return _ClosedFormScan.apply(x, dt, A, B, C, D, h0, _mem_chunk(chunk, x),
                                 getattr(torch, scan_dtype))


selective_step = ref.selective_step_ref
