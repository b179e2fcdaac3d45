"""Flash-attention dispatch, with its gradient.

``flash_attention`` is an ``autograd.Function``, as the reference's
``_fa`` is a ``jax.custom_vjp``:

  * forward: the Hopper kernel for CUDA tensors
    (``kernel.flash_attention_fwd``, whose ``launches`` counter records
    it) or a raise; there is no fallback. A CPU tensor takes the plain
    version, chunked above ``CHUNK_THRESHOLD`` query positions as the
    reference's CPU path does.
  * backward: the VJP of the plain version, recomputed from the saved q,
    k and v (the reference's ``_fa_bwd``; the JAX package has no backward
    kernel). GQA's k and v gradients sum over each group of q heads.

Under ``torch.utils.checkpoint`` the forward runs again when the backward
recomputes the block, so the kernel launches twice per layer per step.

The launch is the custom op ``repro_torch::flash_attention_fwd``: on real
CUDA tensors it calls the kernel, on fake ones (``FakeTensorMode``, the
dry run) it gives the output's shape only, and ``FlopCounterMode`` counts
it by ``flops``. DTensors (tensor parallelism) go through ``local_map``:
each process runs the kernel on its own batch rows and heads.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention import kernel, ref
from repro_torch.parallel.sharding import (is_dtensor, keep_shards,
                                           local_shape_and_offset,
                                           redistribute)

CHUNK_THRESHOLD = 1024


def flops(B, Sq, H, dq, dv, causal, kv_len) -> int:
    """The two products' FLOPs over the visible (q, k) pairs: query ``i``
    sees keys ``< kv_len`` and, causal, ``<= i``."""
    if causal:
        m = min(Sq, kv_len)
        pairs = m * (m + 1) // 2 + (Sq - m) * kv_len
    else:
        pairs = Sq * kv_len
    return B * H * pairs * 2 * (dq + dv)


@torch.library.custom_op("repro_torch::flash_attention_fwd",
                         mutates_args=())
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            causal: bool, kv_len: Optional[int]) -> torch.Tensor:
    return kernel.flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                      kv_len=kv_len)


@_launch.register_fake
def _(q, k, v, scale, causal, kv_len):
    return q.new_empty(q.shape[:3] + v.shape[3:])


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _launch_flops(q_shape, k_shape, v_shape, scale, causal, kv_len, *_,
                  **__) -> int:
    B, Sq, H, dq = q_shape
    return flops(B, Sq, H, dq, v_shape[3], causal,
                 k_shape[1] if kv_len is None else kv_len)


def _plain(q, k, v, scale, causal, kv_len):
    if q.shape[1] > CHUNK_THRESHOLD and kv_len is None:
        return ref.attention_ref_chunked(q, k, v, scale=scale, causal=causal)
    return ref.attention_ref(q, k, v, scale=scale, causal=causal,
                             kv_len=kv_len)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kv_len):
        if q.is_cuda:
            o = _launch(q, k, v, scale, causal, kv_len)
        elif q.device.type == "cpu":
            o = _plain(q, k, v, scale, causal, kv_len)
        else:
            raise ValueError(f"flash_attention: no path for {q.device} "
                             f"tensors")
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, causal, kv_len)
        return o

    @staticmethod
    def backward(ctx, g):
        qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            o = _plain(*qkv, *ctx.args)
        return (*torch.autograd.grad(o, qkv, g), None, None, None)


def _kv_heads(h0: int, hl: int, H: int, KV: int):
    """The kv heads that q heads ``[h0, h0 + hl)`` read, as a function of
    the (B,S,KV,d) k or v: a slice where those heads keep the kernel's
    grouping (each kv head read by an equal run of them), else one kv head
    gathered per q head."""
    g = H // KV
    heads = [(h0 + i) // g for i in range(hl)]
    lo, n = heads[0], heads[-1] - heads[0] + 1
    if hl % n == 0 and heads == [lo + i // (hl // n) for i in range(hl)]:
        return lambda t: t[:, :, lo:lo + n]
    idx = torch.tensor(heads)
    return lambda t: t.index_select(2, idx.to(t.device))


def _sharded(q, k, v, scale, causal, kv_len):
    """DTensor q, k, v: each process's batch rows and q heads through the
    kernel (``local_map``). q keeps its batch and head splits and gathers
    the rest; k and v take q's batch split and all their heads, of which
    each process reads those its q heads need. Their gradients are
    partial sums over the mesh dims that split q's heads."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    q = keep_shards(q, (0, 2))
    mesh, q_pl = q.device_mesh, list(q.placements)
    kv_pl = [pl if pl == Shard(0) else Replicate() for pl in q_pl]
    k, v = redistribute(k, kv_pl), redistribute(v, kv_pl)
    kv_grad = [Partial() if pl == Shard(2) else kp
               for pl, kp in zip(q_pl, kv_pl)]
    shape, off = local_shape_and_offset(q.shape, mesh, q_pl)
    pick = _kv_heads(off[2], shape[2], q.shape[2], k.shape[2])
    fn = local_map(
        lambda ql, kl, vl: _FlashAttention.apply(ql, pick(kl), pick(vl),
                                                 scale, causal, kv_len),
        out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl),
        in_grad_placements=(q_pl, kv_grad, kv_grad), device_mesh=mesh)
    return fn(q, k, v)


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    kv_len=None):
    """(B,Sq,H,dq) x (B,Skv,KV,dq) x (B,Skv,KV,dv) -> (B,Sq,H,dv)."""
    if is_dtensor(q):
        return _sharded(q, k, v, scale, causal, kv_len)
    return _FlashAttention.apply(q, k, v, scale, causal, kv_len)
