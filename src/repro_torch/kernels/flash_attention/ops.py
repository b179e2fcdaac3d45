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
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref

CHUNK_THRESHOLD = 1024


def _plain(q, k, v, scale, causal, kv_len):
    if q.shape[1] > CHUNK_THRESHOLD and kv_len is None:
        return ref.attention_ref_chunked(q, k, v, scale=scale, causal=causal)
    return ref.attention_ref(q, k, v, scale=scale, causal=causal,
                             kv_len=kv_len)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kv_len):
        if q.is_cuda:
            o = kernel.flash_attention_fwd(q, k, v, scale=scale,
                                           causal=causal, kv_len=kv_len)
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


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    kv_len=None):
    """(B,Sq,H,dq) x (B,Skv,KV,dq) x (B,Skv,KV,dv) -> (B,Sq,H,dv)."""
    return _FlashAttention.apply(q, k, v, scale, causal, kv_len)
