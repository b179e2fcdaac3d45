"""Flash-attention dispatch: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

A CUDA tensor launches the kernel (``kernel.flash_attention_fwd``, whose
``launches`` counter records it) or raises; there is no fallback. A CPU
tensor takes the plain version, chunked above ``CHUNK_THRESHOLD`` query
positions as the reference's CPU path does. Forward only: the gradient
(an ``autograd.Function`` around the kernel) comes with the train path.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel, ref

CHUNK_THRESHOLD = 1024


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    kv_len=None):
    """(B,Sq,H,dq) x (B,Skv,KV,dq) x (B,Skv,KV,dv) -> (B,Sq,H,dv)."""
    if q.is_cuda:
        return kernel.flash_attention_fwd(q, k, v, scale=scale,
                                          causal=causal, kv_len=kv_len)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no path for {q.device} tensors")
    if q.shape[1] > CHUNK_THRESHOLD and kv_len is None:
        return ref.attention_ref_chunked(q, k, v, scale=scale, causal=causal)
    return ref.attention_ref(q, k, v, scale=scale, causal=causal,
                             kv_len=kv_len)
