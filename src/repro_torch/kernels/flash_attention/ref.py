"""Plain PyTorch flash attention (GQA, causal or full): the kernel's plain
version, in the (B,S,H,d) layout of ``repro.kernels.flash_attention.ref``.

  * ``attention_ref``         — direct (materializes Sq x Skv scores);
    the oracle the Hopper kernel is held against, and the CPU path.
  * ``attention_ref_chunked`` — q-chunked, with each causal chunk reading
    keys only up to its diagonal: peak score memory is q_chunk x Skv.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _scores(qg, k, scale):
    # f32 scores from the working dtype, as the reference's
    # preferred_element_type=f32 einsum
    return torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale


def attention_ref(q, k, v, *, scale: float, causal: bool = True,
                  kv_len=None):
    """q: (B,Sq,H,dq) k: (B,Skv,KV,dq) v: (B,Skv,KV,dv) -> (B,Sq,H,dv)."""
    B, Sq, H, dq = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, dq)
    s = _scores(qg, k, scale)
    k_pos = torch.arange(Skv, device=q.device)
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        ok = ok & (k_pos[None, :] < kv_len)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskv->bqkgv", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, -1)


def attention_ref_chunked(q, k, v, *, scale: float, causal: bool = True,
                          q_chunk: int = 512):
    """Streaming attention; same signature/semantics as ``attention_ref``."""
    B, Sq, H, dq = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    q_chunk = min(q_chunk, Sq)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qc = min(q_chunk, Sq - q0)
        # causal: this chunk only attends to keys [0, q0+qc)
        kv_end = min(q0 + qc, Skv) if causal else Skv
        qg = q[:, q0:q0 + qc].reshape(B, qc, KV, H // KV, dq)
        ks, vs = k[:, :kv_end], v[:, :kv_end]
        s = _scores(qg, ks, scale)
        if causal:
            q_pos = q0 + torch.arange(qc, device=q.device)
            k_pos = torch.arange(kv_end, device=q.device)
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s,
                            torch.full((), NEG_INF, device=q.device))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskv->bqkgv", p.to(v.dtype), vs)
        outs.append(o.reshape(B, qc, H, -1))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
