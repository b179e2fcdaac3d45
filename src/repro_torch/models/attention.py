"""Attention: GQA (with the reference's head padding).

Two execution modes, as in ``repro.models.attention``:
  * ``full``   — prefill over a whole sequence, through the flash-attention
    op (the Hopper kernel on the card, the plain version on the CPU),
  * ``decode`` — one token against a preallocated KV cache, in plain
    torch (the reference leaves it to XLA as well).

MLA is not ported yet and raises ``NotImplementedError``.

KV caches are MDSS values, and MDSS treats stored values as immutable
(it caches each version's content digest). So a cache is never updated
in place: the new keys and values are written into a clone of the cache
handed in (one device copy of each layer's k and v per step), as the
reference's ``dynamic_update_slice`` returns a new array. Writing in
place would silently rewrite a stored version and falsify its digest.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models.layers import apply_rope, rope_freqs
from repro_torch.models.params import ParamSpec, torch_dtype

NEG_INF = -1e30


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor to allocate (a pytree leaf)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# Shared attention math (grouped einsum; no KV expansion).
# ---------------------------------------------------------------------------

def attend(q, k, v, *, q_pos, kv_len: int, scale: float, causal=True):
    """q: (B,Sq,H,dq) k: (B,Skv,KV,dq) v: (B,Skv,KV,dv) -> (B,Sq,H,dv).

    ``q_pos``: (Sq,) absolute positions of queries; keys occupy [0, Skv)
    and only positions ``<= q_pos`` and ``< kv_len`` are visible.
    """
    B, Sq, H, dq = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, dq)
    # f32 scores, as the reference's preferred_element_type=f32 einsum
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    k_pos = torch.arange(k.shape[1], device=q.device)
    ok = k_pos[None, :] < kv_len
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskv->bqkgv", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, -1)


# ===========================================================================
# GQA
# ===========================================================================

def gqa_template(cfg: ModelConfig) -> dict:
    d, hp, kvp, hd = cfg.d_model, cfg.heads_padded, cfg.kv_heads_padded, cfg.hdim
    t = {
        "wq": ParamSpec((d, hp, hd), ("embed", "heads", "head_dim"), fan_in_axis=0),
        "wk": ParamSpec((d, kvp, hd), ("embed", "kv_heads", "head_dim"), fan_in_axis=0),
        "wv": ParamSpec((d, kvp, hd), ("embed", "kv_heads", "head_dim"), fan_in_axis=0),
        "wo": ParamSpec((hp, hd, d), ("heads", "head_dim", "embed"), fan_in_axis=1),
    }
    if cfg.qkv_bias:
        t["bq"] = ParamSpec((hp, hd), ("heads", "head_dim"), init="zeros")
        t["bk"] = ParamSpec((kvp, hd), ("kv_heads", "head_dim"), init="zeros")
        t["bv"] = ParamSpec((kvp, hd), ("kv_heads", "head_dim"), init="zeros")
    return t


def _qkv(cfg, p, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    cos, sin = rope_freqs(cfg, cfg.hdim, positions)   # (B, S, hd/2)
    q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])
    k = apply_rope(k, cos[:, :, None, :], sin[:, :, None, :])
    return q, k, v


def gqa_full(cfg: ModelConfig, p, x, *, cache: Optional[dict] = None,
             causal: bool = True):
    """Prefill (or a full forward). If ``cache`` is given, a new cache
    holding this sequence's keys and values is returned."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(cfg, p, x, positions)
    o = fops.flash_attention(q, k, v, scale=cfg.hdim ** -0.5, causal=causal)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    if cache is not None:
        kc, vc = cache["k"].clone(), cache["v"].clone()
        kc[:, :S] = k.to(kc.dtype)
        vc[:, :S] = v.to(vc.dtype)
        cache = dict(cache, k=kc, v=vc, pos=torch.full_like(cache["pos"], S))
    return out, cache


def gqa_decode(cfg: ModelConfig, p, x, cache, pos: int):
    """x: (B,1,D); cache k/v: (B,Scache,KV,hd); ``pos``: the cache's fill
    position, read once per decode step by the caller."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions)
    kc, vc = cache["k"].clone(), cache["v"].clone()
    kc[:, pos] = k[:, 0].to(kc.dtype)
    vc[:, pos] = v[:, 0].to(vc.dtype)
    o = attend(q, kc.to(q.dtype), vc.to(q.dtype),
               q_pos=torch.arange(pos, pos + 1, device=x.device),
               kv_len=pos + 1, scale=cfg.hdim ** -0.5)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, dict(cache, k=kc, v=vc, pos=cache["pos"] + 1)


def gqa_cache_spec(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """KV-cache entry to allocate."""
    kvp, hd = cfg.kv_heads_padded, cfg.hdim
    dt = torch_dtype(cfg.dtype)
    return {
        "k": TensorSpec((batch, seq, kvp, hd), dt),
        "v": TensorSpec((batch, seq, kvp, hd), dt),
        "pos": TensorSpec((), torch.int32),
    }


# ---------------------------------------------------------------------------
# Dispatch helpers used by the block assembler.
# ---------------------------------------------------------------------------

def _gqa_only(cfg: ModelConfig):
    if cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: attention type {cfg.attn_type!r} is not ported "
            "yet (GQA only)")


def attn_template(cfg: ModelConfig) -> dict:
    _gqa_only(cfg)
    return gqa_template(cfg)


def attn_full(cfg, p, x, cache=None, causal=True):
    _gqa_only(cfg)
    return gqa_full(cfg, p, x, cache=cache, causal=causal)


def attn_decode(cfg, p, x, cache, pos: int):
    _gqa_only(cfg)
    return gqa_decode(cfg, p, x, cache, pos)


def attn_cache_spec(cfg, batch, seq):
    _gqa_only(cfg)
    return gqa_cache_spec(cfg, batch, seq)
