"""Attention: GQA (with the reference's head padding) and MLA.

Two execution modes, as in ``repro.models.attention``:
  * ``full``   — prefill over a whole sequence, through the flash-attention
    op (the Hopper kernel on the card, the plain version on the CPU); MLA
    expands k and v from the latent and calls it with dq != dv,
  * ``decode`` — one token against a preallocated cache, in plain torch
    (the reference leaves it to XLA as well); MLA's is the absorbed form,
    attending in the latent space over an O(kv_lora) cache.

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
from repro_torch.models.layers import (apply_rope, rmsnorm,
                                       rmsnorm_template, rope_freqs)
from repro_torch.models.params import ParamSpec, torch_dtype

NEG_INF = -1e30


@dataclass(frozen=True)
class TensorSpec:
    """Shape, dtype and logical axes of a tensor to allocate (a pytree
    leaf)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    axes: Tuple[Optional[str], ...] = ()


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
    """KV-cache entry to allocate, with its logical axes."""
    kvp, hd = cfg.kv_heads_padded, cfg.hdim
    dt = torch_dtype(cfg.dtype)
    return {
        "k": TensorSpec((batch, seq, kvp, hd), dt,
                        ("act_batch", "act_kv_seq", "act_kv_heads", None)),
        "v": TensorSpec((batch, seq, kvp, hd), dt,
                        ("act_batch", "act_kv_seq", "act_kv_heads", None)),
        "pos": TensorSpec((), torch.int32),
    }


# ===========================================================================
# MLA (minicpm3, deepseek-v3)
# ===========================================================================

def mla_template(cfg: ModelConfig) -> dict:
    d, hp = cfg.d_model, cfg.heads_padded
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wdq": ParamSpec((d, ql), ("embed", "q_lora"), fan_in_axis=0),
        "q_norm": rmsnorm_template(ql),
        "wuq": ParamSpec((ql, hp, dn + dr), ("q_lora", "heads", "head_dim"), fan_in_axis=0),
        "wdkv": ParamSpec((d, kl + dr), ("embed", "kv_lora"), fan_in_axis=0),
        "kv_norm": rmsnorm_template(kl),
        "wuk": ParamSpec((kl, hp, dn), ("kv_lora", "heads", "head_dim"), fan_in_axis=0),
        "wuv": ParamSpec((kl, hp, dv), ("kv_lora", "heads", "head_dim"), fan_in_axis=0),
        "wo": ParamSpec((hp, dv, d), ("heads", "head_dim", "embed"), fan_in_axis=1),
    }


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5


def _mla_q(cfg, p, x, positions):
    cq = rmsnorm(cfg, p["q_norm"], x @ p["wdq"])
    qh = torch.einsum("bsl,lhk->bshk", cq, p["wuq"])
    qn, qr = qh[..., :cfg.qk_nope_head_dim], qh[..., cfg.qk_nope_head_dim:]
    cos, sin = rope_freqs(cfg, cfg.qk_rope_head_dim, positions)
    qr = apply_rope(qr, cos[:, :, None, :], sin[:, :, None, :])
    return qn, qr


def _mla_kv_latent(cfg, p, x, positions):
    kl = cfg.kv_lora_rank
    dkv = x @ p["wdkv"]
    ckv = rmsnorm(cfg, p["kv_norm"], dkv[..., :kl])
    cos, sin = rope_freqs(cfg, cfg.qk_rope_head_dim, positions)
    kr = apply_rope(dkv[..., kl:], cos, sin)
    return ckv, kr


def mla_full(cfg: ModelConfig, p, x, *, cache: Optional[dict] = None):
    """Prefill (or a full forward) with k and v expanded from the latent;
    the flash op sees dq = nope + rope and dv = v_head_dim. If ``cache``
    is given, a new cache holding the latent and the roped key part is
    returned."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    qn, qr = _mla_q(cfg, p, x, positions)
    ckv, kr = _mla_kv_latent(cfg, p, x, positions)
    kn = torch.einsum("bsl,lhk->bshk", ckv, p["wuk"])
    v = torch.einsum("bsl,lhv->bshv", ckv, p["wuv"])
    k = torch.cat([kn, kr[:, :, None, :].expand(
        kn.shape[:3] + (cfg.qk_rope_head_dim,))], dim=-1)
    q = torch.cat([qn, qr], dim=-1)
    o = fops.flash_attention(q, k, v, scale=_mla_scale(cfg), causal=True)
    out = torch.einsum("bshv,hvd->bsd", o, p["wo"])
    if cache is not None:
        ckv_c, kr_c = cache["ckv"].clone(), cache["krope"].clone()
        ckv_c[:, :S] = ckv.to(ckv_c.dtype)
        kr_c[:, :S] = kr.to(kr_c.dtype)
        cache = dict(cache, ckv=ckv_c, krope=kr_c,
                     pos=torch.full_like(cache["pos"], S))
    return out, cache


def mla_decode(cfg: ModelConfig, p, x, cache, pos: int):
    """Absorbed MLA decode: W_uk folds into q and W_uv applies after the
    attention, so the scores read the (B, S, kv_lora) latent cache."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    qn, qr = _mla_q(cfg, p, x, positions)              # (B,1,H,*)
    ckv_t, kr_t = _mla_kv_latent(cfg, p, x, positions)  # (B,1,kl),(B,1,dr)
    ckv, krope = cache["ckv"].clone(), cache["krope"].clone()
    ckv[:, pos] = ckv_t[:, 0].to(ckv.dtype)
    krope[:, pos] = kr_t[:, 0].to(krope.dtype)
    q_abs = torch.einsum("bhn,lhn->bhl", qn[:, 0], p["wuk"])
    # f32 scores, as the reference's preferred_element_type=f32 einsum
    s = torch.einsum("bhl,bsl->bhs", q_abs.float(),
                     ckv.to(q_abs.dtype).float())
    s = s + torch.einsum("bhr,bsr->bhs", qr[:, 0].float(), krope.float())
    s = s * _mla_scale(cfg)
    k_pos = torch.arange(ckv.shape[1], device=x.device)
    s = torch.where(k_pos <= pos, s, torch.full((), NEG_INF, device=x.device))
    a = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsl->bhl", a.to(ckv.dtype), ckv)
    o = torch.einsum("bhl,lhv->bhv", o_lat, p["wuv"])
    out = torch.einsum("bhv,hvd->bd", o, p["wo"])[:, None, :]
    return out, dict(cache, ckv=ckv, krope=krope, pos=cache["pos"] + 1)


def mla_cache_spec(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Latent-cache entry to allocate, with its logical axes."""
    dt = torch_dtype(cfg.dtype)
    return {
        "ckv": TensorSpec((batch, seq, cfg.kv_lora_rank), dt,
                          ("act_batch", "act_kv_seq", None)),
        "krope": TensorSpec((batch, seq, cfg.qk_rope_head_dim), dt,
                            ("act_batch", "act_kv_seq", None)),
        "pos": TensorSpec((), torch.int32),
    }


# ---------------------------------------------------------------------------
# Dispatch helpers used by the block assembler.
# ---------------------------------------------------------------------------

def attn_template(cfg: ModelConfig) -> dict:
    return mla_template(cfg) if cfg.attn_type == "mla" else gqa_template(cfg)


def attn_full(cfg, p, x, cache=None, causal=True):
    if cfg.attn_type == "mla":
        assert causal, "MLA archs are decoder-only here"
        return mla_full(cfg, p, x, cache=cache)
    return gqa_full(cfg, p, x, cache=cache, causal=causal)


def attn_decode(cfg, p, x, cache, pos: int):
    if cfg.attn_type == "mla":
        return mla_decode(cfg, p, x, cache, pos)
    return gqa_decode(cfg, p, x, cache, pos)


def attn_cache_spec(cfg, batch, seq):
    if cfg.attn_type == "mla":
        return mla_cache_spec(cfg, batch, seq)
    return gqa_cache_spec(cfg, batch, seq)
