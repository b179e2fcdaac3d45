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
The write is an elementwise select (``_put_seq``), so a cache split along
its sequence over ``model`` (``act_kv_seq``) takes it in place on each
process's positions.
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
from repro_torch.parallel.sharding import (as_dtensor, constrain, einsum,
                                           is_dtensor, linear,
                                           local_shape_and_offset,
                                           redistribute)

NEG_INF = -1e30


@dataclass(frozen=True)
class TensorSpec:
    """Shape, dtype and logical axes of a tensor to allocate (a pytree
    leaf)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    axes: Tuple[Optional[str], ...] = ()


def _put_seq(c, new, start: int, off: int = 0):
    """Cache leaf ``c`` (B,S,...) with ``new`` (B,n,...) at sequence
    positions ``[start, start + n)``, as a new tensor (``c`` is never
    written): a select of ``new`` where the positions match, ``c``
    elsewhere. ``c`` holds the positions ``[off, off + S)``; a DTensor
    cache split along its sequence is written by each process on its own
    positions (``local_map``)."""
    if is_dtensor(c) or is_dtensor(new):
        return _put_seq_sharded(c, new, start)
    S, n = c.shape[1], new.shape[1]
    lo, hi = max(start, off), min(start + n, off + S)
    new = new.to(c.dtype)
    if n > 1:
        if hi <= lo:
            return c.clone()
        new = torch.nn.functional.pad(new[:, lo - start:hi - start], (
            0, 0) * (c.dim() - 2) + (lo - off, off + S - hi))
    p = off + torch.arange(S, device=c.device)
    at = ((p >= lo) & (p < hi)).reshape((1, S) + (1,) * (c.dim() - 2))
    return torch.where(at, new, c)


def _put_seq_sharded(c, new, start):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = (c if is_dtensor(c) else new).device_mesh
    c, new = as_dtensor(c, mesh), as_dtensor(new, mesh)
    c_pl = [p if type(p) is Shard else Replicate() for p in c.placements]
    new_pl = [Replicate() if p == Shard(1) else p for p in c_pl]
    _, off = local_shape_and_offset(c.shape, mesh, c_pl)
    return local_map(lambda cl, nl: _put_seq(cl, nl, start, off[1]),
                     out_placements=c_pl, in_placements=(c_pl, new_pl),
                     device_mesh=mesh)(redistribute(c, c_pl),
                                       redistribute(new, new_pl))


# ---------------------------------------------------------------------------
# Shared attention math (grouped einsum; no KV expansion).
# ---------------------------------------------------------------------------

def attend(q, k, v, *, q_pos, kv_len: int, scale: float, causal=True):
    """q: (B,Sq,H,dq) k: (B,Skv,KV,dq) v: (B,Skv,KV,dv) -> (B,Sq,H,dv).

    ``q_pos``: (Sq,) absolute positions of queries; keys occupy [0, Skv)
    and only positions ``<= q_pos`` and ``< kv_len`` are visible.
    """
    if is_dtensor(q) or is_dtensor(k):
        return _attend_sharded(q, k, v, q_pos, kv_len, scale, causal)
    return _attend(q, k, v, q_pos, kv_len, scale, causal)


def _scores(q, k, q_pos, kv_len, scale, causal, k0=0):
    """Masked f32 scores (B,KV,G,Sq,Skv) of keys at positions ``k0 +
    [0, Skv)``."""
    B, Sq, H, dq = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, dq)
    # f32 scores, as the reference's preferred_element_type=f32 einsum
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    k_pos = k0 + torch.arange(k.shape[1], device=q.device)
    ok = k_pos[None, :] < kv_len
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    return torch.where(ok, s, torch.full((), NEG_INF, device=q.device))


def _attend_sharded(q, k, v, q_pos, kv_len, scale, causal):
    """``attend`` on DTensors, each process on its own batch rows, heads
    and keys (``local_map``). q keeps its batch and head splits; k and v
    keep their batch and sequence splits (a decode cache split along its
    sequence over ``model``, ``act_kv_seq``), with all their heads, of
    which each process reads those its q heads need. Where the keys are
    split, q is gathered whole over those mesh dims and each process
    attends over its keys: the softmax's max and the weighted sums are
    combined by all-reduces over them (a (B,H,dv) sum per call, where
    gathering the cache would move all of it)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = (k if is_dtensor(k) else q).device_mesh
    q, k, v = (as_dtensor(t, mesh) for t in (q, k, v))
    kv_pl = [pl if type(pl) is Shard and pl.dim in (0, 1) else Replicate()
             for pl in k.placements]
    q_pl = [kp if kp == Shard(0) else Replicate() if kp == Shard(1)
            else qp if qp == Shard(2) else Replicate()
            for kp, qp in zip(kv_pl, q.placements)]
    q, k, v = (redistribute(q, q_pl), redistribute(k, kv_pl),
               redistribute(v, kv_pl))
    groups = [mesh.get_group(i) for i, pl in enumerate(kv_pl)
              if pl == Shard(1)]
    qs, q_off = local_shape_and_offset(q.shape, mesh, q_pl)
    _, k_off = local_shape_and_offset(k.shape, mesh, kv_pl)
    pick = fops._kv_heads(q_off[2], qs[2], q.shape[2], k.shape[2])

    def local(ql, kl, vl):
        kl, vl = pick(kl), pick(vl)
        s = _scores(ql, kl, q_pos, kv_len, scale, causal, k_off[1])
        if not groups:
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("bkgqs,bskv->bqkgv", p.to(vl.dtype), vl)
            return o.reshape(ql.shape[:3] + vl.shape[3:])
        m = s.amax(-1, keepdim=True)
        for g in groups:
            m = funcol.all_reduce(m, "max", g)
        p = torch.exp(s - m)
        den = p.sum(-1, keepdim=True)
        o = torch.einsum("bkgqs,bskv->bkgqv", p.to(vl.dtype), vl).float()
        for g in groups:
            den = funcol.all_reduce(den, "sum", g)
            o = funcol.all_reduce(o, "sum", g)
        o = (o / den).to(vl.dtype).permute(0, 3, 1, 2, 4)
        return o.reshape(ql.shape[:3] + vl.shape[3:])

    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl),
                     device_mesh=mesh)(q, k, v)


def _attend(q, k, v, q_pos, kv_len, scale, causal):
    B, Sq, H, dq = q.shape
    p = torch.softmax(_scores(q, k, q_pos, kv_len, scale, causal), dim=-1)
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
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    cos, sin = rope_freqs(cfg, cfg.hdim, positions)   # (B, S, hd/2)
    q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])
    k = apply_rope(k, cos[:, :, None, :], sin[:, :, None, :])
    q = constrain(q, None, "act_batch", None, "act_heads", None)
    k = constrain(k, None, "act_batch", None, "act_kv_heads", None)
    return q, k, v


def gqa_full(cfg: ModelConfig, p, x, *, cache: Optional[dict] = None,
             causal: bool = True):
    """Prefill (or a full forward). If ``cache`` is given, a new cache
    holding this sequence's keys and values is returned."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(cfg, p, x, positions)
    o = fops.flash_attention(q, k, v, scale=cfg.hdim ** -0.5, causal=causal)
    o = constrain(o, None, "act_batch", None, "act_heads", None)
    out = einsum("bshk,hkd->bsd", o, p["wo"])
    if cache is not None:
        cache = dict(cache, k=_put_seq(cache["k"], k, 0),
                     v=_put_seq(cache["v"], v, 0),
                     pos=torch.full_like(cache["pos"], S))
    return out, cache


def gqa_decode(cfg: ModelConfig, p, x, cache, pos: int):
    """x: (B,1,D); cache k/v: (B,Scache,KV,hd); ``pos``: the cache's fill
    position, read once per decode step by the caller."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions)
    kc = constrain(_put_seq(cache["k"], k, pos), None, "act_batch",
                   "act_kv_seq", "act_kv_heads", None)
    vc = constrain(_put_seq(cache["v"], v, pos), None, "act_batch",
                   "act_kv_seq", "act_kv_heads", None)
    o = attend(q, kc.to(q.dtype), vc.to(q.dtype),
               q_pos=torch.arange(pos, pos + 1, device=x.device),
               kv_len=pos + 1, scale=cfg.hdim ** -0.5)
    out = einsum("bshk,hkd->bsd", o, p["wo"])
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
    cq = rmsnorm(cfg, p["q_norm"], linear(x, p["wdq"]))
    qh = einsum("bsl,lhk->bshk", cq, p["wuq"])
    qn, qr = qh[..., :cfg.qk_nope_head_dim], qh[..., cfg.qk_nope_head_dim:]
    cos, sin = rope_freqs(cfg, cfg.qk_rope_head_dim, positions)
    qr = apply_rope(qr, cos[:, :, None, :], sin[:, :, None, :])
    return (constrain(qn, None, "act_batch", None, "act_heads", None),
            constrain(qr, None, "act_batch", None, "act_heads", None))


def _mla_kv_latent(cfg, p, x, positions):
    kl = cfg.kv_lora_rank
    dkv = linear(x, p["wdkv"])
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
    kn = einsum("bsl,lhk->bshk", ckv, p["wuk"])
    v = einsum("bsl,lhv->bshv", ckv, p["wuv"])
    k = torch.cat([kn, kr[:, :, None, :].expand(
        kn.shape[:3] + (cfg.qk_rope_head_dim,))], dim=-1)
    q = torch.cat([qn, qr], dim=-1)
    o = fops.flash_attention(q, k, v, scale=_mla_scale(cfg), causal=True)
    out = einsum("bshv,hvd->bsd", o, p["wo"])
    if cache is not None:
        cache = dict(cache, ckv=_put_seq(cache["ckv"], ckv, 0),
                     krope=_put_seq(cache["krope"], kr, 0),
                     pos=torch.full_like(cache["pos"], S))
    return out, cache


def mla_decode(cfg: ModelConfig, p, x, cache, pos: int):
    """Absorbed MLA decode: W_uk folds into q and W_uv applies after the
    attention, so the scores read the (B, S, kv_lora) latent cache."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    qn, qr = _mla_q(cfg, p, x, positions)              # (B,1,H,*)
    ckv_t, kr_t = _mla_kv_latent(cfg, p, x, positions)  # (B,1,kl),(B,1,dr)
    ckv = constrain(_put_seq(cache["ckv"], ckv_t, pos), None, "act_batch",
                    "act_kv_seq", None)
    krope = constrain(_put_seq(cache["krope"], kr_t, pos), None, "act_batch",
                      "act_kv_seq", None)
    q_abs = einsum("bhn,lhn->bhl", qn[:, 0], p["wuk"])
    # f32 scores, as the reference's preferred_element_type=f32 einsum
    s = einsum("bhl,bsl->bhs", q_abs.float(),
                     ckv.to(q_abs.dtype).float())
    s = s + einsum("bhr,bsr->bhs", qr[:, 0].float(), krope.float())
    s = s * _mla_scale(cfg)
    k_pos = torch.arange(ckv.shape[1], device=x.device)
    s = torch.where(k_pos <= pos, s, torch.full((), NEG_INF, device=x.device))
    a = torch.softmax(s, dim=-1)
    o_lat = einsum("bhs,bsl->bhl", a.to(ckv.dtype), ckv)
    o = einsum("bhl,lhv->bhv", o_lat, p["wuv"])
    out = einsum("bhv,hvd->bd", o, p["wo"])[:, None, :]
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
