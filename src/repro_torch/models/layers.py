"""Common layers: RMSNorm, RoPE, SwiGLU MLP, embeddings, LM head.

Plain functions on tensors with the reference's math
(``repro.models.layers``); params come from the sibling ``*_template``
functions so shapes and init live in one place. The activation sites
where the reference constrains its sharding call ``constrain`` with the
same logical names and the rules in use (``parallel.sharding.use_rules``):
on DTensors that is where tensor parallelism redistributes.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec, torch_dtype
from repro_torch.parallel.sharding import (as_dtensor, constrain, einsum,
                                           is_dtensor, linear,
                                           local_shape_and_offset,
                                           redistribute)


def adt(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_template(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def rmsnorm(cfg: ModelConfig, p, x):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + cfg.norm_eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, dim: int, positions):
    """positions: (...,) int -> cos, sin of shape (..., dim//2), f32."""
    half = dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., dim); cos/sin broadcastable to (..., dim//2)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_template(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), ("embed", "ff"), fan_in_axis=0),
        "wi_up": ParamSpec((d, f), ("embed", "ff"), fan_in_axis=0),
        "wo": ParamSpec((f, d), ("ff", "embed"), fan_in_axis=0),
    }


def mlp(cfg: ModelConfig, p, x):
    h = F.silu(linear(x, p["wi_gate"])) * linear(x, p["wi_up"])
    h = constrain(h, None, "act_batch", None, "act_ff")
    return linear(h, p["wo"])


# ---------------------------------------------------------------------------
# Embedding + LM head (vocab padded)
# ---------------------------------------------------------------------------

def embed_template(cfg: ModelConfig) -> dict:
    t = {"embedding": ParamSpec((cfg.vocab_padded, cfg.d_model),
                                ("vocab", "embed"), scale=1.0)}
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_padded),
                                 ("embed", "vocab"), fan_in_axis=0)
    return t


def _embed_split(table, tokens):
    """The gather on DTensors, which has no rule for a vocab-split table:
    each process looks up the tokens of its batch rows that fall in the
    vocab rows it holds, zeros for the rest, and the lookups are a
    pending sum over the vocab split (reduced at the constraint). The
    table is first gathered whole along its embed dim (fsdp splits it)
    and over the mesh dims that split the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    tokens = as_dtensor(tokens, table.device_mesh)
    tok_pl = [pl if pl == Shard(0) else Replicate()
              for pl in tokens.placements]
    tab_pl = [Shard(0) if pl == Shard(0) and tp != Shard(0) else Replicate()
              for pl, tp in zip(table.placements, tok_pl)]
    out_pl = [Partial() if t == Shard(0) else tp
              for t, tp in zip(tab_pl, tok_pl)]
    grad_pl = [Partial() if tp == Shard(0) else t
               for t, tp in zip(tab_pl, tok_pl)]
    (rows, _), (v0, _) = local_shape_and_offset(
        table.shape, table.device_mesh, tab_pl)

    def lookup(t, tok):
        tok = tok.long() - v0
        mine = (tok >= 0) & (tok < rows)
        x = F.embedding(torch.where(mine, tok, torch.zeros_like(tok)), t)
        return x * mine[..., None].to(x.dtype)

    return local_map(lookup, out_placements=out_pl,
                     in_placements=(tab_pl, tok_pl),
                     in_grad_placements=(grad_pl, tok_pl),
                     device_mesh=table.device_mesh)(
        redistribute(table, tab_pl), redistribute(tokens, tok_pl))


def embed(cfg: ModelConfig, p, tokens):
    if is_dtensor(p["embedding"]):
        x = _embed_split(p["embedding"], tokens).to(adt(cfg))
    else:
        x = p["embedding"][tokens.long()].to(adt(cfg))
    return constrain(x, None, "act_batch", None, None)


def lm_logits(cfg: ModelConfig, p, x):
    lead = "abcdefgh"[:x.dim() - 1]
    logits = einsum(f"{lead}d,vd->{lead}v", x, p["embedding"]) \
        if cfg.tie_embeddings else linear(x, p["lm_head"])
    return constrain(logits.float(), None, "act_batch", None, "act_vocab")


def _nll_split(logits, labels, vocab: int):
    """Per-token negative log-likelihood of DTensor logits whose vocab may
    be split (``act_vocab``), the padded ids from ``vocab`` on masked:
    each process takes its rows and its vocab slice (``local_map``); the
    log-sum-exp's max and sum and the gold
    logit (a masked sum: the gather of a split vocab has no DTensor rule)
    are (B,S) all-reduces over the mesh dims that split the vocab, where
    gathering the logits would move them all."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.parallel import _collectives as coll
    mesh = logits.device_mesh
    v_dim = logits.dim() - 1
    pl = [p if type(p) is Shard and p.dim in (0, v_dim) else Replicate()
          for p in logits.placements]
    logits = redistribute(logits, pl)
    labels = redistribute(as_dtensor(labels, mesh),
                          [p if p == Shard(0) else Replicate() for p in pl])
    groups = [mesh.get_group(i) for i, p in enumerate(pl) if p == Shard(v_dim)]
    (_, *_, v_n), (*_, v0) = local_shape_and_offset(logits.shape, mesh, pl)

    def nll(z, lab):
        ids = v0 + torch.arange(v_n, device=z.device)
        z = z.masked_fill(ids >= vocab, -1e30)
        m = coll.combine(z.detach().amax(-1), "max", groups)
        lse = torch.log(coll.combine(torch.exp(z - m[..., None]).sum(-1),
                                     "sum", groups)) + m
        gold = coll.combine(torch.where(
            ids == lab[..., None].long(), z, torch.zeros((), device=z.device,
                                                         dtype=z.dtype)
        ).sum(-1), "sum", groups)
        return lse - gold

    rows = [p if p == Shard(0) else Replicate() for p in pl]
    return local_map(nll, out_placements=rows, in_placements=(pl, rows),
                     in_grad_placements=(pl, rows), device_mesh=mesh)(
        logits, labels)


def xent_loss(cfg: ModelConfig, logits, labels, mask=None):
    """Cross-entropy with padded-vocab masking; logits f32 (..., vocab_padded)."""
    vp, v = cfg.vocab_padded, cfg.vocab_size
    if is_dtensor(logits):
        nll = _nll_split(logits, labels, v)
    else:
        if vp != v:
            logits = logits.masked_fill(torch.arange(
                vp, device=logits.device) >= v, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
