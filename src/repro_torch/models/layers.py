"""Common layers: RMSNorm, RoPE, SwiGLU MLP, embeddings, LM head.

Plain functions on tensors with the reference's math
(``repro.models.layers``); params come from the sibling ``*_template``
functions so shapes and init live in one place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec, torch_dtype


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
    h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    return h @ p["wo"]


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


def embed(cfg: ModelConfig, p, tokens):
    return p["embedding"][tokens.long()].to(adt(cfg))


def lm_logits(cfg: ModelConfig, p, x):
    w = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    return (x @ w).float()
