"""LM assembler for attention-dense architectures.

The per-layer block types of ``ModelConfig.block_type`` are compressed
into *stages* ``(pattern, repeats)`` and each stage's parameters are
stacked along a leading ``repeats`` axis, exactly as in
``repro.models.transformer``, so the param and cache trees keep the
reference's keys and shapes. Where the reference runs a stage under
``lax.scan``, the port loops over the repeats in Python and indexes the
stacked weights.

Modes:
  * ``prefill`` — full forward that also fills decode caches,
  * ``decode``  — one token against caches.

Only ``attn_dense`` blocks are ported; MoE, Mamba, encoder-decoder, the
frontend stubs and MTP raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import _tree
from repro_torch.configs.base import ATTN_DENSE, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.attention import TensorSpec
from repro_torch.models.layers import (embed, embed_template, lm_logits, mlp,
                                       mlp_template, rmsnorm, rmsnorm_template)
from repro_torch.models.params import stack_specs


def check_ported(cfg: ModelConfig):
    """Raise for the parts of ``cfg`` this port does not run yet."""
    missing = [what for what, on in (
        ("encoder-decoder", cfg.is_encoder_decoder),
        ("frontend stub", bool(cfg.frontend)),
        ("multi-token prediction", cfg.mtp)) if on]
    missing += sorted({bt for bt in (cfg.block_type(i)
                                     for i in range(cfg.n_layers))
                       if bt != ATTN_DENSE})
    if cfg.attn_type != "gqa":
        missing.append(f"{cfg.attn_type} attention")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(missing)}")


# ---------------------------------------------------------------------------
# Block template / apply
# ---------------------------------------------------------------------------

def block_template(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": rmsnorm_template(d), "attn": attn.attn_template(cfg),
            "ln2": rmsnorm_template(d), "mlp": mlp_template(cfg)}


def block_apply(cfg: ModelConfig, p, x, *, mode: str, cache=None,
                pos: Optional[int] = None):
    """One attention-dense block. Returns (x, cache)."""
    h = rmsnorm(cfg, p["ln1"], x)
    if mode == "decode":
        a, cache = attn.attn_decode(cfg, p["attn"], h, cache, pos)
    else:
        a, cache = attn.attn_full(cfg, p["attn"], h,
                                  cache=cache if mode == "prefill" else None)
    x = x + a
    h = rmsnorm(cfg, p["ln2"], x)
    return x + mlp(cfg, p["mlp"], h), cache


# ---------------------------------------------------------------------------
# Whole-model template
# ---------------------------------------------------------------------------

def model_template(cfg: ModelConfig) -> dict:
    check_ported(cfg)
    t: Dict[str, Any] = {"embed": embed_template(cfg)}
    for si, (pattern, reps) in enumerate(cfg.stages()):
        stage = {f"pos_{j}": block_template(cfg) for j in range(len(pattern))}
        t[f"stage_{si}"] = stack_specs(stage, reps)
    t["final_norm"] = rmsnorm_template(cfg.d_model)
    return t


# ---------------------------------------------------------------------------
# Stage runner (a loop over the stacked repeats)
# ---------------------------------------------------------------------------

def _stack(trees):
    return _tree.tree_map(lambda *xs: torch.stack(xs), *trees)


def run_stages(cfg, params, x, *, mode, caches=None, pos=None):
    """Run every stage. Returns (x, new_caches)."""
    new_caches = {} if caches is not None else None
    for si, (pattern, reps) in enumerate(cfg.stages()):
        key = f"stage_{si}"
        sp = params[key]
        c_in = caches.get(key) if caches is not None else None
        c_out = {f"pos_{j}": [] for j in range(len(pattern))}
        for r in range(reps):
            for j in range(len(pattern)):
                pj = _tree.tree_map(lambda a: a[r], sp[f"pos_{j}"])
                cj = None if c_in is None else \
                    _tree.tree_map(lambda a: a[r], c_in[f"pos_{j}"])
                x, cj = block_apply(cfg, pj, x, mode=mode, cache=cj, pos=pos)
                if cj is not None:
                    c_out[f"pos_{j}"].append(cj)
        if new_caches is not None:
            new_caches[key] = {k: _stack(v) for k, v in c_out.items()}
    return x, new_caches


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def forward_prefill(cfg, params, batch, cache):
    """Full forward filling caches; returns (last-position logits, cache)."""
    x = embed(cfg, params["embed"], batch["tokens"])
    x, cache = run_stages(cfg, params, x, mode="prefill", caches=cache)
    x = rmsnorm(cfg, params["final_norm"], x[:, -1:, :])
    return lm_logits(cfg, params["embed"], x)[:, 0], cache


def cache_position(cache) -> int:
    """The fill position every layer's cache shares. One host read per
    decode step (not one per layer)."""
    return int(cache["stage_0"]["pos_0"]["pos"][0])


def forward_decode(cfg, params, tokens, cache):
    """tokens: (B,) int. Returns (logits (B,V), cache)."""
    pos = cache_position(cache)
    x = embed(cfg, params["embed"], tokens[:, None])
    x, cache = run_stages(cfg, params, x, mode="decode", caches=cache,
                          pos=pos)
    x = rmsnorm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params["embed"], x)[:, 0], cache


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Decode-cache pytree of :class:`TensorSpec` (stacked per stage)."""
    check_ported(cfg)
    val: Dict[str, Any] = {}
    for si, (pattern, reps) in enumerate(cfg.stages()):
        entry = attn.attn_cache_spec(cfg, batch, seq)
        val[f"stage_{si}"] = {
            f"pos_{j}": _tree.tree_map(
                lambda s: TensorSpec((reps,) + s.shape, s.dtype), entry)
            for j in range(len(pattern))}
    return val


def init_cache(cfg: ModelConfig, batch: int, seq: int, device="cpu"):
    return _tree.tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
        cache_spec(cfg, batch, seq))
