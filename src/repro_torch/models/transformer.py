"""LM assembler for attention-dense and Mamba-only architectures.

The per-layer block types of ``ModelConfig.block_type`` are compressed
into *stages* ``(pattern, repeats)`` and each stage's parameters are
stacked along a leading ``repeats`` axis, exactly as in
``repro.models.transformer``, so the param and cache trees keep the
reference's keys and shapes. Where the reference runs a stage under
``lax.scan``, the port loops over the repeats in Python over views of the
stacked weights (``torch.unbind``: under autograd, one unbind per leaf
stacks the repeats' gradients once, where indexing each repeat would
give every repeat's backward a zero tensor of the whole stacked leaf).

Modes:
  * ``full``    — train forward over a whole sequence (no cache),
  * ``prefill`` — full forward that also fills decode caches,
  * ``decode``  — one token against caches.

Ported blocks: ``attn_dense`` (GQA attention + MLP) and ``mamba_only``
(Mamba mixer, no MLP). MoE, the hybrid Mamba blocks, encoder-decoder,
the frontend stubs and MTP raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import _tree
from repro_torch.configs.base import (ATTN_DENSE, MAMBA_ONLY, ModelConfig,
                                      RunConfig)
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models.attention import TensorSpec
from repro_torch.models.layers import (embed, embed_template, lm_logits, mlp,
                                       mlp_template, rmsnorm, rmsnorm_template,
                                       xent_loss)
from repro_torch.models.params import stack_specs

_PORTED_BLOCKS = (ATTN_DENSE, MAMBA_ONLY)


def check_ported(cfg: ModelConfig):
    """Raise for the parts of ``cfg`` this port does not run yet."""
    missing = [what for what, on in (
        ("encoder-decoder", cfg.is_encoder_decoder),
        ("frontend stub", bool(cfg.frontend)),
        ("multi-token prediction", cfg.mtp)) if on]
    missing += sorted({bt for bt in (cfg.block_type(i)
                                     for i in range(cfg.n_layers))
                       if bt not in _PORTED_BLOCKS})
    attention_free = cfg.family == "ssm" and cfg.attn_type == "none"
    if cfg.attn_type != "gqa" and not attention_free:
        missing.append(f"{cfg.attn_type} attention")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(missing)}")


# ---------------------------------------------------------------------------
# Block template / apply
# ---------------------------------------------------------------------------

def block_template(cfg: ModelConfig, bt: str) -> dict:
    d = cfg.d_model
    if bt == MAMBA_ONLY:
        return {"ln1": rmsnorm_template(d), "mixer": mam.mamba_template(cfg)}
    return {"ln1": rmsnorm_template(d), "attn": attn.attn_template(cfg),
            "ln2": rmsnorm_template(d), "mlp": mlp_template(cfg)}


def block_apply(cfg: ModelConfig, run: RunConfig, bt: str, p, x, *,
                mode: str, cache=None, pos: Optional[int] = None):
    """One attention-dense or Mamba-only block. Returns (x, cache)."""
    h = rmsnorm(cfg, p["ln1"], x)
    if bt == MAMBA_ONLY:
        if mode == "decode":
            a, cache = mam.mamba_decode(cfg, p["mixer"], h, cache)
        else:
            a, cache = mam.mamba_full(
                cfg, p["mixer"], h,
                cache=cache if mode == "prefill" else None,
                chunk=run.ssm_chunk, scan_dtype=run.ssm_scan_dtype)
        return x + a, cache
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
        stage = {f"pos_{j}": block_template(cfg, bt)
                 for j, bt in enumerate(pattern)}
        t[f"stage_{si}"] = stack_specs(stage, reps)
    t["final_norm"] = rmsnorm_template(cfg.d_model)
    return t


# ---------------------------------------------------------------------------
# Stage runner (a loop over the stacked repeats)
# ---------------------------------------------------------------------------

def _stack(trees):
    return _tree.tree_map(lambda *xs: torch.stack(xs), *trees)


def _repeats(tree, reps: int):
    """The ``reps`` per-repeat views of a stacked tree (one ``unbind`` per
    leaf)."""
    if tree is None:
        return [None] * reps
    per_leaf = [torch.unbind(a) for a in _tree.tree_leaves(tree)]
    return [_tree.unflatten_like(tree, [u[r] for u in per_leaf])
            for r in range(reps)]


def _remat(run: RunConfig, fn):
    """Recompute ``fn`` (one repeat's body) in the backward instead of
    saving its activations, as the reference's ``jax.checkpoint``.
    ``"dots_saveable"`` recomputes the whole body too: torch's checkpoint
    has no policy that keeps the matrix products' outputs."""
    if run.remat == "none" or not torch.is_grad_enabled():
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def run_stages(cfg, run, params, x, *, mode, caches=None, pos=None):
    """Run every stage. Returns (x, new_caches)."""
    new_caches = {} if caches is not None else None
    for si, (pattern, reps) in enumerate(cfg.stages()):
        key = f"stage_{si}"
        c_in = caches.get(key) if caches is not None else None

        def body(xx, lp, lc, _pattern=pattern):
            c_out = {}
            for j, bt in enumerate(_pattern):
                cj = None if lc is None else lc[f"pos_{j}"]
                xx, c_out[f"pos_{j}"] = block_apply(
                    cfg, run, bt, lp[f"pos_{j}"], xx, mode=mode, cache=cj,
                    pos=pos)
            return xx, c_out

        body = _remat(run, body) if mode == "full" else body
        c_out = []
        for lp, lc in zip(_repeats(params[key], reps), _repeats(c_in, reps)):
            x, cr = body(x, lp, lc)
            c_out.append(cr)
        if new_caches is not None:
            new_caches[key] = _stack(c_out)
    return x, new_caches


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def forward_train(cfg: ModelConfig, run: RunConfig, params, batch):
    """batch: tokens (B,S), labels (B,S), optional loss_mask (B,S).

    Returns (loss, metrics); the metrics' keys are the reference's
    (``aux`` is a float32 zero: no ported block has an auxiliary loss).
    """
    x = embed(cfg, params["embed"], batch["tokens"])
    x, _ = run_stages(cfg, run, params, x, mode="full")
    x = rmsnorm(cfg, params["final_norm"], x)
    logits = lm_logits(cfg, params["embed"], x)
    # next-token loss
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    loss = xent_loss(cfg, logits[:, :-1], labels[:, 1:],
                     None if mask is None else mask[:, 1:])
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    metrics = {"xent": loss, "aux": aux}
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


def forward_prefill(cfg, run, params, batch, cache):
    """Full forward filling caches; returns (last-position logits, cache)."""
    x = embed(cfg, params["embed"], batch["tokens"])
    x, cache = run_stages(cfg, run, params, x, mode="prefill", caches=cache)
    x = rmsnorm(cfg, params["final_norm"], x[:, -1:, :])
    return lm_logits(cfg, params["embed"], x)[:, 0], cache


def cache_position(cache) -> int:
    """The fill position every layer's cache shares. One host read per
    decode step (not one per layer)."""
    return int(cache["stage_0"]["pos_0"]["pos"][0])


def forward_decode(cfg, run, params, tokens, cache):
    """tokens: (B,) int. Returns (logits (B,V), cache)."""
    pos = cache_position(cache)
    x = embed(cfg, params["embed"], tokens[:, None])
    x, cache = run_stages(cfg, run, params, x, mode="decode", caches=cache,
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
        val[f"stage_{si}"] = {
            f"pos_{j}": _tree.tree_map(
                lambda s: TensorSpec((reps,) + s.shape, s.dtype),
                mam.mamba_cache_spec(cfg, batch, seq) if bt == MAMBA_ONLY
                else attn.attn_cache_spec(cfg, batch, seq))
            for j, bt in enumerate(pattern)}
    return val


def init_cache(cfg: ModelConfig, batch: int, seq: int, device="cpu"):
    return _tree.tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
        cache_spec(cfg, batch, seq))
