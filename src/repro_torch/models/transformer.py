"""LM assembler for every architecture family of the model zoo.

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

Blocks: attention (GQA or MLA) or a Mamba mixer, then a dense MLP or an
MoE (none for ``mamba_only``). Encoder-decoder (seamless) adds a
non-causal encoder stack and cross-attention in every decoder block; the
VLM / speech frontends are embedding stubs (``frontend_embeds`` prepended
to the token embeddings); deepseek's MTP head adds a next-next-token
loss. ``moe_impl="manual_ep"`` exchanges tokens with the experts' owners
by ``all_to_all`` when a mesh is in use (``parallel.sharding.use_mesh``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import _tree
from repro_torch.configs.base import (ATTN_DENSE, ATTN_MOE, MAMBA_MOE,
                                      MAMBA_ONLY, ModelConfig, RunConfig)
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import TensorSpec
from repro_torch.models.layers import (adt, embed, embed_template, lm_logits,
                                       mlp, mlp_template, rmsnorm,
                                       rmsnorm_template, xent_loss)
from repro_torch.models.params import ParamSpec, stack_specs, torch_dtype


def _has_attn(bt: str) -> bool:
    return bt in (ATTN_DENSE, ATTN_MOE)


def _has_moe(bt: str) -> bool:
    return bt in (ATTN_MOE, MAMBA_MOE)


def _has_mlp(bt: str) -> bool:
    return bt != MAMBA_ONLY


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder only): GQA projections, no RoPE.
# ---------------------------------------------------------------------------

def xattn_template(cfg: ModelConfig) -> dict:
    return attn.gqa_template(cfg)


def xattn_full(cfg, p, x, enc_out, cache=None):
    """Decoder queries over the encoder output (non-causal, Sq != Skv);
    with ``cache``, a new cache holding the encoder's keys and values."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    o = fops.flash_attention(q, k, v, scale=cfg.hdim ** -0.5, causal=False)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    if cache is not None:
        cache = dict(cache, xk=k.to(cache["xk"].dtype),
                     xv=v.to(cache["xv"].dtype))
    return out, cache


def xattn_decode(cfg, p, x, cache):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k, v = cache["xk"].to(q.dtype), cache["xv"].to(q.dtype)
    o = attn.attend(q, k, v, q_pos=torch.zeros(1, dtype=torch.long,
                                                device=x.device),
                    kv_len=k.shape[1], scale=cfg.hdim ** -0.5, causal=False)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), cache


# ---------------------------------------------------------------------------
# Block template / apply
# ---------------------------------------------------------------------------

def block_template(cfg: ModelConfig, bt: str, *, cross: bool = False) -> dict:
    d = cfg.d_model
    t: Dict[str, Any] = {"ln1": rmsnorm_template(d)}
    if _has_attn(bt):
        t["attn"] = attn.attn_template(cfg)
    else:
        t["mixer"] = mam.mamba_template(cfg)
    if cross:
        t["ln_x"] = rmsnorm_template(d)
        t["xattn"] = xattn_template(cfg)
    if _has_mlp(bt):
        t["ln2"] = rmsnorm_template(d)
        t["moe" if _has_moe(bt) else "mlp"] = (
            moe_mod.moe_template(cfg) if _has_moe(bt) else mlp_template(cfg))
    return t


def block_cache_spec(cfg: ModelConfig, bt: str, batch: int, seq: int,
                     *, cross: bool = False, enc_len: int = 0) -> dict:
    spec = dict(attn.attn_cache_spec(cfg, batch, seq) if _has_attn(bt)
                else mam.mamba_cache_spec(cfg, batch, seq))
    if cross:
        kvp, hd = cfg.kv_heads_padded, cfg.hdim
        dt = torch_dtype(cfg.dtype)
        axes = ("act_batch", None, "act_kv_heads", None)
        spec["xk"] = TensorSpec((batch, enc_len, kvp, hd), dt, axes)
        spec["xv"] = TensorSpec((batch, enc_len, kvp, hd), dt, axes)
    return spec


def block_apply(cfg: ModelConfig, run: RunConfig, bt: str, p, x, *,
                mode: str, cache=None, pos: Optional[int] = None,
                enc_out=None, causal: bool = True):
    """One block. Returns (x, cache, aux): aux is the MoE's load-balance
    loss, a float32 zero for the other blocks."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(cfg, p["ln1"], x)
    if _has_attn(bt):
        if mode == "decode":
            a, cache = attn.attn_decode(cfg, p["attn"], h, cache, pos)
        else:
            a, cache = attn.attn_full(
                cfg, p["attn"], h, cache=cache if mode == "prefill" else None,
                causal=causal)
    else:
        if mode == "decode":
            a, cache = mam.mamba_decode(cfg, p["mixer"], h, cache)
        else:
            a, cache = mam.mamba_full(
                cfg, p["mixer"], h,
                cache=cache if mode == "prefill" else None,
                chunk=run.ssm_chunk, scan_dtype=run.ssm_scan_dtype)
    x = x + a
    if "xattn" in p:
        h = rmsnorm(cfg, p["ln_x"], x)
        if mode == "decode":
            xa, cache = xattn_decode(cfg, p["xattn"], h, cache)
        else:
            xa, cache = xattn_full(cfg, p["xattn"], h, enc_out,
                                   cache=cache if mode == "prefill" else None)
        x = x + xa
    if _has_mlp(bt):
        h = rmsnorm(cfg, p["ln2"], x)
        if _has_moe(bt):
            m, aux = moe_mod.MOE_IMPLS[run.moe_impl](cfg, p["moe"], h)
        else:
            m = mlp(cfg, p["mlp"], h)
        x = x + m
    return x, cache, aux


# ---------------------------------------------------------------------------
# Whole-model template
# ---------------------------------------------------------------------------

def model_template(cfg: ModelConfig) -> dict:
    t: Dict[str, Any] = {"embed": embed_template(cfg)}
    cross = cfg.is_encoder_decoder
    for si, (pattern, reps) in enumerate(cfg.stages()):
        stage = {f"pos_{j}": block_template(cfg, bt, cross=cross)
                 for j, bt in enumerate(pattern)}
        t[f"stage_{si}"] = stack_specs(stage, reps)
    t["final_norm"] = rmsnorm_template(cfg.d_model)
    if cfg.is_encoder_decoder:
        enc = {"pos_0": block_template(cfg, ATTN_DENSE)}
        t["enc_stage"] = stack_specs(enc, cfg.n_encoder_layers)
        t["enc_norm"] = rmsnorm_template(cfg.d_model)
    if cfg.mtp:
        t["mtp_proj"] = ParamSpec((2 * cfg.d_model, cfg.d_model),
                                  ("embed", "embed"), fan_in_axis=0)
        t["mtp_block"] = block_template(cfg, ATTN_DENSE)
        t["mtp_norm"] = rmsnorm_template(cfg.d_model)
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


def run_stages(cfg, run, params, x, *, mode, caches=None, pos=None,
               enc_out=None, causal=True, prefix="stage"):
    """Run every stage (``prefix="enc"``: the encoder's one stage).
    Returns (x, new_caches, aux_sum)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = {} if caches is not None else None
    stages = cfg.stages() if prefix == "stage" \
        else ((("enc",), cfg.n_encoder_layers),)
    for si, (pattern, _) in enumerate(stages):
        key = f"stage_{si}" if prefix == "stage" else "enc_stage"
        c_in = caches.get(key) if caches is not None else None
        # the repeats this process holds: all of them, or a pipeline
        # stage's slice of them
        reps = _tree.tree_leaves(params[key])[0].shape[0]

        def body(xx, lp, lc, _pattern=pattern):
            c_out = {}
            aux = torch.zeros((), dtype=torch.float32, device=xx.device)
            for j, bt in enumerate(_pattern):
                cj = None if lc is None else lc[f"pos_{j}"]
                xx, c_out[f"pos_{j}"], a = block_apply(
                    cfg, run, ATTN_DENSE if bt == "enc" else bt,
                    lp[f"pos_{j}"], xx, mode=mode, cache=cj, pos=pos,
                    enc_out=enc_out, causal=causal)
                aux = aux + a
            return xx, c_out, aux

        body = _remat(run, body) if mode == "full" else body
        c_out = []
        for lp, lc in zip(_repeats(params[key], reps), _repeats(c_in, reps)):
            x, cr, a = body(x, lp, lc)
            aux_total = aux_total + a
            c_out.append(cr)
        if new_caches is not None:
            new_caches[key] = _stack(c_out)
    return x, new_caches, aux_total


# ---------------------------------------------------------------------------
# Input embedding front (tokens + optional frontend stub prefix)
# ---------------------------------------------------------------------------

def embed_inputs(cfg, params, batch):
    x = embed(cfg, params["embed"], batch["tokens"])
    if cfg.frontend and "frontend_embeds" in batch:
        fe = batch["frontend_embeds"].to(x.dtype)
        x = torch.cat([fe, x], dim=1)
    return x


def encode(cfg, run, params, batch):
    """Encoder stack over stub frame embeddings (seamless), non-causal."""
    x = batch["encoder_embeds"].to(adt(cfg))
    x, _, _ = run_stages(cfg, run, params, x, mode="full", causal=False,
                         prefix="enc")
    return rmsnorm(cfg, params["enc_norm"], x)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def forward_train(cfg: ModelConfig, run: RunConfig, params, batch):
    """batch: tokens (B,S[-F]), labels (B,S[-F]), optional loss_mask and
    modality stubs (``frontend_embeds`` (B,F,D), ``encoder_embeds``).

    Returns (loss, metrics) with the reference's keys: ``xent``, ``aux``
    (the MoE layers' summed load-balance loss), ``mtp`` (with an MTP
    head) and ``loss``.
    """
    enc_out = encode(cfg, run, params, batch) if cfg.is_encoder_decoder \
        else None
    x = embed_inputs(cfg, params, batch)
    x, _, aux = run_stages(cfg, run, params, x, mode="full", enc_out=enc_out)
    x = rmsnorm(cfg, params["final_norm"], x)
    logits = lm_logits(cfg, params["embed"], x)

    n_front = batch["frontend_embeds"].shape[1] if (
        cfg.frontend and "frontend_embeds" in batch) else 0
    # next-token loss over token positions (frontend prefix excluded)
    tok_logits = logits[:, n_front:, :]
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    loss = xent_loss(cfg, tok_logits[:, :-1], labels[:, 1:],
                     None if mask is None else mask[:, 1:])
    metrics = {"xent": loss, "aux": aux}
    if cfg.mtp:
        emb_next = embed(cfg, params["embed"], F.pad(labels[:, 1:], (0, 1)))
        h = torch.cat([rmsnorm(cfg, params["mtp_norm"], x[:, n_front:]),
                       emb_next], dim=-1) @ params["mtp_proj"]
        h, _, _ = block_apply(cfg, run, ATTN_DENSE, params["mtp_block"], h,
                              mode="full")
        mtp_logits = lm_logits(cfg, params["embed"], h)
        # predict t+2: logits at t score labels[t+2]
        mtp_loss = xent_loss(cfg, mtp_logits[:, :-2], labels[:, 2:])
        metrics["mtp"] = mtp_loss
        loss = loss + cfg.mtp_loss_weight * mtp_loss
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


def forward_prefill(cfg, run, params, batch, cache):
    """Full forward filling caches; returns (last-position logits, cache)."""
    enc_out = encode(cfg, run, params, batch) if cfg.is_encoder_decoder \
        else None
    x = embed_inputs(cfg, params, batch)
    x, cache, _ = run_stages(cfg, run, params, x, mode="prefill",
                             caches=cache, enc_out=enc_out)
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
    x, cache, _ = run_stages(cfg, run, params, x, mode="decode",
                             caches=cache, pos=pos)
    x = rmsnorm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params["embed"], x)[:, 0], cache


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, seq: int,
               enc_len: int = 0) -> dict:
    """Decode-cache pytree of :class:`TensorSpec` (stacked per stage)."""
    cross = cfg.is_encoder_decoder
    val: Dict[str, Any] = {}
    for si, (pattern, reps) in enumerate(cfg.stages()):
        val[f"stage_{si}"] = {
            f"pos_{j}": _tree.tree_map(
                lambda s: TensorSpec((reps,) + s.shape, s.dtype,
                                     ("layers",) + s.axes),
                block_cache_spec(cfg, bt, batch, seq, cross=cross,
                                 enc_len=enc_len))
            for j, bt in enumerate(pattern)}
    return val


def init_cache(cfg: ModelConfig, batch: int, seq: int, device="cpu", *,
               enc_len: int = 0):
    return _tree.tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
        cache_spec(cfg, batch, seq, enc_len))
