"""Roofline terms and analytic MODEL_FLOPS per (arch x shape) cell, as
``repro.launch.roofline``, with the H100's constants.

Terms, per device (the dry run's counts are per device, so each term is
that count over one card's peak):

    compute    = flops            / PEAK_FLOPS
    memory     = bytes            / HBM_BW
    collective = collective_bytes / LINK_BW

The constants are NVIDIA's datasheet figures for the H100 SXM5 80 GB, not
measurements, and the terms are arithmetic on them:
  * ``PEAK_FLOPS`` 989e12: dense bf16 tensor-core FLOP/s (the sparse
    figure is twice that; H100 datasheet, SXM5 column).
  * ``HBM_BW`` 3.35e12: HBM3 bytes/s (same datasheet).
  * ``NVLINK_BW`` 450e9: bytes/s each way between two cards of one
    8-card node (900 GB/s bidirectional NVLink 4, same datasheet).
  * ``LINK_BW`` 50e9: bytes/s each way across nodes, one 400 Gb/s
    InfiniBand NDR NIC per card (a DGX H100 node has eight). This is the
    rate ``collective_s`` uses, as the reference's single ``LINK_BW``:
    a production mesh of 256 or 512 cards spans 32 or 64 nodes.

MODEL_FLOPS is the useful global compute, 6*N_active*D (train) or
2*N_active*D (inference) plus exact attention terms, from the unpadded
config: the reference's functions, copied (they use no JAX).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.configs.base import (ATTN_DENSE, ATTN_MOE, ModelConfig,
                                      ShapeProfile)

PEAK_FLOPS = 989e12      # bf16 dense FLOP/s per card (datasheet)
HBM_BW = 3.35e12         # bytes/s per card (datasheet)
NVLINK_BW = 450e9        # bytes/s each way within an 8-card node
LINK_BW = 50e9           # bytes/s each way across nodes, per card
NODE_SIZE = 8            # cards per NVLink node


# ---------------------------------------------------------------------------
# Analytic parameter / FLOP accounting (unpadded).
# ---------------------------------------------------------------------------

def matmul_param_counts(cfg: ModelConfig) -> Tuple[float, float]:
    """(total, active-per-token) matmul params, unpadded, incl. lm_head."""
    from repro_torch.models.params import ParamSpec
    from repro_torch.models.transformer import model_template

    true_cfg = dataclasses.replace(cfg, pad_multiple=1)
    template = model_template(true_cfg)
    total = active = 0.0

    def walk(node, in_moe_routed):
        nonlocal total, active
        if isinstance(node, ParamSpec):
            if len(node.shape) < 2:
                return
            n = 1.0
            for d in node.shape:
                n *= d
            if "vocab" in (node.axes or ()) and node.axes[0] == "vocab":
                return  # embedding gather, not a matmul
            total += n
            if in_moe_routed and "experts" in (node.axes or ()):
                active += n * cfg.experts_per_token / max(cfg.n_experts, 1)
            else:
                active += n
            return
        for k, v in node.items():
            walk(v, in_moe_routed or k == "moe")

    walk(template, False)
    return total, active


def attention_flops(cfg: ModelConfig, B: int, S: int, kind: str) -> float:
    """Exact score/value matmul FLOPs (global), causal-halved."""
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.block_type(i) in (ATTN_DENSE, ATTN_MOE))
    if cfg.is_encoder_decoder:
        n_attn = cfg.n_layers  # decoder self-attn
    if cfg.attn_type == "mla":
        dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        dv = cfg.v_head_dim
    else:
        dqk = dv = cfg.hdim
    H = cfg.n_heads
    if kind == "train":
        per_layer = 3 * 2 * B * (S * S / 2) * H * (dqk + dv)
    elif kind == "prefill":
        per_layer = 2 * B * (S * S / 2) * H * (dqk + dv)
    else:  # decode: one query against S cached keys
        per_layer = 2 * B * S * H * (dqk + dv)
    fl = n_attn * per_layer
    if cfg.is_encoder_decoder:
        # encoder self-attn (full, not causal) + decoder cross-attn
        enc = cfg.n_encoder_layers * 2 * B * S * S * H * 2 * cfg.hdim
        if kind == "train":
            fl += 3 * enc + 3 * cfg.n_layers * 2 * B * S * S * H * 2 * cfg.hdim / 2
        elif kind == "prefill":
            fl += enc + cfg.n_layers * 2 * B * S * S * H * 2 * cfg.hdim / 2
        else:
            fl += cfg.n_layers * 2 * B * S * H * 2 * cfg.hdim  # cross decode
    return fl


def model_flops(cfg: ModelConfig, shape: ShapeProfile) -> float:
    """Useful global FLOPs for one step of this cell (6ND / 2ND convention)."""
    B, S = shape.global_batch, shape.seq_len
    _, n_active = matmul_param_counts(cfg)
    if shape.kind == "train":
        tokens = B * S
        return 6.0 * n_active * tokens + attention_flops(cfg, B, S, "train")
    if shape.kind == "prefill":
        tokens = B * S
        return 2.0 * n_active * tokens + attention_flops(cfg, B, S, "prefill")
    return 2.0 * n_active * B + attention_flops(cfg, B, S, "decode")


# ---------------------------------------------------------------------------
# Term computation from dry-run counts.
# ---------------------------------------------------------------------------

def roofline_terms(per_dev_flops: float, per_dev_bytes: float,
                   per_dev_coll_bytes: float) -> Dict[str, float]:
    compute = per_dev_flops / PEAK_FLOPS
    memory = per_dev_bytes / HBM_BW
    collective = per_dev_coll_bytes / LINK_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms
