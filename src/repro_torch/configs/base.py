"""Config system for Emerald on PyTorch (a copy of ``repro.configs.base``).

Two layers of config:
  * ``ModelConfig``  — architecture hyperparameters (one per assigned arch).
  * ``ShapeProfile`` — (seq_len, global_batch, kind) input-shape cells.
  * ``RunConfig``    — model + shape + parallelism/optimizer/runtime knobs.

Everything is a frozen dataclass so configs hash and can key compile caches.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Block types for the layer-pattern system (see models/transformer.py).
# ---------------------------------------------------------------------------
ATTN_DENSE = "attn_dense"      # attention + dense MLP
ATTN_MOE = "attn_moe"          # attention + MoE
MAMBA_DENSE = "mamba_dense"    # mamba mixer + dense MLP
MAMBA_MOE = "mamba_moe"        # mamba mixer + MoE
MAMBA_ONLY = "mamba_only"      # pure mamba block (no MLP; mamba1 archs)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters. Field defaults are no-ops."""

    name: str
    family: str                      # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: int = 0              # 0 -> = n_heads
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention flavour ---------------------------------------------------
    attn_type: str = "gqa"           # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    # --- MLA (minicpm3 / deepseek-v3) ---------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1        # MoE applied when layer % period == offset
    moe_layer_offset: int = 0
    first_dense_layers: int = 0      # leading layers forced dense (deepseek: 3)
    router_aux_weight: float = 0.001

    # --- SSM / Mamba-1 --------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0                 # 0 -> ceil(d_model / 16)

    # --- hybrid (jamba) -------------------------------------------------------
    attn_layer_period: int = 0       # attention when layer % period == offset
    attn_layer_offset: int = 0

    # --- encoder-decoder (seamless) ------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # --- modality frontends (STUBS per assignment spec) ----------------------
    frontend: str = ""               # "" | vit_stub | speech_stub
    frontend_tokens: int = 0         # prefix positions supplied as embeddings

    # --- misc ----------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mtp: bool = False                # deepseek multi-token prediction
    mtp_loss_weight: float = 0.3
    dtype: str = "bfloat16"          # activation dtype
    param_dtype: str = "bfloat16"
    # sharding-driven padding (16 = production model-axis; 1 = smoke configs).
    pad_multiple: int = 1

    # ------------------------------------------------------------------ derived
    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hdim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def attn_free(self) -> bool:
        return self.attn_type == "none"

    # --- sharding-driven padding (see DESIGN.md §5) ---------------------------
    @property
    def vocab_padded(self) -> int:
        return pad_to_multiple(self.vocab_size, self.pad_multiple)

    @property
    def heads_padded(self) -> int:
        """Q-heads zero-padded so the head dim shards over the model axis."""
        return pad_to_multiple(self.n_heads, self.pad_multiple)

    @property
    def kv_heads_padded(self) -> int:
        """Smallest kv-head count >= kv_heads that divides heads_padded."""
        hp = self.heads_padded
        for kv in range(self.kv_heads, hp + 1):
            if hp % kv == 0:
                return kv
        return hp

    @property
    def q_group(self) -> int:
        return self.heads_padded // self.kv_heads_padded

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid archs only."""
        return self.family in ("ssm", "hybrid")

    # --- layer-pattern construction ------------------------------------------
    def block_type(self, i: int) -> str:
        """Block type of decoder layer ``i``."""
        if self.family == "ssm":
            return MAMBA_ONLY
        is_moe = (
            self.n_experts > 0
            and i >= self.first_dense_layers
            and i % self.moe_layer_period == self.moe_layer_offset
        )
        is_attn = True
        if self.attn_layer_period:  # hybrid: attention only on some layers
            is_attn = i % self.attn_layer_period == self.attn_layer_offset
        if is_attn:
            return ATTN_MOE if is_moe else ATTN_DENSE
        return MAMBA_MOE if is_moe else MAMBA_DENSE

    def stages(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """Compress the per-layer block types into (pattern, repeats) stages.

        A stage repeats a short pattern; stacking params along a leading
        ``repeats`` axis lets us ``lax.scan`` over it with compact HLO.
        """
        types = [self.block_type(i) for i in range(self.n_layers)]
        # greedy: longest truly-repeating (period, repeats>=2) run; isolated
        # layers become (pattern=1, repeats=1) stages (counted unrolled).
        out = []
        i = 0
        while i < len(types):
            best = (1, 1)  # (period, repeats)
            for p in range(1, min(16, (len(types) - i) // 2) + 1):
                reps = 1
                while (
                    i + (reps + 1) * p <= len(types)
                    and types[i + reps * p : i + (reps + 1) * p] == types[i : i + p]
                ):
                    reps += 1
                if reps >= 2 and (reps * p > best[0] * best[1] or (
                        reps * p == best[0] * best[1] and p < best[0])):
                    best = (p, reps)
            p, reps = best
            out.append((tuple(types[i : i + p]), reps))
            i += p * reps
        # merge adjacent single-rep stages of identical 1-patterns
        merged = []
        for pat, reps in out:
            if merged and merged[-1][0] == pat:
                merged[-1] = (pat, merged[-1][1] + reps)
            else:
                merged.append((pat, reps))
        return tuple(merged)


# ---------------------------------------------------------------------------
# Input-shape cells (assigned shapes; identical for every LM arch).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeProfile:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeProfile("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeProfile("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeProfile("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeProfile("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeProfile) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell is runnable; reason if not.

    long_500k needs sub-quadratic attention -> SSM/hybrid only (see DESIGN.md).
    """
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k requires sub-quadratic attention (SSM/hybrid only)"
    return True, ""


# ---------------------------------------------------------------------------
# Run config: model x shape x parallelism/runtime knobs.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeProfile
    # parallelism
    sharding_preset: str = "fsdp"      # dp_tp | fsdp | + per-run overrides
    rule_overrides: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()
    remat: str = "full"                # none | full | dots_saveable
    scan_unroll: int = 1               # layer-scan unroll (all stages)
    # dry-run cost extrapolation: unroll ONE stage by `unroll_factor` so the
    # per-layer cost slope of that stage can be measured (see launch/dryrun).
    unroll_stage: str = ""
    unroll_factor: int = 2
    ssm_chunk: int = 512               # mamba within-chunk size
    ssm_scan_dtype: str = "float32"    # scan-pair materialization dtype
    moe_impl: str = "sort"             # sort | manual_ep | gshard
    # optimizer
    optimizer: str = "adamw"           # adamw | adafactor
    opt_state_dtype: str = "float32"   # float32 | bfloat16
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_accum: int = 1
    grad_compression: str = "none"     # none | bf16 | int8  (cross-pod axis)
    # serving
    max_decode_len: int = 0            # 0 -> shape.seq_len

    def with_(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def pad_to_multiple(x: int, m: int) -> int:
    return -(-x // m) * m


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.n_experts:
        kw.update(n_experts=min(cfg.n_experts, 8), moe_d_ff=64)
    if cfg.q_lora_rank:
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16)
    if cfg.ssm_state:
        kw.update(ssm_state=8, dt_rank=8)
    if cfg.is_encoder_decoder:
        kw.update(n_encoder_layers=2)
    if cfg.frontend:
        kw.update(frontend_tokens=8)
    if cfg.first_dense_layers:
        kw.update(first_dense_layers=1)
    if cfg.attn_layer_period:
        kw.update(n_layers=8)
    kw.update(param_dtype="float32", dtype="float32")
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
