"""Deterministic synthetic LM data (``repro.data.pipeline``): batches,
their logical axes and their meta-device specs.

One global batch per (seed, step), drawn with numpy exactly as the
reference draws it, so the two packages see the same bits:
  * ``tokens``/``labels`` (B, S) int32, bit-identical to the reference's,
  * modality-stub tensors for vlm/audio archs (``frontend_embeds`` /
    ``encoder_embeds``), the same float32 draws cast to ``cfg.dtype``.

Batches are CPU tensors: the data step runs on the local tier, and MDSS
ships each batch to the tier that trains. The source is a stateless
``step -> batch`` map, so a resumed run sees the batches it would have
seen (no iterator state to checkpoint).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeProfile
from repro_torch.models.params import torch_dtype


def token_batch_shapes(cfg: ModelConfig, shape: ShapeProfile) -> Dict[str, tuple]:
    """Shapes of one global training batch for this (arch, shape)."""
    B, S = shape.global_batch, shape.seq_len
    out = {}
    if cfg.is_encoder_decoder:
        out["encoder_embeds"] = (B, S, cfg.d_model)
        out["tokens"] = (B, S)
        out["labels"] = (B, S)
    elif cfg.frontend:
        F = cfg.frontend_tokens
        out["frontend_embeds"] = (B, F, cfg.d_model)
        out["tokens"] = (B, S - F)
        out["labels"] = (B, S - F)
    else:
        out["tokens"] = (B, S)
        out["labels"] = (B, S)
    return out


def batch_logical_axes(cfg: ModelConfig, shape: ShapeProfile):
    shapes = token_batch_shapes(cfg, shape)
    axes = {}
    for k, shp in shapes.items():
        axes[k] = ("act_batch",) + (None,) * (len(shp) - 1)
    return axes


def make_batch_specs(cfg: ModelConfig, shape: ShapeProfile):
    """The batch's shapes and dtypes, as tensors on the meta device."""
    return {k: torch.empty(shp, device="meta", dtype=torch_dtype(cfg.dtype)
                           if "embeds" in k else torch.int32)
            for k, shp in token_batch_shapes(cfg, shape).items()}


@dataclass
class SyntheticLMData:
    """Stateless deterministic batch source (markov-ish token stream)."""

    cfg: ModelConfig
    shape: ShapeProfile
    seed: int = 0

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        shapes = token_batch_shapes(self.cfg, self.shape)
        rng = np.random.default_rng((self.seed, step))
        out = {}
        for k, shp in shapes.items():
            if "embeds" in k:
                out[k] = torch.from_numpy(
                    rng.standard_normal(shp, dtype=np.float32) * 0.02
                ).to(torch_dtype(self.cfg.dtype))
            elif k == "tokens":
                # low-entropy stream so tiny models show loss decrease
                base = rng.integers(0, self.cfg.vocab_size, shp[0])[:, None]
                drift = rng.integers(0, 7, shp)
                out[k] = torch.from_numpy(
                    ((base + np.cumsum(drift, -1)) % self.cfg.vocab_size
                     ).astype(np.int32))
        if "labels" in shapes:
            out["labels"] = out["tokens"]
        return out
