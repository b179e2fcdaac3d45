"""Config registry: ``--arch <id>`` -> ModelConfig (+ run-config defaults)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import (ModelConfig, RunConfig, ShapeProfile, SHAPES,
                                reduced, shape_applicable)

_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "llama3.2-3b": "llama3_2_3b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen1.5-32b": "qwen1_5_32b",
    "minicpm3-4b": "minicpm3_4b",
    "internvl2-1b": "internvl2_1b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def run_overrides(arch: str) -> dict:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return dict(getattr(mod, "RUN_OVERRIDES", {}))


def make_run(arch: str, shape: str, **overrides) -> RunConfig:
    cfg = get_config(arch)
    sp = SHAPES[shape]
    ok, why = shape_applicable(cfg, sp)
    if not ok:
        raise ValueError(f"{arch} x {shape}: {why}")
    kw = run_overrides(arch)
    # SSM chunking scales with sequence so the unrolled chunk loop stays
    # compact in HLO while the per-chunk working set stays VMEM/HBM-sane.
    kw.setdefault("ssm_chunk", 512 if sp.seq_len <= 4096 else 2048)
    kw.update(overrides)
    return RunConfig(model=cfg, shape=sp, **kw)


def all_cells(include_inapplicable: bool = False):
    """Every assigned (arch, shape) cell (40 total; 8 long_500k are skips)."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, sp in SHAPES.items():
            ok, why = shape_applicable(cfg, sp)
            if ok or include_inapplicable:
                out.append((arch, sname, ok, why))
    return out
