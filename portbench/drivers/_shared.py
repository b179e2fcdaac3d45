"""What the drivers share on the program's side: its model configuration
built from a configuration file, its spans on the harness's clock, and
tensor trees moved between host and card."""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import torch

WALL_MINUS_PERF = time.time() - time.perf_counter()


def model_config(cfg: dict):
    """The program's ModelConfig of ``cfg["program_arch"]`` with the
    configuration file's sizes (the published ones, the depth cut where
    the file says so)."""
    from repro_torch.configs import get_config
    di, d = cfg["intermediate_size"], cfg["hidden_size"]
    if di % d:
        raise ValueError(f"d_inner {di} is not a multiple of d_model {d}")
    mc = dataclasses.replace(
        get_config(cfg["program_arch"]), n_layers=cfg["num_hidden_layers"],
        d_model=d, ssm_expand=di // d, ssm_state=cfg["state_size"],
        ssm_conv=cfg["conv_kernel"], dt_rank=cfg["time_step_rank"],
        vocab_size=cfg["vocab_size"], dtype=cfg["torch_dtype"],
        param_dtype=cfg["torch_dtype"], norm_eps=cfg["layer_norm_epsilon"],
        tie_embeddings=cfg["tie_word_embeddings"])
    if mc.vocab_padded != cfg["vocab_size"]:
        raise ValueError("the program would pad the vocabulary")
    return mc


def spans_of(tracer) -> List[tuple]:
    """(label, t0, t1, attrs) of a program tracer's spans, perf seconds."""
    out = []
    for s in tracer.spans():
        t0 = s.t0_wall - WALL_MINUS_PERF
        step = s.attrs.get("step")
        out.append((f"{s.name}:{step}" if step else s.name, t0,
                    t0 + s.dur_s, dict(s.attrs, name=s.name, trace=s.trace_id)))
    return out


def free_device():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def leaf_norms(flat: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) * scale
            for k, v in flat.items()}
