"""Mamba-1 mixer block (falcon-mamba), as ``repro.models.mamba``.

The full-sequence path runs the selective scan op (the Hopper kernel on
the card, the closed-form plain path on the CPU). Decode keeps O(1)
state: the SSM state (B, d_inner, N) f32 and the conv window
(B, k-1, d_inner), stepped in plain torch (the reference leaves it to
XLA as well).

Caches are MDSS values, which are immutable (see ``models/attention``):
every cache leaf returned is a new tensor, and the cache handed in is
never written.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models.attention import TensorSpec
from repro_torch.models.params import ParamSpec, torch_dtype


def mamba_template(cfg: ModelConfig) -> dict:
    d, di, n, r, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.dt_rank_, cfg.ssm_conv)
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "ssm_inner"), fan_in_axis=0),
        "conv_w": ParamSpec((k, di), ("conv_k", "ssm_inner"), scale=0.5,
                            fan_in_axis=0),
        "conv_b": ParamSpec((di,), ("ssm_inner",), init="zeros"),
        "x_proj": ParamSpec((di, r + 2 * n), ("ssm_inner", None), fan_in_axis=0),
        "dt_proj": ParamSpec((r, di), ("dt_rank", "ssm_inner"), fan_in_axis=0),
        "dt_bias": ParamSpec((di,), ("ssm_inner",), init="ssm_dt",
                             dtype="float32"),
        "A_log": ParamSpec((di, n), ("ssm_inner", "ssm_state"), init="ssm_a",
                           dtype="float32"),
        "D": ParamSpec((di,), ("ssm_inner",), init="ones", dtype="float32"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed"), fan_in_axis=0),
    }


def _dt_bc(cfg: ModelConfig, p, x):
    """x: (...,di) -> dt(...,di) f32, B(...,N), C(...,N); B and C are
    slices of the x_proj output, not copies."""
    r, n = cfg.dt_rank_, cfg.ssm_state
    proj = x @ p["x_proj"]
    dt_r, Bm, Cm = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    # the dt product stays in f32, as the reference's
    dt = F.softplus(dt_r.float() @ p["dt_proj"].float() + p["dt_bias"])
    return dt, Bm, Cm


def _causal_conv(cfg: ModelConfig, p, x):
    """Depthwise causal conv over seq, as the reference's sum of k shifted
    products (no cuDNN convolution, which runs f32 in TF32). x: (B,S,di)."""
    k, S = cfg.ssm_conv, x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + S, :] * p["conv_w"][i] for i in range(k))
    return out + p["conv_b"]


def mamba_full(cfg: ModelConfig, p, x, *, cache: Optional[dict] = None,
               chunk: int = 512, scan_dtype: str = "float32"):
    """Prefill (or a full forward). If ``cache`` is given, a new cache
    holding the final state and conv window is returned."""
    B, S, _ = x.shape
    di = cfg.d_inner
    xz = x @ p["in_proj"]
    xs, z = xz[..., :di], xz[..., di:]
    xc = F.silu(_causal_conv(cfg, p, xs))
    dt, Bm, Cm = _dt_bc(cfg, p, xc)
    A = -torch.exp(p["A_log"])
    h0 = torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                     device=x.device) if cache is None else cache["h"]
    y, h_last = scan_ops.selective_scan(xc, dt, A, Bm, Cm, p["D"], h0,
                                        chunk=min(chunk, S),
                                        scan_dtype=scan_dtype)
    y = y * F.silu(z)
    out = y @ p["out_proj"]
    if cache is not None:
        k = cfg.ssm_conv
        conv_tail = F.pad(xs, (0, 0, k - 1, 0))[:, S:S + k - 1]
        cache = dict(cache, h=h_last,
                     conv=conv_tail.to(cache["conv"].dtype, copy=True),
                     pos=torch.full_like(cache["pos"], S))
    return out, cache


def mamba_decode(cfg: ModelConfig, p, x, cache):
    """x: (B,1,D); cache: {h:(B,di,N) f32, conv:(B,k-1,di), pos}."""
    di = cfg.d_inner
    xz = x[:, 0] @ p["in_proj"]
    xs, z = xz[..., :di], xz[..., di:]
    window = torch.cat([cache["conv"].to(xs.dtype), xs[:, None]], 1)
    xc = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc)
    dt, Bm, Cm = _dt_bc(cfg, p, xc)
    A = -torch.exp(p["A_log"])
    y, h = scan_ops.selective_step(xc, dt, A, Bm, Cm, p["D"], cache["h"])
    y = y * F.silu(z)
    out = (y @ p["out_proj"])[:, None]
    cache = dict(cache, h=h,
                 conv=window[:, 1:].to(cache["conv"].dtype, copy=True),
                 pos=cache["pos"] + 1)
    return out, cache


def mamba_cache_spec(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """SSM state and conv-window cache entry to allocate, with its logical
    axes."""
    di, n, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "h": TensorSpec((batch, di, n), torch.float32,
                        ("act_batch", "act_ssm_inner", None)),
        "conv": TensorSpec((batch, k - 1, di), torch_dtype(cfg.dtype),
                           ("act_batch", None, "act_ssm_inner")),
        "pos": TensorSpec((), torch.int32),
    }
