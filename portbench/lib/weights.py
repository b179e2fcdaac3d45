"""Mamba-1 weights drawn from a seed, on the device, one call per leaf.

The tree has the program's keys and stacked layout (``stage_0/pos_0``
holds every layer's leaf along a leading layer axis), so the same tensors
go to the program and to the plain reference. Matrices are drawn in the
dtype they are served in (bfloat16) and scaled in place; ``dt_bias``,
``A_log`` and ``D`` are float32, as the configuration states.

Init (the usual Mamba-1 rules): normal matrices with std 1/sqrt(fan_in)
(the input embedding 0.02, the conv 0.5/sqrt(k)), RMSNorm scales 1, the
conv bias 0, ``dt_bias`` the inverse softplus of dt ~ logU(1e-3, 1e-1),
``A_log`` = log(1..N) per channel, ``D`` = 1.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str, float, str]   # path, shape, init, std, dtype


def mamba1_leaves(cfg: dict) -> List[Leaf]:
    """(path, shape, init, std, dtype) of every leaf, in the program's
    template order. ``cfg`` is a configuration file's dict."""
    L, d, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    di, n = cfg["intermediate_size"], cfg["state_size"]
    r, k = cfg["time_step_rank"], cfg["conv_kernel"]
    wd = cfg["torch_dtype"]
    m = "stage_0/pos_0/mixer/"
    return [
        ("embed/embedding", (V, d), "normal", 0.02, wd),
        ("embed/lm_head", (d, V), "normal", d ** -0.5, wd),
        ("stage_0/pos_0/ln1/scale", (L, d), "ones", 0.0, wd),
        (m + "in_proj", (L, d, 2 * di), "normal", d ** -0.5, wd),
        (m + "conv_w", (L, k, di), "normal", 0.5 * k ** -0.5, wd),
        (m + "conv_b", (L, di), "zeros", 0.0, wd),
        (m + "x_proj", (L, di, r + 2 * n), "normal", di ** -0.5, wd),
        (m + "dt_proj", (L, r, di), "normal", r ** -0.5, wd),
        (m + "dt_bias", (L, di), "dt_bias", 0.0, "float32"),
        (m + "A_log", (L, di, n), "a_log", 0.0, "float32"),
        (m + "D", (L, di), "ones", 0.0, "float32"),
        (m + "out_proj", (L, di, d), "normal", di ** -0.5, wd),
        ("final_norm/scale", (d,), "ones", 0.0, wd),
    ]


def draw(leaves: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """{path: tensor} drawn from ``seed`` on ``device``, in leaf order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for path, shape, init, std, dt in leaves:
        dtype = getattr(torch, dt)
        if init == "normal":
            t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
            t.mul_(std)
        elif init == "ones":
            t = torch.ones(shape, device=device, dtype=dtype)
        elif init == "zeros":
            t = torch.zeros(shape, device=device, dtype=dtype)
        elif init == "dt_bias":
            u = torch.empty(shape, device=device, dtype=torch.float32)
            u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
            dtv = torch.exp(u)
            t = (dtv + torch.log(-torch.expm1(-dtv))).to(dtype)
        elif init == "a_log":
            a = torch.log(torch.arange(1, shape[-1] + 1, device=device,
                                       dtype=torch.float32))
            t = a.expand(shape).to(dtype).contiguous()
        else:
            raise ValueError(f"unknown init {init!r} for {path}")
        out[path] = t
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{"a/b": t} -> {"a": {"b": t}}, keeping the order."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse of ``nest``."""
    out = {}
    for key, v in tree.items():
        path = f"{prefix}{key}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out

