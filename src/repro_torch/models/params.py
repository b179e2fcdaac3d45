"""Parameter templates: single source of truth for shapes and init.

A model declares its parameters once as a pytree of :class:`ParamSpec`
(the same templates, keys and shapes as ``repro.models.params``). From the
template come real tensors (``init_params``), and ``from_reference`` turns
the reference's params, as numpy arrays, into the port's, key for key.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch import _tree


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]     # logical dim names, len == ndim
    init: str = "normal"                # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 1.0                  # stddev multiplier for "normal"
    fan_in_axis: Optional[int] = None   # axis whose size sets 1/sqrt(fan_in)
    dtype: Optional[str] = None         # override param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ("bfloat16", "float32", ...) -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def init_params(template, generator: torch.Generator, param_dtype: str,
                device=None):
    """Random params with the reference's init rules, drawn from
    ``generator`` on its device and placed on ``device`` (default: the
    generator's). torch's generator does not reproduce ``jax.random``:
    to compare with the reference, convert its params (``from_reference``)."""
    gdev = generator.device
    device = gdev if device is None else torch.device(device)

    def mk(s: ParamSpec):
        dt = torch_dtype(s.dtype or param_dtype)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        if s.init == "ssm_a":
            # mamba1 A_log init: log(1..N) broadcast over channels
            n = s.shape[-1]
            a = torch.log(torch.arange(1, n + 1, dtype=torch.float32))
            return a.expand(s.shape).to(device, dt).contiguous()
        if s.init == "ssm_dt":
            # dt bias ~ softplus^-1(uniform(1e-3, 1e-1))
            u = torch.empty(s.shape, dtype=torch.float32, device=gdev)
            u.uniform_(math.log(1e-3), math.log(1e-1), generator=generator)
            dtv = torch.exp(u)
            return (dtv + torch.log(-torch.expm1(-dtv))).to(device, dt)
        if s.init == "normal":
            fan_in = s.shape[s.fan_in_axis] if s.fan_in_axis is not None \
                else None
            std = s.scale * (1.0 / math.sqrt(fan_in) if fan_in else 0.02)
            v = torch.randn(s.shape, generator=generator, device=gdev,
                            dtype=torch.float32)
            return (v * std).to(device, dt)
        raise ValueError(f"unknown init {s.init}")

    return _tree.tree_map(mk, template)


def from_reference(np_tree, dtype: Optional[torch.dtype] = None,
                   device="cpu"):
    """The reference's params (a pytree of numpy arrays, bfloat16
    included) -> the port's tensors, key for key; ``dtype`` casts every
    leaf (default: keep each leaf's dtype)."""
    def conv(a):
        t = _tree.from_numpy(a)
        return t.to(device=device, dtype=dtype or t.dtype)
    return _tree.tree_map(conv, np_tree)


def stack_specs(spec_tree, n: int, axis_name: str = "layers"):
    """Prepend a stacked (layer) leading dim to every spec in a tree."""
    def st(s: ParamSpec):
        fan = None if s.fan_in_axis is None else s.fan_in_axis + 1
        return ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.init, s.scale,
                         fan, s.dtype)
    return _tree.tree_map(st, spec_tree)
