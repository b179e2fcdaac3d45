"""Adjoint Tomography — the paper's evaluation application (§4) on torch.

The port of ``repro.apps.adjoint_tomography``: a 3D acoustic wave-equation
solver (2nd-order leapfrog finite differences, one checkpointed step per
timestep) plus the four AT steps from the paper:

  1. build starting model, compute synthetic seismograms       (local)
  2. misfit between synthetics and observations                (remotable)
  3. Fréchet kernel — gradient of misfit w.r.t. the model      (remotable)
     (the adjoint-state method obtained by reverse-mode autograd through
     the wave solver)
  4. model update                                              (remotable)

Steps 2–4 carry the paper's ``remotable`` annotation. With the port's
tiers, ``local`` is the host CPU and ``cloud`` one H100, so an offloaded
step runs on the card. Mesh sizes of the paper's figures — 104x23x24
(Fig 11) and 208x44x46 (Fig 12) — are both supported. Everything is
float32, as in the reference. Models and observations are built on the
card unless the caller names another device (``device="cpu"`` in tests).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.workflow import Workflow


@dataclass(frozen=True)
class ATConfig:
    nx: int = 104
    ny: int = 23
    nz: int = 24
    nt: int = 200
    dx: float = 100.0          # m
    dt: float = 0.008          # s  (CFL: c*dt/dx <= 1/sqrt(3))
    c0: float = 3000.0         # background velocity m/s
    f0: float = 4.0            # Ricker peak frequency, Hz
    n_receivers: int = 16
    lr: float = 0.4            # model-update step (normalized gradient)

    @property
    def mesh_name(self) -> str:
        return f"{self.nx}x{self.ny}x{self.nz}"


FIG11 = ATConfig(nx=104, ny=23, nz=24)
FIG12 = ATConfig(nx=208, ny=44, nz=46)


# ---------------------------------------------------------------------------
# Wave physics
# ---------------------------------------------------------------------------

def _shift(u: torch.Tensor, axis: int, d: int) -> torch.Tensor:
    """Shift with zero boundaries (Dirichlet), no wraparound."""
    pad = [0, 0] * u.ndim               # F.pad lists the last dim first
    k = 2 * (u.ndim - 1 - axis)
    pad[k], pad[k + 1] = max(d, 0), max(-d, 0)
    return F.pad(u, pad).narrow(axis, max(-d, 0), u.shape[axis])


def _laplacian(u: torch.Tensor, dx: float) -> torch.Tensor:
    """7-point 3D Laplacian, zero (Dirichlet) boundaries.

    Scaled by multiplying with 1/dx^2, not by dividing by dx^2: a CUDA
    tensor divided by a host scalar is multiplied by its reciprocal, a
    CPU tensor truly divided, and the two differ in the last bit. With a
    product on both, every op of the step rounds alike on the host and
    the card, so a step's result does not depend on the tier it ran on."""
    lap = -6.0 * u
    for axis in range(3):
        lap = lap + _shift(u, axis, 1) + _shift(u, axis, -1)
    return lap * (1.0 / (dx * dx))


def _ricker(cfg: ATConfig, device, dtype=torch.float32) -> torch.Tensor:
    t = torch.arange(cfg.nt, device=device, dtype=dtype) * cfg.dt \
        - 1.0 / cfg.f0
    a = (math.pi * cfg.f0) ** 2 * t ** 2
    return (1 - 2 * a) * torch.exp(-a)


def _receiver_idx(cfg: ATConfig) -> Tuple[np.ndarray, int, int]:
    # float64 linspace truncated to int32: the reference's receivers at
    # every mesh it runs (the tests hold the two equal)
    xs = np.linspace(4, cfg.nx - 5, cfg.n_receivers).astype(np.int32)
    return xs, cfg.ny // 2, 2


def _leapfrog(u_prev, u, c2dt2, src_w, s_t, dx: float):
    lap = _laplacian(u, dx)
    u_next = 2 * u - u_prev + c2dt2 * lap
    # the point source, out of place: src_w is c2dt2 at the source cell
    # and 0 elsewhere, so this adds c2dt2[s] * s_t there and exactly 0
    # everywhere else
    return u_next + src_w * s_t


def simulate(c: torch.Tensor, cfg: ATConfig) -> torch.Tensor:
    """Leapfrog acoustic FD; returns seismograms (nt, n_receivers).

    Each timestep is checkpointed (its intermediates are recomputed in
    the backward pass), as the reference checkpoints its scan body. The
    wavefield takes ``c``'s dtype and device; the source wavelet is
    computed on the host and copied, so every device injects the same
    samples (``exp`` differs in the last bit between host and card)."""
    src = _ricker(cfg, "cpu", c.dtype).to(c.device)
    sx, sy, sz = cfg.nx // 2, cfg.ny // 2, 2
    rx, ry, rz = _receiver_idx(cfg)
    rx = torch.from_numpy(rx).to(device=c.device, dtype=torch.long)
    c2dt2 = (c * cfg.dt) ** 2
    onehot = torch.zeros_like(c)
    onehot[sx, sy, sz] = 1.0
    src_w = onehot * c2dt2
    u_prev = u = torch.zeros_like(c)
    recs = []
    for t in range(cfg.nt):
        # the step draws no random numbers: no RNG state to stash
        u_prev, u = u, checkpoint(_leapfrog, u_prev, u, c2dt2, src_w,
                                  src[t], cfg.dx, use_reentrant=False,
                                  preserve_rng_state=False)
        recs.append(u[rx, ry, rz])
    return torch.stack(recs)


def starting_model(cfg: ATConfig, device="cuda") -> torch.Tensor:
    return torch.full((cfg.nx, cfg.ny, cfg.nz), cfg.c0, device=device)


def true_model(cfg: ATConfig, device="cuda") -> torch.Tensor:
    """Twin-experiment target: background + two gaussian velocity anomalies."""
    x, y, z = torch.meshgrid(
        torch.arange(cfg.nx, dtype=torch.int32, device=device),
        torch.arange(cfg.ny, dtype=torch.int32, device=device),
        torch.arange(cfg.nz, dtype=torch.int32, device=device),
        indexing="ij")

    def blob(cx, cy, cz, r, amp):
        d2 = ((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) / r ** 2
        return amp * torch.exp(-d2)

    c = starting_model(cfg, device)
    c = c + blob(cfg.nx * 0.35, cfg.ny * 0.5, cfg.nz * 0.5, cfg.nx * 0.08, 250.0)
    c = c - blob(cfg.nx * 0.7, cfg.ny * 0.4, cfg.nz * 0.6, cfg.nx * 0.06, 200.0)
    return c


# ---------------------------------------------------------------------------
# The four AT steps (paper §4), as workflow step functions.
# ---------------------------------------------------------------------------

def step_forward(cfg: ATConfig):
    def fn(model):
        return {"syn": simulate(model, cfg)}
    return fn


def step_misfit(cfg: ATConfig):
    def fn(syn, obs):
        r = syn - obs
        return {"chi": 0.5 * torch.sum(r * r)}
    return fn


def step_kernel(cfg: ATConfig):
    def fn(model, obs):
        # differentiate a fresh leaf, never the stored value: MDSS hashes
        # and publishes the tensors it holds
        with torch.enable_grad():
            m = model.detach().clone().requires_grad_(True)
            r = simulate(m, cfg) - obs
            (grad,) = torch.autograd.grad(0.5 * torch.sum(r * r), m)
        return {"grad": grad.detach()}
    return fn


def step_update(cfg: ATConfig):
    def fn(model, grad):
        g = grad / (torch.max(torch.abs(grad)) + 1e-20)
        return {"model": model - cfg.lr * g * 20.0}
    return fn


def _sim_flops(cfg: ATConfig) -> float:
    return float(cfg.nx * cfg.ny * cfg.nz) * cfg.nt * 15.0


def build_workflow(cfg: ATConfig, *, remotable=(2, 3, 4)) -> Workflow:
    """One AT iteration as an Emerald workflow (paper: steps 2–4 remotable)."""
    wf = Workflow(f"AT-{cfg.mesh_name}")
    wf.var("model").var("obs")
    n = cfg.nx * cfg.ny * cfg.nz
    wf.step("forward", step_forward(cfg), inputs=("model",), outputs=("syn",),
            remotable=1 in remotable, flops_hint=_sim_flops(cfg),
            bytes_hint=8.0 * n, device_step=True)
    wf.step("misfit", step_misfit(cfg), inputs=("syn", "obs"),
            outputs=("chi",), remotable=2 in remotable,
            flops_hint=3.0 * cfg.nt * cfg.n_receivers, bytes_hint=8.0,
            device_step=True)
    wf.step("kernel", step_kernel(cfg), inputs=("model", "obs"),
            outputs=("grad",), remotable=3 in remotable,
            flops_hint=3.0 * _sim_flops(cfg), bytes_hint=8.0 * n,
            device_step=True)
    wf.step("update", step_update(cfg), inputs=("model", "grad"),
            outputs=("model",), remotable=4 in remotable,
            flops_hint=4.0 * n, bytes_hint=8.0 * n, device_step=True)
    return wf


def make_observations(cfg: ATConfig, device="cuda") -> torch.Tensor:
    return simulate(true_model(cfg, device), cfg)
