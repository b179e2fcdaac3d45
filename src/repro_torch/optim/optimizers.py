"""Optimizers from scratch: AdamW and Adafactor (``repro.optim.optimizers``).

Both operate on pytrees of tensors; the optimizer state mirrors the param
tree. ``state_dtype="bfloat16"`` halves the state's bytes. Adafactor keeps
factored second moments (row/col) for matrices: O(n+m) state instead of
O(nm).

Updates are functional: they return new tensors and never write the ones
handed in. The params and state are MDSS values, which are immutable, and
the previous version may still be referenced (a checkpoint, a replica on
the other tier). The math is the reference's, in float32: bias corrections
from the step counter (a 0-d int32 tensor), decoupled weight decay on
leaves of two or more dims only.

The state of DTensor params is made shard by shard, laid out as its
params (the step counter replicated on their mesh): no process holds the
whole state at any point.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import _tree
from repro_torch.parallel.sharding import is_axes, is_dtensor


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in _tree.tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, g=None):
    """``grads`` scaled to global norm at most ``max_norm``, and the norm
    (``g``, when given, is taken as the norm: that of a tree whose leaves
    are split over processes)."""
    g = global_norm(grads) if g is None else g
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    # the product in float32, as the reference promotes a bf16 leaf times
    # a float32 scalar
    return _tree.tree_map(lambda x: (x.float() * scale).to(x.dtype),
                          grads), g


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _zeros(p, dt, drop=None):
    """Zeros of ``dt`` shaped as ``p``, without its dim ``drop`` when one
    is given. For a DTensor ``p``, only this process's shard, laid out as
    ``p`` (a split of the dropped dim becomes whole)."""
    keep = [d for d in range(p.dim()) if drop is None or d != drop % p.dim()]
    if not is_dtensor(p):
        return torch.zeros([p.shape[d] for d in keep], dtype=dt,
                           device=p.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    def moved(q):
        if drop is None or not q.is_shard():
            return q
        d = q.dim % p.dim()
        if d not in keep:
            return Replicate()
        if isinstance(q, _StridedShard):
            return _StridedShard(keep.index(d), split_factor=q.split_factor)
        return Shard(keep.index(d))
    local = p.to_local()
    pl = [moved(q) for q in p.placements]
    shape = [p.shape[d] for d in keep]
    return DTensor.from_local(
        torch.zeros([local.shape[d] for d in keep], dtype=dt,
                    device=local.device), p.device_mesh, pl,
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def adamw_init(params, state_dtype: str = "float32"):
    dt = getattr(torch, state_dtype)
    zeros = lambda p: _zeros(p, dt)
    return {"mu": _tree.tree_map(zeros, params),
            "nu": _tree.tree_map(zeros, params),
            "step": _step0(params)}


def _step0(params):
    """The 0-d int32 step counter, on the params' device (replicated on
    the mesh of DTensor params)."""
    p = _tree.tree_leaves(params)[0]
    if not is_dtensor(p):
        return torch.zeros((), dtype=torch.int32, device=p.device)
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(
        torch.zeros((), dtype=torch.int32, device=p.to_local().device),
        p.device_mesh, [Replicate()] * p.device_mesh.ndim, run_check=False)


def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    step = state["step"] + 1
    sf = step.float()
    c1 = 1.0 - b1 ** sf
    c2 = 1.0 - b2 ** sf

    def upd(p, g, mu, nu):
        g32 = g.float()
        mu32 = b1 * mu.float() + (1 - b1) * g32
        nu32 = b2 * nu.float() + (1 - b2) * g32 * g32
        update = (mu32 / c1) / (torch.sqrt(nu32 / c2) + eps)
        # decoupled weight decay on >=2-D weights only
        if p.dim() >= 2:
            update = update + weight_decay * p.float()
        newp = (p.float() - lr * update).to(p.dtype)
        return newp, mu32.to(mu.dtype), nu32.to(nu.dtype)

    out = [upd(*t) for t in zip(*(_tree.leaves_up_to(params, tr) for tr in (
        params, grads, state["mu"], state["nu"])))]
    new = [_tree.unflatten_like(params, [o[i] for o in out])
           for i in range(3)]
    return new[0], {"mu": new[1], "nu": new[2], "step": step}


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; state ~ params/edge-dims)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    # ndim-only, as the reference's (its state axes see axes, not sizes)
    return len(shape) >= 2


def adafactor_init(params, state_dtype: str = "float32"):
    dt = getattr(torch, state_dtype)

    def init(p):
        if _factored(p.shape):
            return {"vr": _zeros(p, dt, -1), "vc": _zeros(p, dt, -2)}
        return {"v": _zeros(p, dt)}

    return {"v": _tree.tree_map(init, params), "step": _step0(params)}


def adafactor_update(params, grads, state, *, lr, decay=0.8, eps=1e-30,
                     clip_threshold=1.0, weight_decay=0.0):
    step = state["step"] + 1
    sf = step.float()
    beta = 1.0 - sf ** (-decay)

    def upd(p, g, v):
        g32 = g.float()
        g2 = g32 * g32 + eps
        if _factored(p.shape):
            vr = beta * v["vr"].float() + (1 - beta) * torch.mean(g2, -1)
            vc = beta * v["vc"].float() + (1 - beta) * torch.mean(g2, -2)
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :]
                / torch.clamp(torch.mean(vr, -1, keepdim=True),
                              min=eps)[..., None])
            nv = {"vr": vr.to(v["vr"].dtype), "vc": vc.to(v["vc"].dtype)}
        else:
            vf = beta * v["v"].float() + (1 - beta) * g2
            denom = torch.sqrt(vf)
            nv = {"v": vf.to(v["v"].dtype)}
        u = g32 / torch.clamp(denom, min=eps)
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        if p.dim() >= 2 and weight_decay:
            u = u + weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), nv

    # the state's per-leaf dicts are matched up to the param tree's leaves
    out = [upd(*t) for t in zip(*(_tree.leaves_up_to(params, tr) for tr in (
        params, grads, state["v"])))]
    return (_tree.unflatten_like(params, [o[0] for o in out]),
            {"v": _tree.unflatten_like(params, [o[1] for o in out]),
             "step": step})


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

def make_optimizer(name: str, *, state_dtype="float32", weight_decay=0.1):
    if name == "adamw":
        init = functools.partial(adamw_init, state_dtype=state_dtype)
        update = functools.partial(adamw_update, weight_decay=weight_decay)
    elif name == "adafactor":
        init = functools.partial(adafactor_init, state_dtype=state_dtype)
        update = functools.partial(adafactor_update, weight_decay=weight_decay)
    else:
        raise ValueError(name)
    return init, update


def opt_state_axes(opt_name: str, param_axes):
    """Logical axes for the optimizer state tree (mirrors params)."""
    if opt_name == "adamw":
        return {"mu": param_axes, "nu": param_axes, "step": ()}

    # adafactor: factored leaves drop the last / second-to-last axis
    def fac(ax):
        if len(ax) >= 2:
            return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
        return {"v": ax}
    return {"v": _tree.tree_map(fac, param_axes, is_leaf=is_axes),
            "step": ()}
