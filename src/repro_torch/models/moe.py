"""Mixture-of-Experts, as ``repro.models.moe``: two dispatches.

``moe`` (default) — grouped sort-based dispatch: tokens are reshaped into
G groups; within each group the top-k assignments are sorted by expert,
capacity-bounded positions come from a running count, and the expert
input buffers (G, E, C, D) are built by gather. The reference ``vmap``s
one group's dispatch; here the group is a leading batch dim of every op.

``moe_gshard`` — the GShard/Switch dense one-hot einsum dispatch, the
reference implementation both packages' tests hold the sort dispatch to.

``moe_manual_ep`` — the sort dispatch with an explicit expert
all-to-all over the ``(data, model)`` processes of the mesh in use: each
sends its groups' per-expert slices to the experts' owners, computes its
E/n resident experts, and sends the results back.

On a mesh, the processes of ``(data, model)`` hold one batch between
them, each its own rows in order (``parallel.sharding``). The groups, the
capacity and the load-balance loss are those of that whole batch, as the
reference's under auto-SPMD: each process holds its G/n of the global
groups, and the router statistics are summed over the processes before
the loss. Where the G groups do not split n ways, every process runs the
whole batch (gathered) and keeps its own rows.

The expert products are batched matrix products (``torch.einsum``), as the
reference leaves them to XLA. Ties in the router's top-k go to the lower
expert index, as ``jax.lax.top_k`` breaks them (a stable descending
sort), and the capacity drops follow the reference's stable sort.

On DTensors (tensor parallelism and FSDP storage) every dispatch runs
as the reference's does under GSPMD: groups split over the batch axes,
experts over ``model``, at the reference's constraint sites. The
routing, sort, cumsum and scatters of a group (or the one-hot dispatch
and combine einsums of ``moe_gshard``) and the combine's gather have no
DTensor rule; they are independent per group, so each process runs them
on its own groups (``local_map``, ``_moe_sharded``), the router gathered
whole and the expert outputs gathered over ``model``. ``moe_manual_ep``
on DTensors (``_manual_ep_sharded``) is one ``local_map`` over groups
split over every mesh dim: as the reference's ``in_specs`` ``P(("data",
"model"))``, each process holds the E/n_ep experts of its ``(data,
model)`` index, its local shard of each expert weight (placed by
``redistribute``: under FSDP the data-split embed dim is gathered and the
expert dim split over both axes), and exchanges the expert buffers by
``all_to_all`` with the other processes of its pod.

Determinism on the card: the only scatter with duplicate indices writes
the dropped assignments into the sentinel slot ``E*C``, which is never
read, so ``scatter`` (whose winner among duplicates is unspecified on
CUDA) gives the same buffers on every run.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp, mlp_template
from repro_torch.models.params import ParamSpec
from repro_torch.parallel import _collectives as coll
from repro_torch.parallel.sharding import (constrain, get_mesh, is_dtensor,
                                           keep_shards, redistribute,
                                           use_mesh)

CAPACITY_FACTOR = 1.25
GROUP_SIZE = 2048


def moe_template(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    t = {
        "router": ParamSpec((d, e), ("embed", None), fan_in_axis=0,
                            dtype="float32"),
        "wi_gate": ParamSpec((e, d, f), ("experts", "embed", "moe_ff"), fan_in_axis=1),
        "wi_up": ParamSpec((e, d, f), ("experts", "embed", "moe_ff"), fan_in_axis=1),
        "wo": ParamSpec((e, f, d), ("experts", "moe_ff", "embed"), fan_in_axis=1),
    }
    if cfg.n_shared_experts:
        t["shared"] = mlp_template(cfg, cfg.n_shared_experts * cfg.moe_d_ff)
    return t


def _grouping(total_tokens: int) -> Tuple[int, int]:
    g = math.gcd(total_tokens, 32)
    while total_tokens // g > GROUP_SIZE and total_tokens % (g * 2) == 0:
        g *= 2
    return g, total_tokens // g


def _route(cfg: ModelConfig, p, xt):
    """xt: (G,Tg,D) -> (probs, gate_vals, idx) with top-k renormalized."""
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: descending, ties to the lower index
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.experts_per_token
    gate_vals, idx = gate_vals[..., :K], idx[..., :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, idx


def _aux_loss(cfg: ModelConfig, probs, idx, mesh=None, axes=()):
    """Switch load-balance loss: E * sum_e f_e p_e, f_e the mean count of
    assignments to expert e per token (counted, not one-hot summed); over
    the tokens of every process of ``axes`` when ``mesh`` is given."""
    E = cfg.n_experts
    counts = _counts(idx, E)
    n_tok = idx.numel() // idx.shape[-1]
    if mesh is None:
        f_e = counts / n_tok
        p_e = probs.reshape(-1, E).mean(0)
    else:
        n_tok *= mesh.axis_size(axes)
        f_e = coll.psum(counts, axes, mesh) / n_tok
        p_e = coll.psum(probs.reshape(-1, E).sum(0), axes, mesh) / n_tok
    return _aux_term(cfg, f_e, p_e)


def _aux_term(cfg: ModelConfig, f_e, p_e):
    """The load-balance loss from each expert's share of the assignments
    ``f_e`` and its mean router probability ``p_e``."""
    return cfg.router_aux_weight * cfg.n_experts * torch.sum(f_e * p_e)


def _token_group():
    """(mesh, axes, n): the mesh in use and its ``(data, model)``
    processes, which hold one batch between them; (None, (), 1) when no
    mesh is in use or it has one such process."""
    mesh = get_mesh()
    if mesh is None:
        return None, (), 1
    axes = tuple(a for a in ("data", "model") if a in mesh.shape)
    n = mesh.axis_size(axes)
    return (mesh, axes, n) if n > 1 else (None, (), 1)


def _whole_batch(fn, cfg, p, x, mesh, axes):
    """``fn`` over the token group's whole batch (gathered; the gradient
    flows back to each process's rows), keeping this process's rows."""
    xs = coll.all_gather(x, axes, mesh)              # (n, B, S, D)
    with use_mesh(None):
        y, aux = fn(cfg, p, xs.reshape((-1,) + tuple(x.shape[1:])))
    return y.reshape(xs.shape)[coll.axis_index(axes, mesh)], aux


def _capacity(cfg: ModelConfig, Tg: int) -> int:
    K, E = cfg.experts_per_token, cfg.n_experts
    return max(int(math.ceil(Tg * K / E * CAPACITY_FACTOR)), min(Tg, 4))


# ---------------------------------------------------------------------------
# Sort-based dispatch (default)
# ---------------------------------------------------------------------------

def _dispatch(idx, E: int, C: int):
    """idx: (G,Tg,K) expert ids -> (slot (G,Tg*K), keep (G,Tg*K),
    token_for_slot (G,E*C), valid (G,E*C)): each kept assignment's slot
    ``e*C + position`` (the sentinel ``E*C`` when dropped), and each slot's
    token."""
    G, Tg, K = idx.shape
    n, dev = Tg * K, idx.device
    flat_e = idx.reshape(G, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((G, E), dtype=torch.long, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 1) - counts
    pos_sorted = torch.arange(n, device=dev) - torch.gather(starts, 1,
                                                            sorted_e)
    keep_sorted = pos_sorted < C
    slot_sorted = torch.where(keep_sorted, sorted_e * C + pos_sorted,
                              torch.full_like(pos_sorted, E * C))
    # unsort back to assignment order (order is a permutation)
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)
    tok_sorted = torch.where(keep_sorted, order // K,
                             torch.zeros_like(order))
    # duplicates only at the sentinel slot, dropped below
    token_for_slot = torch.zeros((G, E * C + 1), dtype=torch.long,
                                 device=dev).scatter_(1, slot_sorted,
                                                      tok_sorted)
    valid = torch.zeros((G, E * C + 1), dtype=torch.bool,
                        device=dev).scatter_(1, slot_sorted, keep_sorted)
    return slot, keep, token_for_slot[:, :-1], valid[:, :-1]


def _experts(p, xin):
    """xin: (G,E,C,D) -> (G,E,C,D) through each expert's SwiGLU MLP."""
    h = F.silu(torch.einsum("gecd,edf->gecf", xin, p["wi_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", xin, p["wi_up"])
    return torch.einsum("gecf,efd->gecd", h, p["wo"])


def _expert_inputs(xt, token_for_slot, valid, E: int, C: int):
    """(G,Tg,D) tokens -> (G,E,C,D) expert input buffers."""
    G, _, D = xt.shape
    xin = torch.gather(xt, 1, token_for_slot[..., None].expand(G, E * C, D))
    return (xin * valid[..., None].to(xt.dtype)).reshape(G, E, C, D)


def _combine(yexp, slot, keep, gate_vals):
    """(G,E,C,D) expert outputs -> (G,Tg,D): each token's kept
    assignments' rows, weighted by their gates."""
    G, E, C, D = yexp.shape
    Tg, K = gate_vals.shape[1:]
    rows = torch.gather(yexp.reshape(G, E * C, D), 1, torch.clamp(
        slot, max=E * C - 1)[..., None].expand(G, Tg * K, D))
    rows = (rows * keep[..., None].to(yexp.dtype)).reshape(G, Tg, K, D)
    return torch.sum(rows * gate_vals[..., None].to(yexp.dtype), dim=2)


def _experts_sharded(p, xin):
    """``_experts`` on DTensors, each process on its own (group, expert)
    blocks (``local_map``; the blocks are independent): xin keeps its
    group and expert splits, each expert weight takes the expert split
    and is gathered whole over the rest (fsdp's all-gather). A weight's
    gradient is a pending sum over the mesh dims that split the groups.
    The hidden activation is constrained between the two products, as
    the reference's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x_pl = list(keep_shards(xin, (0, 1)).placements)
    w_pl = [Shard(0) if pl == Shard(1) else Replicate() for pl in x_pl]
    w_grad = [Partial() if pl == Shard(0) else w for pl, w in zip(x_pl, w_pl)]

    def local(fn, *args):
        return local_map(fn, out_placements=x_pl,
                         in_placements=(x_pl,) + (w_pl,) * (len(args) - 1),
                         in_grad_placements=(x_pl,) + (w_grad,) * (
                             len(args) - 1),
                         device_mesh=xin.device_mesh)(
            redistribute(args[0], x_pl),
            *(redistribute(w, w_pl) for w in args[1:]))

    h = local(lambda x, wg, wu: F.silu(torch.einsum("gecd,edf->gecf", x, wg))
              * torch.einsum("gecd,edf->gecf", x, wu),
              xin, p["wi_gate"], p["wi_up"])
    h = constrain(h, None, "act_moe_group", "act_experts", None, "act_moe_ff")
    return local(lambda hh, wo: torch.einsum("gecf,efd->gecd", hh, wo),
                    h, p["wo"])


def _reshape_rows(x, shape):
    """``x.reshape(shape)``, both shapes rows of one token order, on a
    DTensor: each process reshapes its own rows (``local_map``), the
    leading dim split as ``x``'s (gathered first where the rows do not
    split evenly into the new leading dim)."""
    import math
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    pl = [p if p == Shard(0) else Replicate() for p in x.placements]
    n = math.prod(mesh.size(i) for i, p in enumerate(pl) if p == Shard(0))
    if shape[0] % n or x.shape[0] % n:
        pl, n = [Replicate()] * mesh.ndim, 1
    local = (shape[0] // n,) + tuple(shape[1:])
    return local_map(lambda t: t.reshape(local), out_placements=pl,
                     in_placements=(pl,), in_grad_placements=(pl,),
                     device_mesh=mesh)(redistribute(x, pl))


def _sort_dispatch(cfg: ModelConfig, xt, router, C: int):
    """The sort dispatch of groups ``xt`` (G,Tg,D): (expert inputs
    (G,E,C,D), what its combine takes besides the expert outputs, the
    router probs, the expert ids)."""
    E = cfg.n_experts
    probs, gate_vals, idx = _route(cfg, {"router": router}, xt)
    slot, keep, token_for_slot, valid = _dispatch(idx, E, C)
    return (_expert_inputs(xt, token_for_slot, valid, E, C),
            (slot, keep, gate_vals), probs, idx)


def _gshard_dispatch(cfg: ModelConfig, xt, router, C: int):
    """The GShard one-hot dispatch of groups ``xt``, as
    :func:`_sort_dispatch` returns it (its combine takes the combine
    weights (G,Tg,E,C))."""
    E = cfg.n_experts
    probs, gate_vals, idx = _route(cfg, {"router": router}, xt)
    onehot = F.one_hot(idx, E).float()                 # (G,Tg,K,E)
    G, Tg, K = idx.shape
    flat = onehot.reshape(G, Tg * K, E)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = torch.einsum("gne,gne->gn", pos, flat).reshape(G, Tg, K)
    keep = (pos < C).float()
    gate_kept = gate_vals * keep
    # a dropped assignment's position (>= C) has no column, as in
    # jax.nn.one_hot: clamped, then zeroed by keep
    pos_oh = F.one_hot(torch.clamp(pos.long(), max=C - 1), C).float() \
        * keep[..., None]
    disp = torch.einsum("gtke,gtkc->gtec", onehot, pos_oh)
    comb = torch.einsum("gtke,gtkc,gtk->gtec", onehot, pos_oh, gate_kept)
    xin = torch.einsum("gtec,gtd->gecd", disp.to(xt.dtype), xt)
    return xin, (comb,), probs, idx


def _gshard_combine(yexp, comb):
    return torch.einsum("gtec,gecd->gtd", comb.to(yexp.dtype), yexp)


# impl -> (dispatch, combine, the number of tensors the dispatch hands
# its combine besides the expert outputs)
_DISPATCHES = {"sort": (_sort_dispatch, _combine, 3),
               "gshard": (_gshard_dispatch, _gshard_combine, 1)}


def _counts(idx, E: int):
    """Assignments per expert (f32), counted."""
    counts = torch.zeros(E, dtype=torch.float32, device=idx.device)
    counts.index_add_(0, idx.reshape(-1),
                      torch.ones(idx.numel(), device=idx.device))
    return counts


def _moe_sharded(cfg: ModelConfig, p, x, impl: str = "sort"):
    """The sort (or GShard) dispatch on DTensors (see the module's
    note)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    dispatch_of, combine_of, n_state = _DISPATCHES[impl]
    B, S, D = x.shape
    E = cfg.n_experts
    G, Tg = _grouping(B * S)
    C = _capacity(cfg, Tg)
    xt = constrain(_reshape_rows(x, (G, Tg, D)), None, "act_batch", None,
                   None)
    # split by group only; a sum over the groups is partial where they are
    g_pl = [pl if pl.is_shard(0) else Replicate() for pl in xt.placements]
    part = [Partial() if pl.is_shard(0) else pl for pl in g_pl]
    whole = [Replicate()] * len(g_pl)
    mesh = xt.device_mesh
    xt = redistribute(xt, g_pl)

    def dispatch(xl, rl):
        xin, state, probs, idx = dispatch_of(cfg, xl, rl, C)
        return (xin, *state, _counts(idx, E), probs.reshape(-1, E).sum(0))

    # the router whole on every process (fsdp splits its embed dim)
    xin, *state, counts, psum = local_map(
        dispatch, out_placements=(g_pl,) * (1 + n_state) + (part, part),
        in_placements=(g_pl, whole), in_grad_placements=(g_pl, part),
        device_mesh=mesh)(xt, redistribute(p["router"], whole))
    xin = constrain(xin, None, "act_moe_group", "act_experts", None, None)
    yexp = _experts_sharded(p, xin)
    # the combine reads every expert's slots: the expert outputs are
    # gathered whole over model
    y = local_map(combine_of, out_placements=g_pl,
                  in_placements=(g_pl,) * (1 + n_state),
                  in_grad_placements=(g_pl,) * (1 + n_state),
                  device_mesh=mesh)(redistribute(yexp, g_pl), *state)
    if cfg.n_shared_experts:
        y = y + mlp(cfg, p["shared"], xt)
    n_tok = B * S
    return (_reshape_rows(y, (B, S, D)),
            _aux_term(cfg, counts / n_tok, psum / n_tok))


def moe(cfg: ModelConfig, p, x):
    """x: (B,S,D) -> (y, aux_loss). Grouped sort-based dispatch."""
    if is_dtensor(x):
        return _moe_sharded(cfg, p, x)
    mesh, axes, n = _token_group()
    B, S, D = x.shape
    E = cfg.n_experts
    G, Tg = _grouping(B * S * n)
    if G % n:
        return _whole_batch(moe, cfg, p, x, mesh, axes)
    C = _capacity(cfg, Tg)

    xt = x.reshape(G // n, Tg, D)
    probs, gate_vals, idx = _route(cfg, p, xt)        # (G,Tg,K)
    slot, keep, token_for_slot, valid = _dispatch(idx, E, C)
    yexp = _experts(p, _expert_inputs(xt, token_for_slot, valid, E, C))
    y = _combine(yexp, slot, keep, gate_vals)

    if cfg.n_shared_experts:
        y = y + mlp(cfg, p["shared"], xt)
    return y.reshape(B, S, D), _aux_loss(cfg, probs, idx, mesh, axes)


# ---------------------------------------------------------------------------
# Manual expert parallelism: explicit all-to-all (the deepseek-scale path)
# ---------------------------------------------------------------------------

def moe_manual_ep(cfg: ModelConfig, p, x):
    """Sort dispatch + an explicit expert all-to-all over the ``(data,
    model)`` processes of the mesh in use (``n_ep`` of them): process
    ``r`` owns experts ``[r*E/n_ep, (r+1)*E/n_ep)``: of the replicated
    expert weights, or its shard of DTensor ones (``_manual_ep_sharded``).
    Falls back to :func:`moe`, as the reference does, with no mesh, one
    such process, or E or G that does not split ``n_ep`` ways."""
    mesh, ep_axes, n_ep = _token_group()
    B, S, D = x.shape
    E = cfg.n_experts
    if is_dtensor(x):
        G, _ = _grouping(B * S)
        if mesh is None or E % n_ep or G % x.device_mesh.size():
            return moe(cfg, p, x)
        return _manual_ep_sharded(cfg, p, x, mesh, ep_axes, n_ep)
    G, Tg = _grouping(B * S * n_ep)
    if mesh is None or E % n_ep or G % n_ep:
        return moe(cfg, p, x)
    E_loc, G_loc = E // n_ep, G // n_ep
    C = _capacity(cfg, Tg)

    xt = constrain(x.reshape(G_loc, Tg, D), None, "act_moe_group", None,
                   None)
    probs, gate_vals, idx = _route(cfg, p, xt)
    slot, keep, token_for_slot, valid = _dispatch(idx, E, C)
    xin = _expert_inputs(xt, token_for_slot, valid, E, C)   # (G_loc,E,C,D)
    r = coll.axis_index(ep_axes, mesh)
    yexp = _exchange(xin, {k: p[k][r * E_loc:(r + 1) * E_loc]
                           for k in ("wi_gate", "wi_up", "wo")},
                     mesh, ep_axes, n_ep)
    y = _combine(yexp, slot, keep, gate_vals)

    if cfg.n_shared_experts:
        y = y + mlp(cfg, p["shared"], xt)
    return y.reshape(B, S, D), _aux_loss(cfg, probs, idx, mesh, ep_axes)


def _exchange(xin, w, mesh, ep_axes, n_ep: int):
    """(G_loc,E,C,D) expert inputs -> outputs, through the resident
    experts ``w`` (E/n_ep of them): to the owners as (n_ep, G_loc, E_loc,
    C, D), chunk j to process j; back come every process's groups for
    the resident experts, source-major, and the results go back the same
    way."""
    G_loc, E, C, D = xin.shape
    E_loc = E // n_ep
    z = xin.reshape(G_loc, n_ep, E_loc, C, D).movedim(1, 0)
    z = coll.all_to_all(z, ep_axes, 0, 0, mesh)
    yz = _experts(w, z.reshape(n_ep * G_loc, E_loc, C, D))
    yz = coll.all_to_all(yz.reshape(n_ep, G_loc, E_loc, C, D), ep_axes, 0, 0,
                         mesh)
    return yz.movedim(0, 1).reshape(G_loc, E, C, D)


def _manual_ep_sharded(cfg: ModelConfig, p, x, mesh, ep_axes, n_ep: int):
    """``moe_manual_ep`` on DTensors (see the module's note): the groups
    split over every mesh dim, each process's dispatch, exchange and
    combine in one ``local_map``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    B, S, D = x.shape
    E = cfg.n_experts
    G, Tg = _grouping(B * S)
    C = _capacity(cfg, Tg)
    dm = x.device_mesh
    xt = constrain(_reshape_rows(x, (G, Tg, D)), None, "act_moe_group", None,
                   None)
    g_pl = [Shard(0)] * dm.ndim
    part = [Partial()] * dm.ndim
    whole = [Replicate()] * dm.ndim
    # each expert weight split over (data, model) on its expert dim, data
    # major (the all-to-all's order); whole over pod, where its gradient
    # is a pending sum over the pod's groups
    ep = [n in ep_axes for n in dm.mesh_dim_names]
    w_pl = [Shard(0) if e else Replicate() for e in ep]
    w_grad = [Shard(0) if e else Partial() for e in ep]
    names = ("wi_gate", "wi_up", "wo")

    def local(xl, rl, *ws):
        xin, (slot, keep, gate_vals), probs, idx = _sort_dispatch(
            cfg, xl, rl, C)
        yexp = _exchange(xin, dict(zip(names, ws)), mesh, ep_axes, n_ep)
        return (_combine(yexp, slot, keep, gate_vals), _counts(idx, E),
                probs.reshape(-1, E).sum(0))

    y, counts, psum = local_map(
        local, out_placements=(g_pl, part, part),
        in_placements=(g_pl, whole) + (w_pl,) * 3,
        in_grad_placements=(g_pl, part) + (w_grad,) * 3, device_mesh=dm)(
        redistribute(xt, g_pl), redistribute(p["router"], whole),
        *(redistribute(p[k], w_pl) for k in names))
    if cfg.n_shared_experts:
        y = y + mlp(cfg, p["shared"], xt)
    n_tok = B * S
    return (_reshape_rows(y, (B, S, D)),
            _aux_term(cfg, counts / n_tok, psum / n_tok))


# ---------------------------------------------------------------------------
# GShard one-hot einsum dispatch (reference)
# ---------------------------------------------------------------------------

def moe_gshard(cfg: ModelConfig, p, x):
    if is_dtensor(x):
        return _moe_sharded(cfg, p, x, "gshard")
    mesh, axes, _ = _token_group()
    if mesh is not None:
        return _whole_batch(moe_gshard, cfg, p, x, mesh, axes)
    B, S, D = x.shape
    G, Tg = _grouping(B * S)
    C = _capacity(cfg, Tg)

    xt = x.reshape(G, Tg, D)
    xin, (comb,), probs, idx = _gshard_dispatch(cfg, xt, p["router"], C)
    y = _gshard_combine(_experts(p, xin), comb)

    if cfg.n_shared_experts:
        y = y + mlp(cfg, p["shared"], xt)
    return y.reshape(B, S, D), _aux_loss(cfg, probs, idx)


MOE_IMPLS = {"sort": moe, "manual_ep": moe_manual_ep, "gshard": moe_gshard}
