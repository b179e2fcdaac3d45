"""The collectives of the manual mesh axes over ``torch.distributed``: the
counterparts of ``jax.lax.psum``, ``pmean``, ``all_gather``,
``all_to_all`` (``tiled=True``) and ``ppermute``, named by mesh axis as
inside a ``shard_map``. This is the one module of the port that calls
``torch.distributed``'s collectives.

Gradients. Each collective is an ``autograd.Function``. A process's
backward seed is its own share of the objective, and the objective is the
sum of the shares over the processes of the axis (torch's convention, and
the transpose rules JAX applies under ``shard_map(check_vma=False)``):
  * ``psum``'s backward is a ``psum`` of the cotangents, ``pmean``'s the
    same divided by the axis size;
  * ``all_gather``'s is a reduce-scatter: the cotangents summed over the
    processes, each keeping its own slice;
  * ``all_to_all``'s is the ``all_to_all`` back (split and concat axes
    swapped);
  * ``ppermute``'s is the inverse permutation, as JAX's transpose.
A loss every process computes alike (a replicated value) is therefore
counted once per process: seed a share of it, or divide by the axis size.

Counting. Every call, forward or backward, adds the bytes it hands to
``torch.distributed`` to ``BYTES[(op, dtype)]`` and one to ``CALLS[op]``
(read with ``counts()``, zeroed with ``reset_counts()``): the port's
stand-in for ``hlo_analysis.collective_bytes`` over the reference's HLO.
"""
from __future__ import annotations

import collections
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

BYTES: collections.Counter = collections.Counter()
CALLS: collections.Counter = collections.Counter()


def reset_counts():
    BYTES.clear()
    CALLS.clear()


def counts() -> dict:
    """{"bytes": {"op/dtype": n}, "calls": {op: n}} since the last reset."""
    return {"bytes": {f"{op}/{dt}": n for (op, dt), n in sorted(BYTES.items())},
            "calls": dict(sorted(CALLS.items()))}


def _record(op: str, t: torch.Tensor):
    BYTES[(op, str(t.dtype).removeprefix("torch."))] += \
        t.numel() * t.element_size()
    CALLS[op] += 1


# ---------------------------------------------------------------------------
# The calls.
# ---------------------------------------------------------------------------

def _sum(x, group):
    y = x.contiguous().clone()
    _record("psum", y)
    dist.all_reduce(y, group=group)
    return y


def _gather(x, group, n):
    x = x.contiguous()
    _record("all_gather", x)
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x, group=group)
    return torch.stack(out)


def _a2a(x, group, n, split_axis, concat_axis):
    """Chunk ``j`` of ``x`` along ``split_axis`` goes to process ``j``; the
    chunks received are concatenated along ``concat_axis`` in source
    order."""
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)}"
                         f" does not split {n} ways")
    send = torch.stack(x.tensor_split(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    _record("all_to_all", send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def _permute(x, group, n, me, perm):
    """Send ``x`` to the process ``perm`` maps this one to and take what
    the process mapped here sends (zeros where none is), as one
    ``all_to_all_single`` with a single non-empty split each way."""
    dst = {s: d for s, d in perm}.get(me)
    src = {d: s for s, d in perm}.get(me)
    flat = x.contiguous().reshape(-1)
    out = torch.zeros_like(flat)
    _record("ppermute", flat)
    dist.all_to_all_single(
        out, flat, [flat.numel() if j == src else 0 for j in range(n)],
        [flat.numel() if j == dst else 0 for j in range(n)], group=group)
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# The autograd Functions.
# ---------------------------------------------------------------------------

class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me):
        ctx.group, ctx.me = group, me
        return _gather(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group)[ctx.me], None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, concat_axis, split_axis)
        return _a2a(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, *ctx.args), None, None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, perm):
        ctx.args = (group, n, me, [(d, s) for s, d in perm])
        return _permute(x, group, n, me, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, *ctx.args), None, None, None, None


# ---------------------------------------------------------------------------
# By mesh axis.
# ---------------------------------------------------------------------------

def _axis(axis, mesh) -> Tuple[object, int, int]:
    """(process group, size, this process's index) over ``axis`` (a name or
    a tuple of names) of ``mesh``, default the active mesh."""
    if mesh is None:
        from repro_torch.parallel.sharding import get_mesh
        mesh = get_mesh()
    if mesh is None:
        raise ValueError(f"collective over {axis!r} with no mesh in use")
    group = mesh.group(axis)
    return group, mesh.axis_size(axis), dist.get_rank(group)


def psum(x, axis, mesh=None):
    group, _, _ = _axis(axis, mesh)
    return _PSum.apply(x, group)


def pmean(x, axis, mesh=None):
    group, n, _ = _axis(axis, mesh)
    return _PSum.apply(x, group) / n


def all_gather(x, axis, mesh=None):
    """(n, *x.shape): every process's ``x``, in the axis's order."""
    group, n, me = _axis(axis, mesh)
    return _AllGather.apply(x, group, n, me)


def all_to_all(x, axis, split_axis: int, concat_axis: int, mesh=None):
    group, n, _ = _axis(axis, mesh)
    return _AllToAll.apply(x, group, n, split_axis, concat_axis)


def ppermute(x, axis, perm: Sequence[Tuple[int, int]], mesh=None):
    """``perm``: (source, destination) pairs of indices along ``axis``."""
    group, n, me = _axis(axis, mesh)
    return _PPermute.apply(x, group, n, me, [tuple(p) for p in perm])


def axis_index(axis, mesh=None) -> int:
    return _axis(axis, mesh)[2]
