"""Cross-pod gradient synchronization with compression
(``repro.optim.grad_compress``), over ``torch.distributed``.

Multi-pod data parallelism pays its gradient reduction over the slow
pod-to-pod links. The reduction over ``pod`` is explicit here, so the
wire format is controllable:

  * ``none``  — plain psum at the gradients' dtype,
  * ``bf16``  — all-gather of the gradients cast to bf16, summed in f32,
  * ``int8``  — per-tensor max-scale int8 quantization: all-gather of the
    int8 tensors and of their f32 scales, then a local dequant-sum, with
    deterministic rounding so every pod computes identical updates.
    Nothing is dequantized before the wire.

``multipod_train_step`` runs one process per device on a ``(pod, data,
model)`` mesh, as the reference's ``shard_map`` that is manual over
``pod`` and automatic over ``(data, model)``. Two layouts of the params
and optimizer state:

  * plain tensors, replicated on every process, on a mesh whose model
    axis is 1: each process takes its rows of the global batch (split
    over ``(pod, data)``, pod-major), the gradients are averaged over
    ``data`` with a plain f32 all-reduce and then over ``pod`` with the
    chosen wire format;
  * DTensor trees on this process's pod sub-mesh (``mesh.without("pod")``:
    the ``(data, model)`` dims of the mesh), placed by
    ``distribute_tree(tree, model.param_shardings(mesh.without("pod")))``
    and the like, and replicated across pods: each pod takes its rows, placed
    on the sub-mesh by the model's batch rule, and ``Model.grads`` runs
    there with tensor parallelism over ``model`` and the data reduction
    over ``data``. The sync over ``pod`` then runs on each gradient's
    local shard: the processes of a pod group share their ``(data,
    model)`` coordinates and hold the same shard, so every wire format
    keeps its dtypes (int8 hands the all-gather int8 shards and f32
    scales).

Every process then applies the identical update.
"""
from __future__ import annotations

import torch

from repro_torch import _tree
from repro_torch.parallel import _collectives as coll
from repro_torch.parallel.sharding import (distribute_tree, is_dtensor,
                                           on_local, tree_shardings,
                                           use_mesh)


def quantize_int8(g):
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-20) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127)
    return q.to(torch.int8), scale


def sync_grads(grads, axis: str, method: str = "none", mesh=None):
    """Average gradients across ``axis`` of ``mesh`` (default: the mesh in
    use) with the chosen wire format. A DTensor leaf (on a sub-mesh
    without ``axis``) is synced on its local shard and keeps its
    placements."""
    if mesh is None:
        from repro_torch.parallel.sharding import get_mesh
        mesh = get_mesh()
    n = mesh.axis_size(axis)

    def none_(g):
        return coll.psum(g, axis, mesh) / n

    def bf16_(g):
        gs = coll.all_gather(g.to(torch.bfloat16), axis, mesh)
        return (torch.sum(gs.float(), dim=0) / n).to(g.dtype)

    def int8_(g):
        q, scale = quantize_int8(g)
        qs = coll.all_gather(q, axis, mesh)            # int8 on the wire
        ss = coll.all_gather(scale, axis, mesh)        # (n,) f32 scales
        deq = qs.float() * ss.reshape((n,) + (1,) * g.dim())
        return (torch.sum(deq, dim=0) / n).to(g.dtype)

    fn = {"none": none_, "bf16": bf16_, "int8": int8_}[method]
    with torch.no_grad():
        return _tree.tree_map(lambda g: on_local(fn, g), grads)


# ---------------------------------------------------------------------------
# The pieces of a data-parallel step.
# ---------------------------------------------------------------------------

def sharded_layout(params, mesh) -> bool:
    """Whether ``params`` are DTensor trees on ``mesh``'s pod sub-mesh
    (else plain tensors replicated on every process). Plain params on a
    model axis above 1 are refused: each process of it would compute the
    same rows, with no tensor parallelism."""
    if is_dtensor(_tree.tree_leaves(params)[0]):
        return True
    if mesh.axis_size("model") > 1:
        raise ValueError(
            f"plain params on {mesh}, whose model axis is above 1: place "
            f"them as DTensors on mesh.without('pod') (distribute_tree "
            f"with model.param_shardings)")
    return False


def place_rows(rules, rows, mesh):
    """Rows of a batch (every leaf's leading dim the batch) as DTensors on
    ``mesh``, split as the ``act_batch`` rule resolves there; each process
    takes its shard of its own copy (no message)."""
    axes = _tree.tree_map(lambda x: ("act_batch",) + (None,) * (x.dim() - 1),
                          rows)
    return distribute_tree(rows, tree_shardings(rules, axes, rows, mesh),
                           src_data_rank=None)


def local_rows(batch, mesh, axes):
    """This process's rows of the global ``batch``: its leading dim split
    over ``axes`` (the first one major), as ``P(axes)`` splits it."""
    n, i = mesh.axis_size(axes), mesh.coord(axes)

    def rows(x):
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} does not split over "
                             f"{axes} ({n} ways)")
        return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]
    return _tree.tree_map(rows, batch)


def data_mean(leaves, mesh):
    """Gradient leaves averaged over ``data`` with a plain f32
    all-reduce (nothing to do at size 1)."""
    n = mesh.axis_size("data")
    if n == 1:
        return list(leaves)
    with torch.no_grad():
        return [(coll.psum(g.float(), "data", mesh) / n).to(g.dtype)
                for g in leaves]


def metrics_mean(metrics, mesh, axes):
    """Each metric averaged over ``axes``, in f32, one all-reduce per
    axis."""
    keys = sorted(metrics)
    with torch.no_grad():
        v = torch.stack([metrics[k].float() for k in keys])
        for ax in axes:
            v = coll.pmean(v, ax, mesh)
    return dict(zip(keys, v.unbind(0)))


def multipod_train_step(model, mesh, method: str = "bf16"):
    """Wrap a Model's train step with explicit compressed cross-pod sync.

    ``step(params, opt_state, batch)``: params and optimizer state
    replicated on every process, or DTensor trees on ``mesh.without("pod")``
    (see the module's note); ``batch`` the global batch. Each pod computes
    the gradients of its rows, the ``method`` sync over ``pod`` averages
    them, and every process applies the identical update. Metrics are
    averaged over ``(pod, data)``.
    """
    assert "pod" in mesh.shape, "multipod_train_step needs a 'pod' axis"

    def replicated_step(params, opt_state, batch):
        local = local_rows(batch, mesh, ("pod", "data"))
        with use_mesh(mesh):
            grads, metrics = model.grads(params, local)
        grads = data_mean(grads, mesh)
        grads = sync_grads(grads, "pod", method, mesh)
        metrics = metrics_mean(metrics, mesh, ("data", "pod"))
        return model.apply_grads(params, opt_state, grads, metrics)

    def step(params, opt_state, batch):
        if not sharded_layout(params, mesh):
            return replicated_step(params, opt_state, batch)
        sub = mesh.without("pod")
        local = place_rows(model.rules, local_rows(batch, mesh, "pod"), sub)
        with use_mesh(sub):
            # the data reduction happens here, on the sub-mesh
            grads, metrics = model.grads(params, local)
            grads = sync_grads(grads, "pod", method, mesh)
            metrics = metrics_mean(metrics, mesh, ("pod",))
            return model.apply_grads(params, opt_state, grads, metrics)

    return step
