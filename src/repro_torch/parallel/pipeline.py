"""Pipeline parallelism over the ``pod`` axis (GPipe-style), as
``repro.parallel.pipeline``, over ``torch.distributed``.

Data parallelism over pods costs a full gradient reduction per step;
pipeline parallelism over pods costs only the boundary activations.

Mechanics (one process per device on a ``(pod, data, model)`` mesh, as the
reference's ``shard_map`` that is manual over ``pod`` and automatic over
``(data, model)``):

  * each LM stage's stacked layer params are split on their leading
    (layers) dim over ``pod``: pod *p* holds a contiguous slice of layers
    (``split_stages`` cuts a full tree, ``gather_stages`` rebuilds it),
  * activations rotate pod->pod with ``ppermute`` on a GPipe schedule:
    at tick t, pod s processes microbatch t-s; pod 0 injects embeddings,
    the last pod computes the loss on valid ticks. Every pod runs the same
    program (the injection and the loss are selected by pod, not skipped),
    so every pod's backward meets the same collectives in the same order,
  * the backward runs through the ppermutes (each one's backward is the
    inverse permutation),
  * embedding/head params are replicated across pods; their gradients are
    summed over ``pod`` explicitly, in f32,
  * the gradients are clipped by their global norm over every pod's
    layers (the resident leaves' squares summed over ``pod``).

Two layouts of a pod's params and AdamW state. Plain tensors, on a mesh
whose model axis is 1: the batch is split over ``data`` by hand and the
gradients averaged over it. DTensor trees on the pod's ``(data, model)``
sub-mesh (``mesh.without("pod")``; ``split_stages`` of a tree placed by
``distribute_tree(tree, model.param_shardings(mesh.without("pod")))``
keeps the placements, the layers dim being never split): each
microbatch is placed on the sub-mesh by the batch rule, the stages run
with tensor parallelism over ``model``, the data reduction is the
gradients' redistribution to their params' layouts, and the boundary
activation crosses pods as each process's local shard, between the
processes that share their ``(data, model)`` coordinates. The pod sum
and the norm work on the local shards too.

Each pod differentiates its own share of the loss (the last pod's
microbatch losses, every pod's MoE aux terms), whose sum over the pods
is the loss. The reference differentiates the loss after its ``psum``
over pods, whose transpose under ``check_vma=False`` is again a psum, so
its gradients come out ``n_pods`` times the plain step's before clipping,
and it clips each pod by the norm of that pod's own leaves; the port's
gradients and norm equal the plain step's.

Constraints: every stage's layer count must divide by n_pods; the batch
must divide by data x n_micro; decoder-only archs; AdamW.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import _tree
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import adt, lm_logits, rmsnorm, xent_loss
from repro_torch.optim.grad_compress import (data_mean, local_rows,
                                             metrics_mean, place_rows,
                                             sharded_layout)
from repro_torch.parallel import _collectives as coll
from repro_torch.parallel.sharding import (as_plain, is_dtensor, on_local,
                                           redistribute, replicated,
                                           use_mesh)


def _is_stage(key) -> bool:
    return isinstance(key, str) and key.startswith("stage_")


def _map_stages(f, tree):
    """``f`` over the leaves under every ``stage_*`` key of ``tree`` (a
    params tree, or an optimizer state holding params-like trees)."""
    if not isinstance(tree, dict):
        return tree
    return {k: _tree.tree_map(f, v) if _is_stage(k) else _map_stages(f, v)
            for k, v in tree.items()}


def split_stages(tree, mesh):
    """This pod's slice of every stage's stacked layers."""
    n, s = mesh.axis_size("pod"), mesh.coord("pod")

    def cut(x):
        k = x.shape[0] // n
        return x[s * k:(s + 1) * k]
    return _map_stages(cut, tree)


def gather_stages(tree, mesh):
    """The full tree back from every pod's slice (a DTensor's local
    shards gathered over ``pod``, its placements kept)."""
    return _map_stages(lambda x: on_local(lambda t: torch.cat(
        coll.all_gather(t, "pod", mesh).unbind(0)), x), tree)


def _rotate(buf, ring, mesh):
    """One tick of the pipe: ``buf`` to the next pod. A DTensor crosses as
    its local shard (a pending sum reduced first), to the process of the
    next pod that holds the same shard."""
    if is_dtensor(buf) and any(p.is_partial() for p in buf.placements):
        from torch.distributed.tensor import Replicate
        buf = redistribute(buf, [Replicate() if p.is_partial() else p
                                 for p in buf.placements])
    return on_local(lambda t: coll.ppermute(t, "pod", ring, mesh), buf)


def _microbatches(batch, n_micro):
    return [_tree.tree_map(lambda x: x.reshape(
        (n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))[i], batch)
        for i in range(n_micro)]


def pipeline_train_step(model, mesh, n_micro: int) -> Callable:
    """Build a pipelined train step for a decoder-only dense/MoE LM:
    ``step(params, opt_state, batch)`` with this pod's slice of the
    params and of the AdamW state (``split_stages``) and the global
    batch."""
    assert "pod" in mesh.shape
    n_stages = mesh.shape["pod"]
    cfg, run = model.cfg, model.run
    assert not cfg.is_encoder_decoder, "PP path covers decoder-only archs"
    for _, reps in cfg.stages():
        assert reps % n_stages == 0, f"stage depth {reps} % pods {n_stages}"
    assert run.optimizer == "adamw", "PP path wires adamw state sharding"
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def loss_shares(params, micro, s):
        """(xent share, aux share) of this pod, each over n_micro."""
        B_m, S = micro[0]["tokens"].shape
        dev = micro[0]["tokens"].device
        first = torch.tensor(s == 0, device=dev)
        last = torch.tensor(s == n_stages - 1, device=dev)
        buf = torch.zeros((B_m, S, cfg.d_model), dtype=adt(cfg), device=dev)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        aux_total = torch.zeros((), dtype=torch.float32, device=dev)
        for t in range(n_micro + n_stages - 1):
            # stage 0 injects microbatch t (if any)
            if t < n_micro:
                buf = torch.where(first, tfm.embed_inputs(cfg, params,
                                                          micro[t]), buf)
            # every pod applies its resident layer slice
            buf, _, aux = tfm.run_stages(cfg, run, params, buf, mode="full")
            aux_total = aux_total + aux
            # last pod emits microbatch m = t - (n_stages-1)
            m = t - (n_stages - 1)
            if 0 <= m < n_micro:
                h = rmsnorm(cfg, params["final_norm"], buf)
                logits = lm_logits(cfg, params["embed"], h)
                loss_m = xent_loss(cfg, logits[:, :-1],
                                   micro[m]["labels"][:, 1:])
                total = total + torch.where(last, loss_m, 0.0)
            # rotate the pipe
            buf = _rotate(buf, ring, mesh)
        return total / n_micro, aux_total / n_micro

    def step(params, opt_state, batch):
        sharded = sharded_layout(params, mesh)
        s = mesh.coord("pod")
        if sharded:
            sub = mesh.without("pod")
            micro = [place_rows(model.rules, mb, sub)
                     for mb in _microbatches(batch, n_micro)]
        else:
            sub = mesh
            micro = _microbatches(local_rows(batch, mesh, "data"), n_micro)
        leaves = [p.detach().requires_grad_()
                  for p in _tree.tree_leaves(params)]
        with torch.enable_grad(), use_mesh(sub), model.scope():
            xent, aux = loss_shares(_tree.unflatten_like(params, leaves),
                                    micro, s)
            share = xent + aux
            if is_dtensor(share):    # seeded once, not once per process
                share = replicated(share)
            grads = torch.autograd.grad(share, leaves, allow_unused=True)
            # a DTensor gradient laid out as its param: the data reduction
            grads = [torch.zeros_like(p) if g is None else
                     redistribute(g, p.placements) if is_dtensor(g) else g
                     for g, p in zip(grads, leaves)]
        # layer grads are pod-resident; replicated params (embed, norms)
        # need the explicit cross-pod sum, in f32
        resident = _tree.tree_leaves(_map_stages(
            lambda _: True, _tree.tree_map(lambda _: False, params)))
        with torch.no_grad():
            grads = [g if r else on_local(lambda t: coll.psum(
                t.float(), "pod", mesh).to(t.dtype), g)
                for g, r in zip(grads, resident)]
            xent, aux = coll.psum(torch.stack(
                [as_plain(xent), as_plain(aux)]).detach(), "pod",
                mesh).unbind(0)
        if not sharded:
            grads = data_mean(grads, mesh)
        # the global norm: the resident leaves' squares summed over pods
        with torch.no_grad():
            sq = [as_plain(torch.sum(torch.square(g.float()))) for g in grads]
            own = sum(q for q, r in zip(sq, resident) if r)
            shared = sum(q for q, r in zip(sq, resident) if not r)
            gnorm = torch.sqrt(coll.psum(own, "pod", mesh) + shared)
        metrics = {"loss": xent + aux, "xent": xent}
        if not sharded:
            metrics = metrics_mean(metrics, mesh, ("data",))
        with use_mesh(sub):
            return model.apply_grads(params, opt_state, grads, metrics,
                                     gnorm)

    return step
