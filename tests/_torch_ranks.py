"""The rank side of the port's multi-process tests, and their launcher.

``run_ranks(scenario, world, workdir, inputs)`` starts ``world`` processes
of this file on the CPU. Each joins a gloo process group through a
``file://`` rendezvous in ``workdir`` (no port to collide on under
``pytest -n``), runs ``SCENARIOS[scenario](mesh maker, rank, inputs)`` with
one CPU thread, saves what it returns and leaves the group. The launcher
waits at most ``timeout`` seconds: a process that exits with an error
fails the run at once with its traceback, the others are killed, and a
run past its time is killed whole. Ranks import torch and the port only.

    python tests/_torch_ranks.py SCENARIO RANK WORLD WORKDIR
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# The launcher (test side).
# ---------------------------------------------------------------------------

def run_ranks(scenario: str, world: int, workdir, inputs=None,
              timeout: float = 120.0):
    """Run ``scenario`` on ``world`` processes; the list of what each
    returned, by rank."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, workdir / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    logs = [open(workdir / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, scenario, str(r), str(world),
         str(workdir)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]

    def log(r):
        logs[r].flush()
        logs[r].seek(0)
        return logs[r].read()[-6000:]

    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad:
                raise AssertionError(f"{scenario}: rank {bad[0]} exited "
                                     f"{procs[bad[0]].returncode}:\n"
                                     + log(bad[0]))
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"{scenario}: not done in {timeout} s:\n"
                    + "\n".join(f"-- rank {r}\n{log(r)}"
                                for r in range(world)))
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise AssertionError(f"{scenario}: rank {bad[0]} exited "
                                 f"{procs[bad[0]].returncode}:\n"
                                 + log(bad[0]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    return [torch.load(workdir / f"out{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# Scenarios (rank side). Each takes (mesh maker, rank, inputs).
# ---------------------------------------------------------------------------

def _tinyllama_run(n_layers, shape=("t", 16, 8, "train")):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
    cfg = reduced(get_config("tinyllama-1.1b"), n_layers=n_layers)
    return RunConfig(model=cfg, shape=ShapeProfile(*shape), remat="none")


def grad_compress(make_mesh, rank, inputs):
    """Each wire format's multipod step on ``inputs["mesh"]``: its
    metrics, its collective counts, (rank 0) the updated params, and what
    each call of ``sync_grads`` inside the step took (this pod's
    gradients) and gave (the synced ones). With a model axis above 1 the
    params and AdamW state are DTensors on the pod's (data, model)
    sub-mesh (``fsdp`` placements), and what the sync took and gave is
    gathered whole (``pre``, ``synced``) and as this process's shards
    (``pre_local``, ``synced_local``); ``local_elems`` counts them. The
    optimizer state is ``model.opt_init`` of the params as placed; its
    layout and Adafactor's are recorded."""
    from repro_torch import _tree
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import Model
    from repro_torch.optim import grad_compress as gc
    from repro_torch.optim.optimizers import adafactor_init
    from repro_torch.parallel import _collectives as coll
    from repro_torch.parallel.sharding import distribute_tree, is_dtensor
    mesh = make_mesh(inputs["mesh"])
    run = _tinyllama_run(2)
    model = Model(run)
    params = inputs["params"]
    sub = mesh.without("pod")
    if mesh.shape["model"] > 1:
        params = distribute_tree(params, model.param_shardings(sub), None)
    opt = model.opt_init(params)
    batch = SyntheticLMData(run.model, run.shape).batch(0)
    syncs, sync = [], gc.sync_grads

    def whole(t):
        return t.full_tensor() if is_dtensor(t) else t.detach().clone()

    def local(t):
        return (t.to_local() if is_dtensor(t) else t).detach().clone()

    def recorded(grads, axis, method, mesh=None):
        out = sync(grads, axis, method, mesh)
        g, o = _tree.tree_leaves(grads), _tree.tree_leaves(out)
        syncs.append({"axis": axis, "pre": [whole(x) for x in g],
                      "synced": [whole(x) for x in o],
                      "pre_local": [local(x) for x in g],
                      "synced_local": [local(x) for x in o]})
        return out
    gc.sync_grads = recorded
    leaves = _tree.tree_leaves(params)
    # the pod sub-mesh's (data, model) group holds this pod's processes
    pod_sum = torch.tensor([float(rank)])
    torch.distributed.all_reduce(pod_sum, group=sub.group(("data",
                                                           "model")))
    try:        # a sub-mesh made by hand cannot make that group
        from repro_torch.parallel.sharding import Mesh
        Mesh(sub.shape, sub.device_mesh).group(("data", "model"))
        refused = mesh.shape["pod"] == 1
    except ValueError:
        refused = True

    def layout(t):
        """(DTensor?, global shape, local shape, placements)"""
        return (is_dtensor(t), tuple(t.shape), tuple(
            (t.to_local() if is_dtensor(t) else t).shape),
            str(tuple(t.placements)) if is_dtensor(t) else None)
    # the optimizer states' layouts, made from the params, beside the
    # placements the model's opt_shardings name; Adafactor's too
    out = {"opt_layouts": [layout(t) for t in _tree.tree_leaves(opt)],
           "opt_sharding_placements": _tree.tree_leaves(_tree.tree_map(
               lambda _, s: str(tuple(s.placements)), opt,
               model.opt_shardings(sub))),
           "adafactor_layouts": [layout(t) for t in _tree.tree_leaves(
               adafactor_init(params))],
           "param_layouts": [layout(t) for t in leaves]}
    out.update({
        "pod": mesh.coord("pod"), "rows": mesh.coord(("pod", "data")),
        "shard": mesh.coord(("data", "model")),
        "pod_group_sum": float(pod_sum), "hand_sub_mesh_refused": refused,
        "local_elems": sum((t.to_local() if is_dtensor(t) else t).numel()
                           for t in leaves),
        "n_leaves": len(leaves), "sharded": is_dtensor(leaves[0])})
    for method in ("none", "bf16", "int8"):
        coll.reset_counts()
        syncs.clear()
        p2, _, m = gc.multipod_train_step(model, mesh, method)(params, opt,
                                                                batch)
        counts = coll.counts()
        p2 = _tree.tree_map(whole, p2)
        out[method] = {"metrics": {k: float(v) for k, v in m.items()},
                       "counts": counts, "syncs": list(syncs),
                       "params": p2 if rank == 0 else None}
    return out


def pipeline(make_mesh, rank, inputs):
    """One GPipe step over ``inputs["mesh"]``'s pods from the full params:
    its metrics, counts, and the full updated params and AdamW first
    moments (0.1 x each clipped gradient leaf). With a model axis above 1
    the params are DTensors on the pod's (data, model) sub-mesh (``fsdp``
    placements), and their AdamW state is made from them, before the
    stages are split."""
    from repro_torch import _tree
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model_zoo import Model
    from repro_torch.parallel import _collectives as coll
    from repro_torch.parallel.pipeline import (gather_stages,
                                               pipeline_train_step,
                                               split_stages)
    from repro_torch.parallel.sharding import distribute_tree, is_dtensor
    mesh = make_mesh(inputs["mesh"])
    run = _tinyllama_run(inputs["n_layers"])
    model = Model(run)
    params = inputs["params"]
    if mesh.shape["model"] > 1:
        params = distribute_tree(
            params, model.param_shardings(mesh.without("pod")), None)
    opt = model.opt_init(params)
    batch = SyntheticLMData(run.model, run.shape).batch(0)
    coll.reset_counts()
    step = pipeline_train_step(model, mesh, n_micro=4)
    p2, o2, m = step(split_stages(params, mesh), split_stages(opt, mesh),
                     batch)
    counts = coll.counts()

    def whole(tree):
        return _tree.tree_map(lambda t: t.full_tensor() if is_dtensor(t)
                              else t, gather_stages(tree, mesh))
    return {"metrics": {k: float(v) for k, v in m.items()}, "counts": counts,
            "local_layers": p2["stage_0"]["pos_0"]["ln1"]["scale"].shape[0],
            "sharded": is_dtensor(p2["embed"]["embedding"]),
            "params": whole(p2), "mu": _tree.tree_leaves(whole(o2["mu"]))}


def moe(make_mesh, rank, inputs):
    """Each MoE dispatch under each mesh: this rank's output rows, aux,
    and the gradients of sum(y * ct) + aux / n (this process's share of
    the objective) and of aux / n alone with respect to its rows and to
    the layer's params."""
    from repro_torch import _tree
    from repro_torch.models import moe as M
    from repro_torch.optim.grad_compress import local_rows
    from repro_torch.parallel.sharding import use_mesh
    from repro_torch.parallel import _collectives as coll
    out = {}
    for case in inputs["cases"]:
        cfg, p, x, ct = (case[k] for k in ("cfg", "params", "x", "ct"))
        for shape in inputs["meshes"]:
            mesh = make_mesh(shape)
            n = mesh.axis_size(("data", "model"))
            xl = local_rows(x, mesh, ("pod", "data")).clone()
            cl = local_rows(ct, mesh, ("pod", "data"))
            for impl in ("manual_ep", "sort", "gshard"):
                leaves = [t.detach().requires_grad_()
                          for t in _tree.tree_leaves(p)]
                xg = xl.clone().requires_grad_()
                coll.reset_counts()
                with use_mesh(mesh):
                    y, aux = M.MOE_IMPLS[impl](
                        cfg, _tree.unflatten_like(p, leaves), xg)
                    gx, *gp = torch.autograd.grad(
                        (y * cl).sum() + aux / n, [xg] + leaves,
                        retain_graph=True)
                    # the load-balance loss alone: its gradient is too
                    # small to show beside the output's
                    ga = torch.autograd.grad(aux / n, [xg] + leaves,
                                             allow_unused=True)
                out[(cfg.name, tuple(shape), impl)] = {
                    "y": y.detach(), "aux": float(aux), "gx": gx,
                    "gp": [g.detach() for g in gp], "ga": list(ga),
                    "counts": coll.counts()}
    return out


def moe_dtensor(make_mesh, rank, inputs):
    """The manual_ep and gshard dispatches on DTensors (the sort
    dispatch's DTensor path is the ``tp`` scenario's): the layer's params
    placed by the
    ``fsdp`` rules and the batch and cotangent split over data, on the
    (data, model) sub-mesh of each (pod, data, model) mesh of
    ``inputs["meshes"]`` (every pod runs the whole batch). Per case: the
    output, aux, and the gradients of sum(y * ct) + aux with respect to
    the batch and the params, all gathered whole; the collective counts
    and the placements the expert weights had."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import _tree
    from repro_torch.models import moe as M
    from repro_torch.models.params import logical_axes
    from repro_torch.optim.grad_compress import place_rows
    from repro_torch.parallel import _collectives as coll
    from repro_torch.parallel.sharding import (FSDP_RULES, distribute_tree,
                                               redistribute, replicated,
                                               tree_shardings, use_mesh,
                                               use_rules)
    out = {}
    for shape in inputs["meshes"]:
        sub = make_mesh(shape).without("pod")
        for case in inputs["cases"]:
            cfg = case["cfg"]
            sh = tree_shardings(FSDP_RULES,
                                logical_axes(M.moe_template(cfg)),
                                case["params"], sub)
            p = distribute_tree(case["params"], sh, None)
            x, ct = (place_rows(FSDP_RULES, case[k], sub)
                     for k in ("x", "ct"))
            for impl in ("manual_ep", "gshard"):
                leaves = [t.detach().requires_grad_()
                          for t in _tree.tree_leaves(p)]
                xg = x.detach().requires_grad_()
                coll.reset_counts()
                with use_mesh(sub), use_rules(FSDP_RULES), \
                        implicit_replication():
                    y, aux = M.MOE_IMPLS[impl](
                        cfg, _tree.unflatten_like(p, leaves), xg)
                    obj = replicated((y * ct).sum() + aux)
                    gx, *gp = torch.autograd.grad(obj, [xg] + leaves)
                    gp = [redistribute(g, t.placements)
                          for g, t in zip(gp, leaves)]
                out[(cfg.name, tuple(shape), impl)] = {
                    "y": y.detach().full_tensor(), "aux": float(
                        replicated(aux).to_local()),
                    "gx": gx.full_tensor(),
                    "gp": [g.full_tensor() for g in gp],
                    "placements": [str(t.placements) for t in leaves],
                    "counts": coll.counts()}
    return out


def checkpoint(make_mesh, rank, inputs):
    """Save a tree sharded over (pod 2), restore it onto (data 2) with
    the fsdp placements: full tensors and this rank's shards."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import RunConfig, ShapeProfile
    from repro_torch.models.model_zoo import Model
    from repro_torch.parallel.pipeline import _map_stages
    from repro_torch.parallel.sharding import (NamedSharding,
                                               distribute_tree, placements)
    from repro_torch import _tree
    cfg = inputs["cfg"]
    model = Model(RunConfig(model=cfg, shape=ShapeProfile("t", 8, 2,
                                                          "train")))
    pod = make_mesh((2, 1, 1))
    # the pipeline's layout: stage layers split over pod, the rest whole
    whole, split = (NamedSharding(pod.device_mesh, placements(s, pod), s)
                    for s in ((), ("pod",)))
    sh = _map_stages(lambda _: split,
                     _tree.tree_map(lambda _: whole, inputs["params"]))
    placed = distribute_tree(inputs["params"], sh)
    ck = Checkpointer(inputs["dir"])
    ck.save("m", 3, placed, topology={"mesh": pod.shape})
    saved = ck.latest_step("m")     # on every process, once save returns
    data = make_mesh((1, 2, 1))
    tree, meta = ck.restore("m", model.abstract_params(),
                            shardings=model.param_shardings(data))
    leaves = _tree.tree_leaves(tree)
    return {"meta": meta, "saved": saved,
            "full": [t.full_tensor() for t in leaves],
            "local_shapes": [tuple(t.to_local().shape) for t in leaves],
            "saved_local_shapes": [tuple(t.to_local().shape)
                                   for t in _tree.tree_leaves(placed)]}


def layout(make_mesh, rank, inputs):
    """This rank's shard of ``arange(64)`` under each PSpec of
    ``inputs["specs"]`` on a (pod 2, data 2, model 1) mesh."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel.sharding import placements
    mesh = make_mesh((2, 2, 1))
    x = torch.arange(64.0).reshape(16, 4)
    return {"coord": {a: mesh.coord(a) for a in mesh.axis_names},
            **{spec: distribute_tensor(x, mesh.device_mesh, list(
                placements(spec, mesh))).to_local()
               for spec in inputs["specs"]}}


def constrain(make_mesh, rank, inputs):
    """``constrain`` on a (data 1, model 2) mesh: the placements and this
    rank's shard of a replicated 4 x 8 DTensor constrained to
    (act_batch, act_ff), then of that one constrained back to
    (act_batch, None)."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import make_mesh as live_mesh
    from repro_torch.parallel.sharding import FSDP_RULES, constrain, use_mesh
    mesh = live_mesh((1, 2), ("data", "model"), "cpu")
    x = DTensor.from_local(torch.arange(32.0).reshape(4, 8),
                           mesh.device_mesh, [Replicate(), Replicate()])
    with use_mesh(mesh):
        y = constrain(x, FSDP_RULES, "act_batch", "act_ff")
        z = constrain(y, FSDP_RULES, "act_batch", None)
    return {"y": (y.placements, y.to_local().clone()),
            "z": (z.placements, z.to_local().clone())}


def tp(make_mesh, rank, inputs):
    """Each case of ``inputs["cases"]`` (config, mesh shape over (data,
    model), preset) on the port's steps over DTensor-placed trees: one
    train step (metrics, the updated params and first moments gathered,
    each param's local shard shape and pspec), a prefill and the decode
    steps of the given tokens (logits gathered)."""
    from repro_torch import _tree
    from repro_torch.configs.base import RunConfig, ShapeProfile
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import make_mesh as live_mesh
    from repro_torch.models.model_zoo import Model
    from repro_torch.parallel.sharding import distribute_tree, use_mesh
    S, B = inputs["S"], inputs["B"]
    out = {}
    for cfg, shape, preset in inputs["cases"]:
        mesh = live_mesh(shape, ("data", "model"), "cpu")
        params = inputs["params"][cfg.name]
        m = Model(RunConfig(model=cfg, shape=ShapeProfile("t", S, B, "train"),
                            sharding_preset=preset))
        batch = SyntheticLMData(cfg, m.run.shape).batch(0)
        dp = distribute_tree(params, m.param_shardings(mesh))
        with use_mesh(mesh):
            p2, o2, met = m.train_step(
                dp, distribute_tree(m.opt_init(params), m.opt_shardings(mesh)),
                distribute_tree(batch, m.batch_shardings(mesh)))
        rec = {"metrics": {k: float(v) for k, v in met.items()},
               "params": [t.full_tensor() for t in _tree.tree_leaves(p2)],
               # AdamW's first moment after one step: 0.1 x each clipped
               # gradient leaf, laid out as its parameter
               "mu": [t.full_tensor() for t in _tree.tree_leaves(o2["mu"])],
               # (global shape, local shape, pspec) of every param leaf
               "shards": _tree.tree_leaves(_tree.tree_map(
                   lambda t, sh: (tuple(t.shape), tuple(t.to_local().shape),
                                  sh.spec), dp, m.param_shardings(mesh)),
                   is_leaf=lambda x: isinstance(x, tuple)),
               "placements_kept": all(
                   a.placements == b.placements for a, b in zip(
                       _tree.tree_leaves(p2), _tree.tree_leaves(dp)))}
        d = Model(RunConfig(model=cfg, shape=ShapeProfile("d", S, B,
                                                          "decode"),
                            sharding_preset=preset))
        pb = {k: v for k, v in batch.items() if k != "labels"}
        pb["tokens"] = pb["tokens"][:, :S // 2]
        sh = d.batch_shardings(mesh)
        with use_mesh(mesh):
            logits, cache = d.prefill(
                dp, distribute_tree(pb, {k: sh[k] for k in pb}),
                distribute_tree(d.init_cache(), d.cache_shardings(mesh)))
            rec["logits"] = [logits.full_tensor()]
            for tok in inputs["tokens"][cfg.name]:
                logits, cache = d.decode_step(
                    dp, distribute_tree(tok, d.token_sharding(mesh)), cache)
                rec["logits"].append(logits.full_tensor())
        out[(cfg.name, tuple(shape), preset)] = rec
    return out


SCENARIOS = {f.__name__: f for f in (grad_compress, pipeline, moe,
                                     moe_dtensor, checkpoint, layout,
                                     constrain, tp)}


def _main(scenario, rank, world, workdir):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    workdir = Path(workdir)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rdv",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        inputs = torch.load(workdir / "inputs.pt", weights_only=False)
        out = SCENARIOS[scenario](
            lambda shape: make_mesh(shape, ("pod", "data", "model"), "cpu"),
            rank, inputs)
        torch.save(out, workdir / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
