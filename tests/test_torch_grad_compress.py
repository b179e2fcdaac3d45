"""Cross-pod compressed gradient sync on the port
(``repro_torch.optim.grad_compress``) held to the reference
(``tests/test_grad_compress.py``): ``quantize_int8`` bit for bit, and
``multipod_train_step`` under gloo on the CPU at world 2 (pod 2) and world
4 (pod 2 x data 2) with replicated params, and at world 4 (pod 2 x model
2) and world 8 (pod 2 x data 2 x model 2, the reference test's mesh) with
the params as DTensors on each pod's (data, model) sub-mesh (``fsdp``
placements) and AdamW state made from them, reduced tinyllama at 2
layers, batch 8 x 16 tokens, f32. The reference's own test of that mesh
aborts in XLA's SPMD partitioner on this jax, so the port is held to the
reference's plain step and to its ``sync_grads`` arithmetic.

Each rank records what ``sync_grads`` took and gave inside the step. Bounds:
  * every wire format's loss within 1e-3 of the reference's plain
    ``Model.train_step`` (the reference test's bound); ``none`` within rel
    1e-5 (loss) and 1e-4 (grad_norm) of the port's plain step;
  * each pod's gradients before the sync within 1e-4 of its leaf's
    largest value of the reference's gradients on the same rows, averaged
    over ``data`` (f32 noise);
  * the synced gradients within 1e-6 of the reference's own arithmetic
    (``repro.optim.grad_compress.sync_grads`` under ``jax.vmap`` over
    ``pod``) applied to the pods' gradients, and within the wire format's
    rounding of their mean: bf16 2^-8 of the mean of |g|, int8 half the
    mean of the pods' scales;
  * the step's grad_norm the norm of the synced gradients (rel 1e-5), and
    within the norm of what the rounding moved (plus rel 1e-4) of the
    plain step's;
  * the params within one AdamW step's reach of the plain step's: a first
    step moves an element by at most lr whatever its gradient, so two
    differ by at most 2 lr and the rounding of the stored value;
  * int8 hands only int8 tensors and their f32 scales to the all-gather,
    and fewer bytes in all than ``none``; on the sub-mesh, each process
    hands over its local shard (no full tensor crosses pods).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeProfile as JShape
from repro.configs.base import reduced as jreduced
from repro.data.pipeline import SyntheticLMData as JData
from repro.models.model_zoo import Model as JModel
from repro.models import transformer as jtfm
from repro.optim.grad_compress import quantize_int8 as jquantize_int8
from repro.optim.grad_compress import sync_grads as jsync_grads
from repro_torch import _tree
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model_zoo import Model
from repro_torch.models.params import from_reference
from repro_torch.optim.grad_compress import quantize_int8, sync_grads
from repro_torch.parallel import _collectives as coll
from tests._torch_ranks import _tinyllama_run, run_ranks

METHODS = ("none", "bf16", "int8")
# replicated params at worlds 2 and 4; DTensor params on the pod sub-mesh
# at (pod, data, model) 2x1x2 and 2x2x2
MESHES = {2: (2, 1, 1), 4: (2, 2, 1), "2x1x2": (2, 1, 2),
          "2x2x2": (2, 2, 2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's plain steps, and each world's ranks
    (one launch per world size, every method in it)."""
    run = _tinyllama_run(2)
    jcfg = jreduced(jget_config("tinyllama-1.1b"), n_layers=2)
    jm = JModel(JRunConfig(model=jcfg, shape=JShape("t", 16, 8, "train"),
                           remat="none"))
    jp = jm.init_params(jax.random.PRNGKey(0))
    _, _, jmet = jax.jit(jm.train_step)(jp, jm.opt_init(jp),
                                        JData(jcfg, jm.run.shape).batch(0))
    params = from_reference(jax.tree.map(np.asarray, jp))
    model = Model(run)
    batch = SyntheticLMData(run.model, run.shape).batch(0)
    pp, _, pm = model.train_step(params, model.opt_init(params), batch)
    # the DTensor launches (tensor parallelism on the CPU) take longer
    # beside other launches under -n
    ranks = {w: run_ranks("grad_compress", math.prod(shape),
                          tmp_path_factory.mktemp(f"gc{w}"),
                          {"params": params, "mesh": shape},
                          timeout=120.0 if shape[2] == 1 else 300.0)
             for w, shape in MESHES.items()}
    # the reference's gradients of each process's rows (pod-major over
    # (pod, data)), then of each pod's: their mean over data
    jbatch = JData(jcfg, jm.run.shape).batch(0)
    grad = jax.jit(jax.grad(lambda p, b: jtfm.forward_train(
        jm.cfg, jm.run, p, b, jm.rules)[0]))
    ref_pods = {}
    for w, (n_pod, n_data, _) in MESHES.items():
        n = n_pod * n_data
        rows = [jax.tree.leaves(grad(jp, jax.tree.map(
            lambda x: x.reshape((n, -1) + x.shape[1:])[r], jbatch)))
            for r in range(n)]
        ref_pods[w] = [[np.mean([np.asarray(rows[p * n_data + d][i], np.float64)
                                 for d in range(n_data)], axis=0)
                        for i in range(len(rows[0]))] for p in range(n_pod)]
    return {"ref_loss": float(jmet["loss"]), "plain": pm, "plain_p": pp,
            "params": params, "ranks": ranks, "ref_pods": ref_pods}


def _ref_sync(pods, method):
    """The reference's ``sync_grads`` over ``pod`` on the pods' gradient
    leaves (one list per pod), each pod's result."""
    stacked = [jnp.stack([jnp.asarray(p[i].numpy()) for p in pods])
               for i in range(len(pods[0]))]
    out = jax.vmap(functools.partial(jsync_grads, axis_name="pod",
                                     method=method),
                   axis_name="pod")(stacked)
    return [[np.asarray(x[k]) for x in out] for k in range(len(pods))]


def _rounding(pods, method):
    """Per leaf, how far the wire format may move the pods' mean gradient
    elementwise: 0 for ``none``, 2^-8 of the mean of |g| for bf16 (round
    to nearest), half the mean of the pods' scales for int8."""
    out = []
    for leaves in zip(*pods):
        if method == "none":
            out.append(torch.zeros_like(leaves[0]))
        elif method == "bf16":
            out.append(2.0 ** -8 * torch.stack(leaves).abs().mean(0))
        else:
            out.append(torch.full_like(leaves[0], float(torch.stack(
                [quantize_int8(g)[1] for g in leaves]).mean()) / 2))
    return out


def adamw_first_step_ratio(a, b, lr):
    """The largest |a - b| of two params trees after one AdamW step from
    the same params, over its bound: each step moves an element by at most
    lr, so 2 lr, plus the rounding of the stored values."""
    ratio = 0.0
    for x, y in zip(_tree.tree_leaves(a), _tree.tree_leaves(b)):
        eps = torch.finfo(y.dtype).eps
        bound = 2 * lr * (1 + 1e-5) + eps * (y.float().abs() + 2 * lr)
        ratio = max(ratio, float(((x.float() - y.float()).abs()
                                  / bound).max()))
    return ratio


def test_quantize_int8_equals_the_reference():
    g = (np.random.default_rng(0).normal(size=(64, 64)) * 0.01).astype(
        np.float32)
    jq, js = jquantize_int8(jnp.asarray(g))
    q, s = quantize_int8(torch.from_numpy(g))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert abs(float(s) - float(js)) <= 1e-7 * abs(float(js))
    # the roundtrip error is bounded by scale/2 (tests/test_grad_compress.py)
    assert float((q.float() * s - torch.from_numpy(g)).abs().max()) <= \
        float(s) * 0.51


def test_sync_grads_on_one_rank():
    """On a world-1 mesh: ``none`` returns the gradients, ``bf16`` their
    bf16 rounding, ``int8`` its quantization (within scale/2)."""
    import torch.distributed as dist
    g = {"a": torch.from_numpy((np.random.default_rng(1).normal(
        size=(16, 8)) * 0.01).astype(np.float32)),
        "b": torch.linspace(-1, 1, 5)}
    try:
        mesh = make_host_mesh("cpu")
        coll.reset_counts()
        none = sync_grads(g, "data", "none", mesh)
        bf16 = sync_grads(g, "data", "bf16", mesh)
        int8 = sync_grads(g, "data", "int8", mesh)
    finally:
        dist.destroy_process_group()
    for k, v in g.items():
        assert torch.equal(none[k], v)
        assert torch.equal(bf16[k], v.bfloat16().float())
        _, s = quantize_int8(v)
        assert float((int8[k] - v).abs().max()) <= float(s) * 0.51
    assert coll.counts()["calls"] == {"psum": 2, "all_gather": 6}


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("method", METHODS)
def test_multipod_step_matches_the_plain_step(runs, world, method):
    ranks = runs["ranks"][world]
    m = [r[method]["metrics"] for r in ranks]
    # every process reports the same averaged metrics
    assert all(x == m[0] for x in m), m
    assert abs(m[0]["loss"] - runs["ref_loss"]) < 1e-3
    plain = {k: float(v) for k, v in runs["plain"].items()}
    if method == "none":
        assert abs(m[0]["loss"] - plain["loss"]) <= 1e-5 * plain["loss"]
        assert abs(m[0]["grad_norm"] - plain["grad_norm"]) <= \
            1e-4 * plain["grad_norm"]

    # one sync over pod per step; each pod's gradients are the
    # reference's of its rows
    assert all([s["axis"] for s in r[method]["syncs"]] == ["pod"]
               for r in ranks)
    n_pod = MESHES[world][0]
    pods = [next(r[method]["syncs"][0]["pre"] for r in ranks
                 if r["pod"] == p) for p in range(n_pod)]
    for r in ranks:
        for g, ref in zip(r[method]["syncs"][0]["pre"],
                          runs["ref_pods"][world][r["pod"]]):
            assert np.abs(g.numpy() - ref).max() <= \
                1e-4 * np.abs(ref).max() + 1e-12
    # the synced gradients: the reference's arithmetic on those, on every
    # process (on the sub-mesh, on each shard: what crosses pods is the
    # shard, so int8's scale is the shard's), and within the wire format's
    # rounding of their mean
    rounding = _rounding(pods, method)
    mean = [torch.stack(leaves).mean(0) for leaves in zip(*pods)]
    for r in ranks:
        same = [next(q[method]["syncs"][0]["pre_local"] for q in ranks
                     if q["pod"] == p and q["shard"] == r["shard"])
                for p in range(n_pod)]
        want = _ref_sync(same, method)[r["pod"]]
        for g, ref in zip(r[method]["syncs"][0]["synced_local"], want):
            assert np.abs(g.numpy() - ref).max() <= \
                1e-6 * np.abs(ref).max() + 1e-12
        synced = r[method]["syncs"][0]["synced"]
        for g, mu, b in zip(synced, mean, rounding):
            assert bool(((g - mu).abs() <= b * (1 + 1e-5)
                         + 1e-6 * mu.abs().max()).all())
    # the step clipped and applied those: its norm is theirs, and differs
    # from the plain step's by at most the norm of what the wire format
    # moved (the triangle inequality) and f32 noise
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in synced)))
    assert abs(m[0]["grad_norm"] - norm) <= 1e-5 * norm
    moved = float(torch.sqrt(sum(((g - mu).double() ** 2).sum()
                                 for g, mu in zip(synced, mean))))
    assert abs(m[0]["grad_norm"] - plain["grad_norm"]) <= \
        moved + 1e-4 * plain["grad_norm"]
    assert adamw_first_step_ratio(ranks[0][method]["params"],
                                  runs["plain_p"], plain["lr"]) <= 1.0


@pytest.mark.parametrize("world", list(MESHES))
def test_int8_wire_is_int8_and_smaller(runs, world):
    ranks = runs["ranks"][world]
    params = runs["params"]
    n_leaves = len(_tree.tree_leaves(params))
    for r in ranks:
        # this process's elements: every param's, or its local shards'
        n_elems = r["local_elems"]
        assert r["sharded"] == (MESHES[world][2] > 1)
        if r["sharded"]:
            assert n_elems < sum(p.numel() for p in _tree.tree_leaves(params))
        b = r["int8"]["counts"]["bytes"]
        gathered = {k: v for k, v in b.items() if k.startswith("all_gather")}
        assert gathered == {"all_gather/int8": n_elems,
                            "all_gather/float32": 4 * n_leaves}
        # the rest is f32: the data mean and the metrics (on the sub-mesh
        # also the vocab-split loss's sums and maxima over model)
        assert set(b) - set(gathered) <= {"psum/float32"} | (
            {"pmax/float32"} if r["sharded"] else set())
        assert sum(b.values()) < sum(r["none"]["counts"]["bytes"].values())
        assert r["bf16"]["counts"]["bytes"]["all_gather/bfloat16"] == \
            2 * n_elems
    # world 4 averages over data too, in f32
    if world == 4:
        assert ranks[0]["none"]["counts"]["bytes"]["psum/float32"] >= \
            2 * 4 * n_elems


@pytest.mark.parametrize("method", METHODS)
def test_plain_params_on_a_model_axis_are_refused(method):
    """Plain params on a mesh whose model axis is above 1 would compute
    the same rows on each of its processes: the step refuses them before
    any collective and names the DTensor layout."""
    from repro_torch.optim.grad_compress import multipod_train_step
    from repro_torch.parallel.sharding import Mesh
    model = Model(_tinyllama_run(2))
    params = model.init_params(torch.Generator().manual_seed(0))
    step = multipod_train_step(model, Mesh({"pod": 2, "data": 1,
                                            "model": 2}), method)
    with pytest.raises(ValueError, match="without"):
        step(params, model.opt_init(params), None)


@pytest.mark.parametrize("world", list(MESHES))
def test_opt_init_keeps_the_params_layout(runs, world):
    """``model.opt_init`` of the params as placed: on the sub-mesh each
    AdamW moment is a DTensor laid out as its param (this process's shard
    only, the placements ``opt_shardings`` names) and the step counter a
    replicated one; Adafactor's factored moments keep the param's split
    of every dim they keep. Plain params give plain state."""
    n_leaves = len(_tree.tree_leaves(runs["params"]))
    for r in runs["ranks"][world]:
        sharded, params = r["sharded"], r["param_layouts"]
        adam = r["opt_layouts"]
        assert len(adam) == 2 * n_leaves + 1
        assert adam[:n_leaves] == params and adam[n_leaves:-1] == params
        assert adam[-1][:3] == (sharded, (), ())
        if sharded:
            assert [a[3] for a in adam] == r["opt_sharding_placements"]
            assert all("Replicate" in pl and "Shard" not in pl
                       for pl in (adam[-1][3],))
            assert any(p[2] != p[1] for p in params)
        want = []
        for dt, shape, local, _ in params:
            if len(shape) >= 2:
                want += [(dt, shape[:-1], local[:-1]),
                         (dt, shape[:-2] + shape[-1:],
                          local[:-2] + local[-1:])]
            else:
                want.append((dt, shape, local))
        want.append((sharded, (), ()))
        assert [a[:3] for a in r["adafactor_layouts"]] == want


@pytest.mark.parametrize("world", list(MESHES))
def test_pod_mesh_groups_are_the_pods(runs, world):
    """``mesh.without("pod")``'s group over (data, model) sums over this
    pod's processes only (every process made every pod's group alike:
    one pod making its group alone crossed its rendezvous with the other
    pod's and hung the expert all-to-all on the sub-mesh); a sub-mesh
    made by hand refuses to make the group."""
    n_pod, n_data, n_model = MESHES[world]
    per_pod = n_data * n_model
    for r, out in enumerate(runs["ranks"][world]):
        pod = r // per_pod
        assert out["pod"] == pod
        assert out["pod_group_sum"] == sum(range(pod * per_pod,
                                                 (pod + 1) * per_pod))
        assert out["hand_sub_mesh_refused"]
