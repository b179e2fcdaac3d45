"""GPipe over the pod axis on the port (``repro_torch.parallel.pipeline``)
held to the reference's test (``tests/test_pipeline.py``): gloo on the CPU,
``n_micro=4``, batch 8 x 16 tokens, f32, reduced tinyllama at 4 layers on
world 2 (pod 2: two stages of 2 layers, the reference test's case) and at
3 layers on world 3 (pod 3: a ring whose inverse is not itself, so a
``ppermute`` backward that did not invert its permutation would show),
and at 4 layers on world 4, (pod 2, data 1, model 2), with each pod's
stage slice and AdamW state as DTensors on its (data, model) sub-mesh
(``fsdp`` placements: tensor parallelism within the stage, the boundary
activation crossing pods as each process's shard). The reference's own
test of a model axis aborts in XLA's SPMD partitioner on this jax, so
the port is held to the reference's plain step.

Bounds: xent within 2e-3 of the reference's plain ``Model.train_step``
and the params within 5e-2 of its update (the reference test's bounds);
against the port's plain step on the same params, ``grad_norm`` within
rel 1e-4 (the pipelined gradients are the plain ones, not ``n_pods``
times them), each gradient leaf, read as the updated AdamW first moment
(0.1 x the clipped gradient), within rel 1e-4 of the plain step's leaf,
norm-wise, and the params within 1e-5; the rotation went through
``ppermute``. The params bound alone could not see a wrong gradient (a
first AdamW step moves each entry by about lr = 3e-6), nor could the
global norm see a wrong small leaf (a norm scale that missed its pod
sum): hence the per-leaf check.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeProfile as JShape
from repro.configs.base import reduced as jreduced
from repro.data.pipeline import SyntheticLMData as JData
from repro.models.model_zoo import Model as JModel
from repro_torch import _tree
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.model_zoo import Model
from repro_torch.models.params import from_reference
from tests._torch_ranks import _tinyllama_run, run_ranks


# case: ((pod, data, model), layers)
WORLDS = {2: ((2, 1, 1), 4), 3: ((3, 1, 1), 3), "2x1x2": ((2, 1, 2), 4)}


@pytest.fixture(scope="module", params=list(WORLDS))
def runs(request, tmp_path_factory):
    shape, n_layers = WORLDS[request.param]
    world = shape[0] * shape[1] * shape[2]
    run = _tinyllama_run(n_layers)
    jcfg = jreduced(jget_config("tinyllama-1.1b"), n_layers=n_layers)
    jm = JModel(JRunConfig(model=jcfg, shape=JShape("t", 16, 8, "train"),
                           remat="none"))
    jp = jm.init_params(jax.random.PRNGKey(0))
    jp2, _, jmet = jax.jit(jm.train_step)(jp, jm.opt_init(jp),
                                          JData(jcfg, jm.run.shape).batch(0))
    params = from_reference(jax.tree.map(np.asarray, jp))
    model = Model(run)
    batch = SyntheticLMData(run.model, run.shape).batch(0)
    pp, po, pm = model.train_step(params, model.opt_init(params), batch)
    ranks = run_ranks("pipeline", world, tmp_path_factory.mktemp("pp"),
                      {"params": params, "mesh": shape,
                       "n_layers": n_layers},
                      timeout=120.0 if shape[2] == 1 else 300.0)
    assert all(r["sharded"] == (shape[2] > 1) for r in ranks)
    return {"world": world, "pods": shape[0], "n_layers": n_layers,
            "ref": {k: float(v) for k, v in jmet.items()},
            "ref_p": from_reference(jax.tree.map(np.asarray, jp2)),
            "plain": {k: float(v) for k, v in pm.items()}, "plain_p": pp,
            "plain_mu": _tree.tree_leaves(po["mu"]),
            "mu_paths": [jax.tree_util.keystr(k) for k, _ in
                         jax.tree_util.tree_flatten_with_path(
                             jm.opt_init(jp)["mu"])[0]],
            "ranks": ranks}


def _max_err(a, b):
    return max(float((x - y).abs().max())
               for x, y in zip(_tree.tree_leaves(a), _tree.tree_leaves(b)))


def test_pipeline_xent_matches_the_reference_plain_step(runs):
    m = [r["metrics"] for r in runs["ranks"]]
    assert all(x == m[0] for x in m)     # every pod reports the summed loss
    assert abs(m[0]["xent"] - runs["ref"]["xent"]) < 2e-3
    assert abs(m[0]["loss"] - runs["plain"]["loss"]) <= \
        1e-5 * runs["plain"]["loss"]


def test_pipeline_gradients_are_the_plain_steps(runs):
    m = runs["ranks"][0]["metrics"]
    assert abs(m["grad_norm"] - runs["plain"]["grad_norm"]) <= \
        1e-4 * runs["plain"]["grad_norm"]


def test_each_gradient_leaf_is_the_plain_steps(runs):
    """Each leaf's first moment after the step, gathered, on every
    process, against the plain step's: the pod sum of the replicated
    leaves, the stage leaves that stay on their pod, the redistribution
    of each gradient to its param's layout, leaf by leaf."""
    for r in runs["ranks"]:
        assert len(r["mu"]) == len(runs["plain_mu"]) == len(runs["mu_paths"])
        for path, got, want in zip(runs["mu_paths"], r["mu"],
                                   runs["plain_mu"]):
            scale = float(want.norm())
            assert scale > 0, path
            assert float((got - want).norm()) <= 1e-4 * scale, \
                (path, float((got - want).norm()) / scale)


def test_pipeline_params_match_both_plain_steps(runs):
    for r in runs["ranks"]:
        assert _max_err(r["params"], runs["ref_p"]) < 5e-2
        assert _max_err(r["params"], runs["plain_p"]) <= 1e-5


def test_plain_params_on_a_model_axis_are_refused():
    """Plain params on a mesh whose model axis is above 1 would compute
    the same rows on each of its processes: the step refuses them before
    any collective and names the DTensor layout."""
    from repro_torch.parallel.pipeline import pipeline_train_step
    from repro_torch.parallel.sharding import Mesh
    model = Model(_tinyllama_run(4))
    params = model.init_params(torch.Generator().manual_seed(0))
    step = pipeline_train_step(model, Mesh({"pod": 2, "data": 1,
                                            "model": 2}), n_micro=4)
    with pytest.raises(ValueError, match="without"):
        step(params, model.opt_init(params), None)


def test_each_pod_holds_its_layers_and_rotates_by_ppermute(runs):
    n = runs["pods"]
    ticks = 4 + n - 1
    for r in runs["ranks"]:
        assert r["local_layers"] == runs["n_layers"] // n
        # one rotation a tick forward; the backward of all but the last
        assert r["counts"]["calls"]["ppermute"] == 2 * ticks - 1
        assert r["counts"]["bytes"]["ppermute/float32"] == \
            (2 * ticks - 1) * 2 * 16 * 64 * 4
