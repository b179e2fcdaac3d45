"""GPipe over the pod axis on the port (``repro_torch.parallel.pipeline``)
held to the reference's test (``tests/test_pipeline.py``): gloo on the CPU,
``n_micro=4``, batch 8 x 16 tokens, f32, reduced tinyllama at 4 layers on
world 2 (pod 2: two stages of 2 layers, the reference test's case) and at
3 layers on world 3 (pod 3: a ring whose inverse is not itself, so a
``ppermute`` backward that did not invert its permutation would show).

Bounds: xent within 2e-3 of the reference's plain ``Model.train_step``
and the params within 5e-2 of its update (the reference test's bounds);
against the port's plain step on the same params, ``grad_norm`` within
rel 1e-4 (the pipelined gradients are the plain ones, not ``n_pods``
times them) and the params within 1e-5; the rotation went through
``ppermute``.
"""
import jax
import numpy as np
import pytest

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


WORLDS = {2: 4, 3: 3}      # pods: layers


@pytest.fixture(scope="module", params=sorted(WORLDS))
def runs(request, tmp_path_factory):
    world, n_layers = request.param, WORLDS[request.param]
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
    pp, _, pm = model.train_step(params, model.opt_init(params), batch)
    ranks = run_ranks("pipeline", world, tmp_path_factory.mktemp("pp"),
                      {"params": params, "mesh": (world, 1, 1),
                       "n_layers": n_layers})
    return {"world": world, "n_layers": n_layers,
            "ref": {k: float(v) for k, v in jmet.items()},
            "ref_p": from_reference(jax.tree.map(np.asarray, jp2)),
            "plain": {k: float(v) for k, v in pm.items()}, "plain_p": pp,
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


def test_pipeline_params_match_both_plain_steps(runs):
    full = runs["ranks"][0]["params"]
    assert _max_err(full, runs["ref_p"]) < 5e-2
    assert _max_err(full, runs["plain_p"]) <= 1e-5


def test_each_pod_holds_its_layers_and_rotates_by_ppermute(runs):
    n = runs["world"]
    ticks = 4 + n - 1
    for r in runs["ranks"]:
        assert r["local_layers"] == runs["n_layers"] // n
        # one rotation a tick forward; the backward of all but the last
        assert r["counts"]["calls"]["ppermute"] == 2 * ticks - 1
        assert r["counts"]["bytes"]["ppermute/float32"] == \
            (2 * ticks - 1) * 2 * 16 * 64 * 4
