"""The port's train step held against the JAX package's on the CPU, at
reduced size (2 layers, d_model 64, f32), from the same params (the
reference's ``init_params``, converted) and the same batches (bit
identical, ``test_torch_data.py``):

  * ``Model.train_step`` for tinyllama (flash attention) and falcon-mamba
    (the selective scan): loss at rtol 1e-5, grad_norm at 1e-4, and every
    updated leaf within 2 lr_1 absolute (lr_1, the first step's learning
    rate, is the most a sign flip of a near-zero gradient can move a first
    AdamW step; measured differences are ~1e-7);
  * grad accumulation against the full batch (``tests/test_grad_accum.py``'s
    1e-5) and ``remat="full"`` against ``"none"`` (bitwise: the recompute
    runs the same ops on the same inputs).

The ``Trainer`` is held against the reference in ``test_torch_trainer.py``.
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
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.model_zoo import Model
from repro_torch.models.params import from_reference


def _runs(arch, S, B, **kw):
    jcfg = jreduced(jget_config(arch), n_layers=2)
    cfg = reduced(get_config(arch), n_layers=2)
    return (JRunConfig(model=jcfg, shape=JShape("t", S, B, "train"), **kw),
            RunConfig(model=cfg, shape=ShapeProfile("t", S, B, "train"), **kw))


def _ref_params(jrun, seed=0):
    jp = JModel(jrun).init_params(jax.random.PRNGKey(seed))
    return jp, from_reference(jax.tree.map(np.asarray, jp))


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _max_leaf_diff(tp, jp):
    return max(float(np.max(np.abs(_at(tp, path).float().numpy()
                                   - np.asarray(leaf, np.float32))))
               for path, leaf in jax.tree_util.tree_leaves_with_path(jp))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "falcon-mamba-7b"])
def test_train_step_matches_reference(arch):
    jrun, run = _runs(arch, 32, 4, remat="none")
    jm, m = JModel(jrun), Model(run)
    jp, p = _ref_params(jrun)
    jb = JData(jrun.model, jrun.shape).batch(0)
    b = SyntheticLMData(run.model, run.shape).batch(0)
    jp2, jo2, jmet = jax.jit(jm.train_step)(jp, jm.opt_init(jp), jb)
    p2, o2, met = m.train_step(p, m.opt_init(p), b)
    assert list(met) == ["xent", "aux", "loss", "grad_norm", "lr"]
    assert set(met) == set(jmet)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    lr1 = float(jmet["lr"])
    assert float(met["lr"]) == lr1
    assert _max_leaf_diff(p2, jp2) <= 2 * lr1
    assert _max_leaf_diff({"mu": o2["mu"], "nu": o2["nu"]},
                          {"mu": jo2["mu"], "nu": jo2["nu"]}) <= 1e-5
    assert int(o2["step"]) == 1 and o2["step"].dtype == torch.int32


def test_train_step_leaves_its_inputs_alone():
    """The params and state handed in are MDSS values: never written,
    never given ``requires_grad``."""
    _, run = _runs("tinyllama-1.1b", 16, 2, remat="full")
    m = Model(run)
    p = m.init_params(torch.Generator().manual_seed(0))
    o = m.opt_init(p)
    keep = _tree.host_copy((p, o))
    m.train_step(p, o, SyntheticLMData(run.model, run.shape).batch(0))
    for a, b in zip(_tree.tree_leaves((p, o)), _tree.tree_leaves(keep)):
        assert torch.equal(a, b) and not a.requires_grad


@pytest.mark.parametrize("n,S,B", [(2, 32, 4), (4, 16, 8)])
def test_grad_accum_matches_full_batch(n, S, B):
    """``grad_accum=n`` against the full-batch step (float32 sums, divided
    by n): loss at rtol 1e-5, params within 1e-5, as the reference's."""
    _, run = _runs("tinyllama-1.1b", S, B, remat="none")
    m1, mn = Model(run), Model(run.with_(grad_accum=n))
    p = m1.init_params(torch.Generator().manual_seed(n))
    batch = SyntheticLMData(run.model, run.shape).batch(0)
    p1, _, met1 = m1.train_step(p, m1.opt_init(p), batch)
    pn, _, metn = mn.train_step(p, mn.opt_init(p), batch)
    np.testing.assert_allclose(float(metn["loss"]), float(met1["loss"]),
                               rtol=1e-5)
    err = max(float((a - b).abs().max()) for a, b in
              zip(_tree.tree_leaves(p1), _tree.tree_leaves(pn)))
    assert err < 1e-5, f"accumulated update diverges: {err}"


def test_grad_accum_matches_reference():
    """The accumulated step against the reference's (its scan over
    microbatches), from the same params."""
    jrun, run = _runs("falcon-mamba-7b", 16, 4, remat="none", grad_accum=2)
    jm, m = JModel(jrun), Model(run)
    jp, p = _ref_params(jrun, seed=3)
    jb = JData(jrun.model, jrun.shape).batch(2)
    jp2, _, jmet = jax.jit(jm.train_step)(jp, jm.opt_init(jp), jb)
    p2, _, met = m.train_step(p, m.opt_init(p),
                              SyntheticLMData(run.model, run.shape).batch(2))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    assert _max_leaf_diff(p2, jp2) <= 2 * float(jmet["lr"])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "falcon-mamba-7b"])
@pytest.mark.parametrize("remat", ["full", "dots_saveable"])
def test_remat_matches_no_remat_bitwise(arch, remat):
    _, run = _runs(arch, 32, 2, remat="none")
    m0, m1 = Model(run), Model(run.with_(remat=remat))
    p = m0.init_params(torch.Generator().manual_seed(1))
    batch = SyntheticLMData(run.model, run.shape).batch(1)
    out0 = m0.train_step(p, m0.opt_init(p), batch)
    out1 = m1.train_step(p, m1.opt_init(p), batch)
    for a, b in zip(_tree.tree_leaves(out0), _tree.tree_leaves(out1)):
        assert torch.equal(a, b)


def test_eval_loss_matches_reference():
    jrun, run = _runs("tinyllama-1.1b", 32, 2)
    jp, p = _ref_params(jrun, seed=4)
    jmet = JModel(jrun).eval_loss(jp, JData(jrun.model, jrun.shape).batch(3))
    met = Model(run).eval_loss(p, SyntheticLMData(run.model,
                                                  run.shape).batch(3))
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5)


def test_serve_forward_unchanged_under_grad():
    """The stage loop's unbind gives the same forward as indexing: the
    train forward's logits with and without grad mode, bitwise."""
    from repro_torch.models import transformer as tfm
    _, run = _runs("tinyllama-1.1b", 16, 2, remat="none")
    m = Model(run)
    p = m.init_params(torch.Generator().manual_seed(2))
    batch = SyntheticLMData(run.model, run.shape).batch(0)
    with torch.no_grad():
        a = tfm.forward_train(run.model, run, p, batch)[0]
    with torch.enable_grad():
        b = tfm.forward_train(run.model, run, p, batch)[0]
    assert torch.equal(a, b.detach())
