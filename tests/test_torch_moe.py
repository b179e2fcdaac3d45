"""The port's MoE (``repro_torch.models.moe``) held against the reference's
``repro.models.moe`` on the same params (the reference's ``init_params``,
converted) and the same numpy inputs, in f32 on the CPU; and the
reference's own MoE checks (``tests/test_models.py``) on the port.

Tolerance: 1e-5 absolute, the reference's sort-vs-gshard bound (the two
frameworks sum the expert products in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import moe as JM
from repro.models.params import init_params as jinit_params
from repro.parallel.sharding import get_rules
from repro_torch import _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as M
from repro_torch.models.params import from_reference

RULES = get_rules("fsdp")
ATOL = 1e-5
CASES = [(8, 2, 0), (8, 2, 1), (4, 1, 2), (6, 3, 0)]


def _cfgs(**kw):
    base = dict(name="m", family="moe", n_layers=1, d_model=16, n_heads=2,
                n_kv_heads=0, d_ff=0, vocab_size=16, n_experts=8,
                experts_per_token=2, moe_d_ff=8, dtype="float32",
                param_dtype="float32")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _setup(seed=0, shape=(2, 16), **kw):
    jcfg, cfg = _cfgs(**kw)
    jp = jinit_params(JM.moe_template(jcfg), jax.random.PRNGKey(seed),
                      "float32")
    x = np.random.default_rng(seed + 1).normal(
        size=shape + (cfg.d_model,)).astype(np.float32)
    return jcfg, cfg, jp, from_reference(jax.tree.map(np.asarray, jp)), x


def _reference_keep(jcfg, idx):
    """The reference's kept assignments: an assignment is kept when fewer
    than C earlier ones (in token-major order) went to its expert, as
    ``moe_gshard`` counts them (the reference's tests hold ``moe`` to
    it)."""
    G, Tg, K = idx.shape
    C = JM._capacity(jcfg, Tg)
    flat = jax.nn.one_hot(idx, jcfg.n_experts).reshape(G, Tg * K, -1)
    pos = jnp.einsum("gne,gne->gn", jnp.cumsum(flat, 1) - flat, flat)
    return np.asarray(pos < C).reshape(G, Tg, K)


@pytest.mark.parametrize("impl", ["sort", "gshard"])
@pytest.mark.parametrize("E,K,shared", CASES)
def test_moe_matches_reference(E, K, shared, impl):
    """Output, routing (idx, gates), kept assignments and aux equal the
    reference's."""
    jcfg, cfg, jp, p, x = _setup(n_experts=E, experts_per_token=K,
                                 n_shared_experts=shared)
    jfn = {"sort": JM.moe, "gshard": JM.moe_gshard}[impl]
    jy, jaux = jfn(jcfg, jp, jnp.asarray(x), RULES)
    y, aux = M.MOE_IMPLS[impl](cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL)
    G, Tg = M._grouping(x.shape[0] * x.shape[1])
    assert (G, Tg) == JM._grouping(x.shape[0] * x.shape[1])
    assert M._capacity(cfg, Tg) == JM._capacity(jcfg, Tg)
    xt = x.reshape(G, Tg, -1)
    jprobs, jgate, jidx = JM._route(jcfg, jp, jnp.asarray(xt))
    probs, gate, idx = M._route(cfg, p, torch.from_numpy(xt))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), atol=ATOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=ATOL)
    _, keep, _, _ = M._dispatch(idx, E, M._capacity(cfg, Tg))
    np.testing.assert_array_equal(keep.reshape(G, Tg, K).numpy(),
                                  _reference_keep(jcfg, jidx))


@pytest.mark.parametrize("E,K,shared", CASES)
def test_moe_sort_matches_gshard(E, K, shared):
    _, cfg, _, p, x = _setup(n_experts=E, experts_per_token=K,
                             n_shared_experts=shared)
    y1, a1 = M.moe(cfg, p, torch.from_numpy(x))
    y2, a2 = M.moe_gshard(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
    assert abs(float(a1 - a2)) < 1e-7


def test_moe_capacity_drops_tokens_consistently():
    """The reference's congestion case: both dispatches agree, and equal
    the reference's output."""
    jcfg, cfg, jp, p, x = _setup(seed=2, shape=(1, 32), n_experts=2,
                                 experts_per_token=2)
    xt = torch.from_numpy(x)
    y1, _ = M.moe(cfg, p, xt)
    y2, _ = M.moe_gshard(cfg, p, xt)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
    jy, _ = JM.moe(jcfg, jp, jnp.asarray(x), RULES)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy), atol=ATOL)


@pytest.mark.parametrize("impl", ["sort", "gshard"])
def test_moe_capacity_binds_and_drops_the_reference_assignments(impl):
    """One group of 33 tokens whose router favours expert 0: more
    assignments reach it than its capacity, and the port drops exactly
    the reference's (its output and kept set equal the reference's)."""
    jcfg, cfg, jp, p, x = _setup(seed=3, shape=(1, 33), n_experts=4,
                                 experts_per_token=2, n_shared_experts=1)
    x = np.abs(x) + 0.5
    router = np.asarray(jp["router"]).copy()
    router[:, 0] += 1.0
    jp = dict(jp, router=jnp.asarray(router))
    p = dict(p, router=torch.from_numpy(router))
    G, Tg = M._grouping(33)
    C = M._capacity(cfg, Tg)
    _, _, idx = M._route(cfg, p, torch.from_numpy(x).reshape(G, Tg, -1))
    _, keep, _, _ = M._dispatch(idx, cfg.n_experts, C)
    want = _reference_keep(jcfg, jnp.asarray(idx.numpy()))
    assert (G, Tg) == (1, 33) and int((idx == 0).sum()) > C
    assert 0 < int((~want).sum()), "capacity must bind in this case"
    np.testing.assert_array_equal(keep.reshape(want.shape).numpy(), want)
    jfn = {"sort": JM.moe, "gshard": JM.moe_gshard}[impl]
    jy, jaux = jfn(jcfg, jp, jnp.asarray(x), RULES)
    y, aux = M.MOE_IMPLS[impl](cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL)


def test_moe_grad_finite():
    _, cfg, _, p, x = _setup(shape=(2, 8), n_shared_experts=1)
    p = _tree.tree_map(lambda t: t.requires_grad_(), p)
    y, aux = M.moe(cfg, p, torch.from_numpy(x))
    (y.square().sum() + aux).backward()
    for t in _tree.tree_leaves(p):
        assert t.grad is not None and torch.isfinite(t.grad).all()


def test_moe_aux_loss_uniform_router_is_one():
    """With perfectly uniform routing, Switch aux = weight * K; ties in
    the top-k go to the lower expert index, as the reference's."""
    jcfg, cfg, jp, p, x = _setup(shape=(2, 64), router_aux_weight=1.0)
    p = dict(p, router=torch.zeros_like(p["router"]))
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    _, aux = M.moe(cfg, p, torch.from_numpy(x))
    _, jaux = JM.moe(jcfg, jp, jnp.asarray(x), RULES)
    assert abs(float(aux) - cfg.experts_per_token) < 0.3
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL)
