"""The port's optimizers and schedule (``repro_torch.optim``) held against
``repro.optim`` on the same numpy inputs, and the scenarios of
``tests/test_optim.py`` run on the port.

Tolerances: one AdamW or Adafactor update at rtol 1e-6 (both run the same
float32 ops; ``pow`` and ``sqrt`` may round a last bit apart); the
schedule bit for bit (the same float32 ops in the same order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro.optim.schedules import cosine_schedule as jcosine
from repro_torch import _tree
from repro_torch.optim import (adafactor_init, adafactor_update, adamw_init,
                               adamw_update, clip_by_global_norm,
                               cosine_schedule, global_norm, make_optimizer)

RTOL = 1e-6


def quadratic_params():
    return {"w": torch.tensor([[3.0, -2.0], [1.5, 0.5]]),
            "b": torch.tensor([1.0, -1.0])}


def quad_grad(p):
    return {k: 2 * v for k, v in p.items()}


def loss_fn(p):
    return float(torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2))


def test_adamw_converges_on_quadratic():
    p = quadratic_params()
    s = adamw_init(p)
    for _ in range(300):
        p, s = adamw_update(p, quad_grad(p), s, lr=0.05, weight_decay=0.0)
    assert loss_fn(p) < 1e-3


def test_adafactor_converges_on_quadratic():
    p = quadratic_params()
    s = adafactor_init(p)
    for _ in range(300):
        p, s = adafactor_update(p, quad_grad(p), s, lr=0.05)
    assert loss_fn(p) < 1e-2


def test_adamw_first_step_matches_hand_computed():
    p = {"w": torch.tensor([[1.0]])}
    g = {"w": torch.tensor([[0.5]])}
    s = adamw_init(p)
    newp, s2 = adamw_update(p, g, s, lr=0.1, b1=0.9, b2=0.95, eps=1e-8,
                            weight_decay=0.0)
    mu_hat = 0.1 * 0.5 / (1 - 0.9)
    nu_hat = 0.05 * 0.25 / (1 - 0.95)
    expected = 1.0 - 0.1 * (mu_hat / (np.sqrt(nu_hat) + 1e-8))
    np.testing.assert_allclose(float(newp["w"][0, 0]), expected, rtol=1e-6)
    assert int(s2["step"]) == 1 and s2["step"].dtype == torch.int32


def test_weight_decay_only_on_matrices():
    p = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    g = {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}
    newp, _ = adamw_update(p, g, adamw_init(p), lr=0.1, weight_decay=0.5)
    assert float(newp["w"][0, 0]) < 1.0
    np.testing.assert_allclose(newp["b"].numpy(), 1.0)


def test_updates_are_functional():
    """The params and state handed in are never written (MDSS values)."""
    p = quadratic_params()
    keep = _tree.tree_map(torch.clone, p)
    s = adamw_init(p)
    s_keep = _tree.tree_map(torch.clone, s)
    adamw_update(p, quad_grad(p), s, lr=0.1)
    for a, b in zip(_tree.tree_leaves((p, s)), _tree.tree_leaves((keep,
                                                                    s_keep))):
        assert torch.equal(a, b)


def test_adafactor_state_is_factored():
    s = adafactor_init({"w": torch.ones((8, 16)), "b": torch.ones((16,))})
    assert s["v"]["w"]["vr"].shape == (8,)
    assert s["v"]["w"]["vc"].shape == (16,)
    assert s["v"]["b"]["v"].shape == (16,)
    s2 = adafactor_init({"w": torch.ones((4, 8, 16))})
    assert s2["v"]["w"]["vr"].shape == (4, 8)
    assert s2["v"]["w"]["vc"].shape == (4, 16)


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), 10.0)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    clipped2, _ = clip_by_global_norm(g, 100.0)
    np.testing.assert_allclose(clipped2["a"].numpy(), 3.0)


def test_bf16_state_dtype():
    p = {"w": torch.ones((4, 4))}
    s = adamw_init(p, state_dtype="bfloat16")
    assert s["mu"]["w"].dtype == torch.bfloat16
    newp, s2 = adamw_update(p, {"w": torch.full((4, 4), 0.1)}, s, lr=0.01)
    assert s2["mu"]["w"].dtype == torch.bfloat16
    assert newp["w"].dtype == torch.float32


# ---------------------------------------------------------------- vs the JAX
def _tree_np(rng):
    """Params and grads of mixed rank, as numpy f32 (a stacked 3-D leaf, a
    matrix and a vector)."""
    shapes = {"stage": {"w": (3, 8, 6)}, "m": (5, 7), "b": (7,)}
    mk = lambda s: rng.normal(size=s).astype(np.float32)
    return (jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple)),
            jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple)))


def _to_torch(tree, dtype=None):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
            dtype or torch.float32), tree)


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _pairs(got, want):
    """(port leaf, reference leaf) by key path: ``jax.tree`` walks dicts in
    sorted key order, the port in insertion order."""
    jl = jax.tree_util.tree_leaves_with_path(want)
    assert len(jl) == len(_tree.tree_leaves(got))
    return [(_at(got, path), leaf) for path, leaf in jl]


def _close(got, want):
    for t, j in _pairs(got, want):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), rtol=RTOL)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_update_matches_reference(name, state_dtype):
    """Two updates from the same params, grads and lr: params and state
    within rtol 1e-6 of the reference's."""
    rng = np.random.default_rng(0)
    p_np, g_np = _tree_np(rng)
    jinit, jupd = jopt.make_optimizer(name, state_dtype=state_dtype,
                                      weight_decay=0.1)
    tinit, tupd = make_optimizer(name, state_dtype=state_dtype,
                                 weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = _to_torch(p_np)
    js, ts = jinit(jp), tinit(tp)
    for k, lr in enumerate((1e-3, 3e-4)):
        g = jax.tree.map(lambda a: a * (k + 1), g_np)
        jp, js = jupd(jp, jax.tree.map(jnp.asarray, g), js,
                      lr=jnp.float32(lr))
        tp, ts = tupd(tp, _to_torch(g), ts, lr=torch.tensor(lr))
        _close(tp, jp)
        _close({k2: v for k2, v in ts.items() if k2 != "step"},
               {k2: v for k2, v in js.items() if k2 != "step"})
        assert int(ts["step"]) == int(js["step"]) == k + 1


def test_bf16_params_update_matches_reference():
    rng = np.random.default_rng(1)
    p_np, g_np = _tree_np(rng)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p_np)
    jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g_np)
    tp = _to_torch(p_np, torch.bfloat16)
    tg = _to_torch(g_np, torch.bfloat16)
    jp2, _ = jopt.adamw_update(jp, jg, jopt.adamw_init(jp), lr=jnp.float32(
        1e-2))
    tp2, _ = adamw_update(tp, tg, adamw_init(tp), lr=torch.tensor(1e-2))
    for t, j in _pairs(tp2, jp2):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))


def test_clip_matches_reference():
    rng = np.random.default_rng(2)
    _, g_np = _tree_np(rng)
    for max_norm in (0.5, 1e3):
        jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g_np),
                                          max_norm)
        tc, tn = clip_by_global_norm(_to_torch(g_np), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
        _close(tc, jc)


@pytest.mark.parametrize("step", [0, 1, 99, 100, 5000, 10000])
def test_cosine_schedule_matches_reference(step):
    j = jcosine(3e-4)(jnp.int32(step))
    t = cosine_schedule(3e-4)(torch.tensor(step, dtype=torch.int32))
    assert t.dtype == torch.float32
    assert np.float32(t.item()) == np.float32(j), (t.item(), float(j))
