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


# ---------------------------------------------------------------------------
# The expert all-to-all (moe_manual_ep) across processes: gloo on the CPU,
# one launch of 4 ranks, meshes (data 4) and (pod 2 x data 2: two
# (data 2) expert groups, each over its pod's batch). Each rank holds its
# rows of the batch; the reference runs its ``moe`` (``moe_gshard`` for
# the gshard dispatch) on the whole batch of the group. Gradients are of
# sum(y * ct) + aux, each rank seeding its rows and aux / n.
# ---------------------------------------------------------------------------

EP_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3-671b")
EP_MESHES = ((1, 4, 1), (2, 2, 1))
EP_B, EP_S = 8, 32


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    from repro.configs import get_config as jget_config
    from repro.configs.base import reduced as jreduced
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from tests._torch_ranks import run_ranks
    cases, refs = [], {}
    for i, arch in enumerate(EP_ARCHS):
        jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
        jp = jinit_params(JM.moe_template(jcfg), jax.random.PRNGKey(i),
                          "float32")
        rng = np.random.default_rng(10 + i)
        x, ct = (rng.normal(size=(EP_B, EP_S, cfg.d_model)).astype(np.float32)
                 for _ in range(2))
        cases.append({"cfg": cfg, "x": torch.from_numpy(x),
                      "ct": torch.from_numpy(ct),
                      "params": from_reference(jax.tree.map(np.asarray, jp))})
        refs[arch] = (jcfg, jp)
    ranks = run_ranks("moe", 4, tmp_path_factory.mktemp("ep"),
                      {"cases": cases, "meshes": EP_MESHES})
    return {c["cfg"].name: c for c in cases}, refs, ranks


def _group_rows(shape, rank):
    """(the rows of the group's batch, this rank's rows within it)."""
    pods = shape[0]
    per_pod = EP_B // pods
    n = shape[1]
    p, d = divmod(rank, n)
    k = per_pod // n
    return slice(p * per_pod, (p + 1) * per_pod), slice(d * k, (d + 1) * k)


@pytest.mark.parametrize("impl", ["manual_ep", "sort", "gshard"])
@pytest.mark.parametrize("shape", EP_MESHES)
@pytest.mark.parametrize("arch", EP_ARCHS)
def test_moe_across_processes_matches_the_whole_batch(ep_runs, arch, shape,
                                                      impl):
    cases, refs, ranks = ep_runs
    case = cases[arch]
    cfg, p = case["cfg"], case["params"]
    jcfg, jp = refs[arch]
    jfn = JM.moe_gshard if impl == "gshard" else JM.moe
    n = shape[1]
    for pod in range(shape[0]):
        rows = _group_rows(shape, pod * n)[0]
        x, ct = case["x"][rows], case["ct"][rows]
        jy, jaux = jfn(jcfg, jp, jnp.asarray(x.numpy()), RULES)
        # the port's single-process layer on the whole batch: gradients
        xg = x.clone().requires_grad_()
        leaves = [t.detach().requires_grad_() for t in _tree.tree_leaves(p)]
        y, aux = M.moe(cfg, _tree.unflatten_like(p, leaves), xg)
        gx, *gp = torch.autograd.grad((y * ct).sum() + aux, [xg] + leaves,
                                      retain_graph=True)
        ga = torch.autograd.grad(aux, [xg] + leaves, allow_unused=True)
        outs = [ranks[r][(cfg.name, shape, impl)]
                for r in range(pod * n, (pod + 1) * n)]
        for d, out in enumerate(outs):
            mine = _group_rows(shape, pod * n + d)[1]
            np.testing.assert_allclose(out["y"].numpy(),
                                       np.asarray(jy)[mine], atol=ATOL)
            np.testing.assert_allclose(out["aux"], float(jaux), atol=ATOL)
            np.testing.assert_allclose(out["gx"].numpy(), gx[mine].numpy(),
                                       atol=ATOL)
            calls = out["counts"]["calls"]
            # forward and backward: two exchanges each way for manual_ep
            assert calls.get("all_to_all", 0) == (4 if impl == "manual_ep"
                                                  else 0)
        # the layer's gradients: each process's share, summed; sums over
        # the batch of entries up to ~10, so 1e-5 relative as well
        for i, g in enumerate(gp):
            got = sum(out["gp"][i] for out in outs)
            np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=1e-5,
                                       atol=ATOL)
        # the load-balance loss's own gradients (its statistics summed
        # over the processes), at 1e-5 of their largest entry: the rows'
        # and the router's (the only param it reaches)
        for d, out in enumerate(outs):
            mine = _group_rows(shape, pod * n + d)[1]
            want = ga[0][mine].numpy()
            np.testing.assert_allclose(out["ga"][0].numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        i = 1 + [k for k, _ in _named(p)].index("router")
        want = ga[i].numpy()
        got = sum(out["ga"][i] for out in outs).numpy()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def _named(tree, prefix=""):
    """(path, leaf) pairs in ``_tree.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _named(v, f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)]


def test_manual_ep_without_a_mesh_is_moe():
    """The reference's fallback: no mesh in use -> the sort dispatch."""
    _, cfg, _, p, x = _setup(n_experts=8, experts_per_token=2,
                             n_shared_experts=1)
    y1, a1 = M.moe_manual_ep(cfg, p, torch.from_numpy(x))
    y2, a2 = M.moe(cfg, p, torch.from_numpy(x))
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


# ---------------------------------------------------------------------------
# The manual_ep and gshard dispatches on DTensors (tensor parallelism, FSDP
# storage; the sort dispatch's are held by test_torch_tp.py): one launch
# of 4 ranks, the (data, model) sub-mesh of (pod 2, data 1, model 2) and of
# (pod 1, data 2, model 2); the layer's params placed by the fsdp rules,
# the batch split over data. Held to the reference's ``moe`` (for
# ``manual_ep``) and ``moe_gshard`` on the whole batch, forward and
# gradient (jax.grad of sum(y * ct) + aux), at the file's 1e-5.
# ---------------------------------------------------------------------------

DT_MESHES = ((2, 1, 2), (1, 2, 2))


@pytest.fixture(scope="module")
def dt_runs(ep_runs, tmp_path_factory):
    from tests._torch_ranks import run_ranks
    cases, refs, _ = ep_runs
    # DTensor dispatch on the CPU is slow beside other launches under -n
    ranks = run_ranks("moe_dtensor", 4, tmp_path_factory.mktemp("moedt"),
                      {"cases": list(cases.values()), "meshes": DT_MESHES},
                      timeout=300.0)
    return cases, refs, ranks


@pytest.mark.parametrize("impl", ["manual_ep", "gshard"])
@pytest.mark.parametrize("shape", DT_MESHES,
                         ids=[f"data{s[1]}-model{s[2]}" for s in DT_MESHES])
@pytest.mark.parametrize("arch", EP_ARCHS)
def test_moe_on_dtensors_matches_the_reference(dt_runs, arch, shape, impl):
    cases, refs, ranks = dt_runs
    case = cases[arch]
    cfg = case["cfg"]
    jcfg, jp = refs[arch]
    jfn = JM.moe_gshard if impl == "gshard" else JM.moe
    x, ct = (jnp.asarray(case[k].numpy()) for k in ("x", "ct"))

    def objective(p, x):
        y, aux = jfn(jcfg, p, x, RULES)
        return jnp.sum(y * ct) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True)(jp, x)
    n_ep = shape[1] * shape[2]
    for r in ranks:
        out = r[(cfg.name, shape, impl)]
        np.testing.assert_allclose(out["y"].numpy(), np.asarray(jy),
                                   atol=ATOL)
        np.testing.assert_allclose(out["aux"], float(jaux), atol=ATOL)
        np.testing.assert_allclose(out["gx"].numpy(), np.asarray(jgx),
                                   atol=ATOL)
        for (path, _), g, want in zip(_named(case["params"]), out["gp"],
                                      jax.tree.leaves(jgp)):
            np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=ATOL, err_msg=path)
        calls = out["counts"]["calls"]
        # manual_ep: two exchanges each way, forward and backward; the
        # other dispatches leave every collective to DTensor
        exchanges = 4 if impl == "manual_ep" and cfg.n_experts % n_ep == 0 \
            else 0
        assert calls.get("all_to_all", 0) == exchanges, calls
