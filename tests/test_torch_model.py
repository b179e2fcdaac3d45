"""The port's LMs held against the JAX package's ``Model`` on the same
params (converted from the reference's ``init_params``) and the same numpy
tokens, at reduced size on the CPU in f32: dense tinyllama and Mamba-only
falcon-mamba in depth here, every architecture's template and params, and
the caches of every cache kind (``tests/test_torch_archs.py`` holds all
ten architectures' serve and train steps).

Tolerance: 1e-4 absolute on logits and caches of a whole f32 model (the
two frameworks sum in different orders; measured differences are ~2e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeProfile as JShape
from repro.configs.base import reduced as jreduced
from repro.data.pipeline import SyntheticLMData
from repro.models.model_zoo import Model as JModel
from repro.models.transformer import model_template as jmodel_template
from repro_torch import _tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
from repro_torch.data.pipeline import SyntheticLMData as TSyntheticLMData
from repro_torch.models import transformer
from repro_torch.models.model_zoo import Model
from repro_torch.models.params import from_reference

S, B = 32, 2
ATOL = 1e-4


def _pair(seed=0, arch="tinyllama-1.1b", run_kw=None, **over):
    run_kw = run_kw or {}
    jcfg = jreduced(jget_config(arch), **over)
    jrun = JRunConfig(model=jcfg, shape=JShape("d", S, B, "decode"),
                      remat="none", **run_kw)
    jm = JModel(jrun)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    cfg = reduced(get_config(arch), **over)
    m = Model(RunConfig(model=cfg, shape=ShapeProfile("d", S, B, "decode"),
                        remat="none", **run_kw))
    return jm, jp, m, from_reference(jax.tree.map(np.asarray, jp))


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _tokens(n):
    jcfg = jreduced(jget_config("tinyllama-1.1b"))
    data = SyntheticLMData(jcfg, JShape("t", S, B, "train"))
    return np.array(data.batch(0)["tokens"][:, :n])


def test_configs_are_copies_of_the_reference():
    from repro.configs import ARCH_IDS as JIDS
    assert ARCH_IDS == JIDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_from_reference_keeps_keys_shapes_and_values(arch):
    jm, jp, m, p = _pair(arch=arch)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == len(_tree.tree_leaves(p))
    for path, leaf in jl:
        t = p
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    # the port's own template has the same tree
    spec = m.template
    assert jax.tree.structure(jax.tree.map(lambda s: 0, jm.template,
                                           is_leaf=lambda x: hasattr(x, "axes"))) \
        == jax.tree.structure(_tree.tree_map(lambda s: 0, spec))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b",
                                  "seamless-m4t-medium", "deepseek-v3-671b"])
def test_from_reference_keeps_a_bf16_tree_bit_exact(arch):
    """A bf16 model's params (the router, the SSM's A_log, dt_bias and D
    in f32): every leaf keeps the reference's dtype and bits (stacked
    experts, MLA projections, encoder, cross-attention, MTP head)."""
    jm, jp, m, p = _pair(arch=arch, param_dtype="bfloat16", dtype="bfloat16")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t, a = _leaf(p, path), np.asarray(leaf)
        assert t.dtype == _tree.from_numpy(a).dtype
        assert t.dtype == (torch.float32 if a.dtype == np.float32
                           else torch.bfloat16)
        np.testing.assert_array_equal(
            t.view(torch.int16 if t.dtype == torch.bfloat16
                   else torch.int32).numpy(),
            a.view(np.int16 if t.dtype == torch.bfloat16 else np.int32))
    assert _tree.tree_map(lambda t: t.dtype, m.init_params(
        torch.Generator().manual_seed(0))) == \
        _tree.tree_map(lambda t: t.dtype, p)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "jamba-v0.1-52b"])
def test_bf16_init_is_the_f32_draw_rounded_bit_exact(arch):
    """``init_params`` rounds each f32 draw to the param dtype before it
    moves it: every leaf's bits equal the same seed's f32 draw cast by
    ``.to(device, dtype)`` (the order it replaced), leaves that keep f32
    (the SSM's) included."""
    def draw(param_dtype):
        cfg = reduced(get_config(arch), param_dtype=param_dtype,
                      dtype=param_dtype)
        m = Model(RunConfig(model=cfg, shape=ShapeProfile("d", S, B,
                                                          "decode")))
        return m.init_params(torch.Generator().manual_seed(3), device="cpu")
    p16, p32 = draw("bfloat16"), draw("float32")
    leaves16, leaves32 = _tree.tree_leaves(p16), _tree.tree_leaves(p32)
    assert len(leaves16) == len(leaves32)
    assert any(t.dtype == torch.bfloat16 for t in leaves16)
    for t, f in zip(leaves16, leaves32):
        want = f.to("cpu", t.dtype)
        bits = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(t.view(bits), want.view(bits))


def test_from_reference_bfloat16_is_bit_exact():
    x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    jb = np.asarray(jnp.asarray(x, jnp.bfloat16))        # ml_dtypes bf16
    t = from_reference({"w": jb})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), jb.astype(np.float32))
    assert torch.equal(t, torch.from_numpy(x).to(torch.bfloat16))


def _prefill_and_decode_match_reference(arch):
    jm, jp, m, p = _pair(arch=arch)
    toks = _tokens(12)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache())
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(toks)},
                       m.init_cache())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for (path, leaf) in jax.tree_util.tree_leaves_with_path(jc):
        t = _leaf(tc, path)
        assert t.dtype == _tree.from_numpy(np.asarray(leaf)).dtype
        np.testing.assert_allclose(t.numpy(), np.asarray(leaf), atol=ATOL)
    jstep = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jl, -1)
    ttok = torch.argmax(tl, -1).to(torch.int32)
    for _ in range(4):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jstep(jp, jtok, jc)
        tl, tc = m.decode_step(p, ttok, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        jtok = jnp.argmax(jl, -1)
        ttok = torch.argmax(tl, -1).to(torch.int32)
    # every cache leaf (k, v / h, conv; pos) after the decode steps
    for (path, leaf) in jax.tree_util.tree_leaves_with_path(jc):
        np.testing.assert_allclose(_leaf(tc, path).numpy(), np.asarray(leaf),
                                   atol=ATOL)
    assert transformer.cache_position(tc) == 16


def test_prefill_caches_and_decode_match_reference():
    _prefill_and_decode_match_reference("tinyllama-1.1b")


def test_mamba_prefill_caches_and_decode_match_reference():
    """Reduced falcon-mamba: logits, every cache leaf (h, conv, pos) and
    4 greedy decode steps through the Mamba state and conv caches."""
    _prefill_and_decode_match_reference("falcon-mamba-7b")


def test_decode_prefill_consistency_ssm():
    """The port's version of test_arch_smoke's SSM check: one decode
    step through the Mamba state and conv caches matches a fresh prefill
    over the longer sequence (the reference's atol/rtol 2e-3)."""
    _, _, m, p = _pair(seed=1, arch="falcon-mamba-7b",
                       run_kw={"ssm_chunk": 8})
    toks = torch.from_numpy(_tokens(12))
    logits, cache = m.prefill(p, {"tokens": toks}, m.init_cache())
    tok = torch.argmax(logits, -1).to(torch.int32)
    logits2, cache = m.decode_step(p, tok, cache)
    full = torch.cat([toks, tok[:, None]], 1)
    logits_ref, _ = m.prefill(p, {"tokens": full}, m.init_cache())
    np.testing.assert_allclose(logits2.numpy(), logits_ref.numpy(),
                               atol=2e-3, rtol=2e-3)


def test_from_reference_keeps_ssm_params_f32_in_a_bf16_tree():
    """A_log, dt_bias and D are f32 params in a bf16 model, as the
    reference's templates declare them."""
    jcfg = jreduced(jget_config("falcon-mamba-7b"), param_dtype="bfloat16",
                    dtype="bfloat16")
    jp = JModel(JRunConfig(model=jcfg, shape=JShape("d", S, B, "decode"))
                ).init_params(jax.random.PRNGKey(0))
    p = from_reference(jax.tree.map(np.asarray, jp))
    mixer = p["stage_0"]["pos_0"]["mixer"]
    for k in ("A_log", "dt_bias", "D"):
        assert mixer[k].dtype == torch.float32, k
    assert mixer["in_proj"].dtype == torch.bfloat16
    cfg = reduced(get_config("falcon-mamba-7b"), param_dtype="bfloat16",
                  dtype="bfloat16")
    own = Model(RunConfig(model=cfg, shape=ShapeProfile("d", S, B, "decode"))
                ).init_params(torch.Generator().manual_seed(0))
    assert _tree.tree_map(lambda t: t.dtype, own) == \
        _tree.tree_map(lambda t: t.dtype, p)


def test_decode_prefill_consistency_dense():
    """The port's version of test_arch_smoke's check: a greedy decode
    continuation matches a fresh prefill over the longer sequence."""
    _, _, m, p = _pair(seed=1)
    toks = torch.from_numpy(_tokens(12))
    logits, cache = m.prefill(p, {"tokens": toks}, m.init_cache())
    tok = torch.argmax(logits, -1).to(torch.int32)
    seq = [tok]
    for _ in range(3):
        logits, cache = m.decode_step(p, tok, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        seq.append(tok)
    full = torch.cat([toks, torch.stack(seq[:-1], 1)], 1)
    logits_ref, _ = m.prefill(p, {"tokens": full}, m.init_cache())
    np.testing.assert_allclose(logits.numpy(), logits_ref.numpy(), atol=2e-4)


def _caches_handed_in_are_never_written(arch):
    _, _, m, p = _pair(arch=arch)
    batch = TSyntheticLMData(m.cfg, ShapeProfile("t", S, B, "train")).batch(0)
    batch = {k: v[:, :8] if k == "tokens" else v
             for k, v in batch.items() if k != "labels"}
    cache = m.init_cache()
    before = _tree.tree_map(torch.clone, cache)
    logits, c1 = m.prefill(p, batch, cache)
    snap = _tree.tree_map(torch.clone, c1)
    m.decode_step(p, torch.argmax(logits, -1).to(torch.int32), c1)
    for a, b in ((cache, before), (c1, snap)):
        assert all(torch.equal(x, y) for x, y in
                   zip(_tree.tree_leaves(a), _tree.tree_leaves(b)))


def test_caches_handed_in_are_never_written():
    """Stored caches are immutable MDSS values (digests are cached)."""
    _caches_handed_in_are_never_written("tinyllama-1.1b")


def test_mamba_caches_handed_in_are_never_written():
    """The Mamba state, conv window and pos are new tensors each step."""
    _caches_handed_in_are_never_written("falcon-mamba-7b")


@pytest.mark.parametrize("arch", ["minicpm3-4b", "seamless-m4t-medium",
                                  "jamba-v0.1-52b"])
def test_mla_cross_and_hybrid_caches_handed_in_are_never_written(arch):
    """MLA's latent caches, the cross-attention caches beside the decoder's
    KV caches, and the hybrid's Mamba and KV caches in one model."""
    _caches_handed_in_are_never_written(arch)


def _template_leaves(tree):
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out[path] = dataclasses.astuple(t)
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_architecture_builds_the_reference_template(arch):
    """The full config's template: the reference's keys, and for each leaf
    its shape, logical axes, init, scale, fan-in axis and dtype."""
    cfg = get_config(arch)
    assert _template_leaves(transformer.model_template(cfg)) == \
        _template_leaves(jmodel_template(jget_config(arch)))


def test_manual_ep_moe_without_a_mesh_is_moe():
    """``moe_impl="manual_ep"`` with no mesh in use falls back to the sort
    dispatch, as the reference's: the same prefill logits as ``moe``."""
    _, _, m, p = _pair(arch="qwen2-moe-a2.7b",
                       run_kw={"moe_impl": "manual_ep"})
    _, _, m_sort, _ = _pair(arch="qwen2-moe-a2.7b")
    batch = {"tokens": torch.from_numpy(_tokens(8))}
    logits, _ = m.prefill(p, batch, m.init_cache())
    want, _ = m_sort.prefill(p, batch, m_sort.init_cache())
    assert torch.equal(logits, want)
