"""The port's dense LM held against the JAX package's ``Model`` on the
same params (converted from the reference's ``init_params``) and the same
numpy tokens, at reduced size on the CPU in f32.

Tolerance: 1e-4 absolute on logits and caches of a whole f32 model (the
two frameworks sum in different orders; measured differences are ~2e-6).
"""
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
from repro_torch import _tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
from repro_torch.models import transformer
from repro_torch.models.model_zoo import Model
from repro_torch.models.params import from_reference

S, B = 32, 2
ATOL = 1e-4


def _pair(seed=0, **over):
    jcfg = jreduced(jget_config("tinyllama-1.1b"), **over)
    jrun = JRunConfig(model=jcfg, shape=JShape("d", S, B, "decode"),
                      remat="none")
    jm = JModel(jrun)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    cfg = reduced(get_config("tinyllama-1.1b"), **over)
    m = Model(RunConfig(model=cfg, shape=ShapeProfile("d", S, B, "decode"),
                        remat="none"))
    return jm, jp, m, from_reference(jax.tree.map(np.asarray, jp))


def _tokens(n):
    jcfg = jreduced(jget_config("tinyllama-1.1b"))
    data = SyntheticLMData(jcfg, JShape("t", S, B, "train"))
    return np.array(data.batch(0)["tokens"][:, :n])


def test_configs_are_copies_of_the_reference():
    import dataclasses
    from repro.configs import ARCH_IDS as JIDS
    assert ARCH_IDS == JIDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))


def test_from_reference_keeps_keys_shapes_and_values():
    jm, jp, m, p = _pair()
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


def test_from_reference_bfloat16_is_bit_exact():
    x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    jb = np.asarray(jnp.asarray(x, jnp.bfloat16))        # ml_dtypes bf16
    t = from_reference({"w": jb})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), jb.astype(np.float32))
    assert torch.equal(t, torch.from_numpy(x).to(torch.bfloat16))


def test_prefill_caches_and_decode_match_reference():
    jm, jp, m, p = _pair()
    toks = _tokens(12)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache())
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(toks)},
                       m.init_cache())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for (path, leaf) in jax.tree_util.tree_leaves_with_path(jc):
        t = tc
        for k in path:
            t = t[k.key]
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
    np.testing.assert_allclose(tc["stage_0"]["pos_0"]["k"].numpy(),
                               np.asarray(jc["stage_0"]["pos_0"]["k"]),
                               atol=ATOL)
    assert transformer.cache_position(tc) == 16


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


def test_caches_handed_in_are_never_written():
    """Stored caches are immutable MDSS values (digests are cached)."""
    _, _, m, p = _pair()
    cache = m.init_cache()
    before = _tree.tree_map(torch.clone, cache)
    logits, c1 = m.prefill(p, {"tokens": torch.from_numpy(_tokens(8))},
                           cache)
    snap = _tree.tree_map(torch.clone, c1)
    m.decode_step(p, torch.argmax(logits, -1).to(torch.int32), c1)
    for a, b in ((cache, before), (c1, snap)):
        assert all(torch.equal(x, y) for x, y in
                   zip(_tree.tree_leaves(a), _tree.tree_leaves(b)))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "minicpm3-4b",
                                  "qwen2-moe-a2.7b", "seamless-m4t-medium"])
def test_unported_architectures_raise(arch):
    cfg = reduced(get_config(arch))
    with pytest.raises(NotImplementedError):
        Model(RunConfig(model=cfg, shape=ShapeProfile("d", S, B, "decode")))
