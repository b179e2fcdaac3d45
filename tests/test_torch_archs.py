"""All ten architectures of the model zoo on the port, at their reduced
(CPU test) configs in f32, held against the JAX package's ``Model`` on
the same params (the reference's ``init_params``, converted) and the same
synthetic batch (bit-identical from both packages' pipelines), and the
reference's arch smoke tests (``tests/test_arch_smoke.py``) and
stage-pattern tests (``tests/test_models.py``) on the port.

Tolerances, the port's serve and train bounds (``test_torch_model.py``,
``test_torch_train.py``): logits and caches 1e-4 absolute (two decode
steps after the prefill); the train step's loss, xent, aux and mtp 1e-5
and grad_norm 1e-4, relative.
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
from repro.data.pipeline import SyntheticLMData as JData
from repro.models.model_zoo import Model as JModel
from repro.models.params import count_params
from repro.models.transformer import model_template as jmodel_template
from repro_torch import _tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import (ATTN_DENSE, ATTN_MOE, MAMBA_DENSE,
                                      MAMBA_MOE, ModelConfig, RunConfig,
                                      ShapeProfile, reduced)
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.model_zoo import Model
from repro_torch.models.params import from_reference

S, B = 32, 2
ATOL = 1e-4
TRAIN_RTOL = {"loss": 1e-5, "xent": 1e-5, "aux": 1e-5, "mtp": 1e-5,
              "grad_norm": 1e-4}


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _prefill_batch(batch):
    """The arch smoke test's prefill batch: no labels, half the tokens,
    the stub embeds whole."""
    pb = {k: v for k, v in batch.items() if k != "labels"}
    pb["tokens"] = pb["tokens"][:, :S // 2]
    return pb


@pytest.fixture(scope="module", params=ARCH_IDS)
def pair(request):
    """(arch, reference Model, its params and batch, port config, params
    and batch)."""
    arch = request.param
    jcfg = jreduced(jget_config(arch))
    jshape = JShape("t", S, B, "train")
    jp = JModel(JRunConfig(model=jcfg, shape=jshape)).init_params(
        jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch))
    return {"arch": arch, "jcfg": jcfg, "jp": jp,
            "jbatch": JData(jcfg, jshape).batch(0), "cfg": cfg,
            "p": from_reference(jax.tree.map(np.asarray, jp)),
            "batch": SyntheticLMData(cfg, ShapeProfile("t", S, B,
                                                       "train")).batch(0)}


def test_prefill_and_decode_match_reference(pair):
    """Prefill logits and every cache leaf, then two greedy decode steps'
    logits and caches, against the reference's."""
    jm = JModel(JRunConfig(model=pair["jcfg"], shape=JShape("d", S, B,
                                                            "decode"),
                           remat="none"))
    m = Model(RunConfig(model=pair["cfg"], shape=ShapeProfile("d", S, B,
                                                              "decode"),
                        remat="none"))
    jp, p = pair["jp"], pair["p"]
    jl, jc = jax.jit(jm.prefill)(jp, _prefill_batch(pair["jbatch"]),
                                 jm.init_cache())
    tl, tc = m.prefill(p, _prefill_batch(pair["batch"]), m.init_cache())
    jstep = jax.jit(jm.decode_step)
    for step in range(3):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        leaves = jax.tree_util.tree_leaves_with_path(jc)
        assert len(leaves) == len(_tree.tree_leaves(tc))
        for path, leaf in leaves:
            t = _leaf(tc, path)
            assert tuple(t.shape) == leaf.shape
            np.testing.assert_allclose(t.numpy(), np.asarray(leaf),
                                       atol=ATOL)
        if step == 2:
            break
        jtok, ttok = jnp.argmax(jl, -1), torch.argmax(tl, -1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jstep(jp, jtok, jc)
        tl, tc = m.decode_step(p, ttok, tc)


def test_train_step_matches_reference(pair):
    """One AdamW step: loss, xent, aux (MoE archs), mtp (deepseek) and
    grad_norm against the reference's; the port recomputes each block
    under remat, the reference does not."""
    jm = JModel(JRunConfig(model=pair["jcfg"], shape=JShape("t", S, B,
                                                            "train"),
                           remat="none"))
    m = Model(RunConfig(model=pair["cfg"], shape=ShapeProfile("t", S, B,
                                                              "train"),
                        remat="full"))
    jp, p = pair["jp"], pair["p"]
    _, _, jmet = jax.jit(jm.train_step)(jp, jm.opt_init(jp), pair["jbatch"])
    _, _, met = m.train_step(p, m.opt_init(p), pair["batch"])
    assert set(met) == set(jmet)
    for k, rtol in TRAIN_RTOL.items():
        if k in jmet:
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=rtol, atol=0, err_msg=k)
    cfg = pair["cfg"]
    assert (float(met["aux"]) > 0) == bool(cfg.n_experts)
    assert ("mtp" in met) == cfg.mtp


# ---------------------------------------------------------------------------
# The reference's arch smoke tests, on the port alone
# ---------------------------------------------------------------------------

def test_train_step(pair):
    arch, cfg, params = pair["arch"], pair["cfg"], pair["p"]
    model = Model(RunConfig(model=cfg, shape=ShapeProfile("smoke", S, B,
                                                          "train"),
                            remat="none"))
    p, o, metrics = model.train_step(params, model.opt_init(params),
                                     pair["batch"])
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0, f"{arch}: loss {loss}"
    diff = sum(float((a - b).abs().sum()) for a, b in
               zip(_tree.tree_leaves(p), _tree.tree_leaves(params)))
    assert diff > 0, f"{arch}: optimizer made no update"
    for a, b in zip(_tree.tree_leaves(p), _tree.tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_prefill_and_decode(pair):
    arch, cfg, params = pair["arch"], pair["cfg"], pair["p"]
    model = Model(RunConfig(model=cfg, shape=ShapeProfile("d", S, B,
                                                          "decode"),
                            remat="none"))
    logits, cache = model.prefill(params, _prefill_batch(pair["batch"]),
                                  model.init_cache())
    assert tuple(logits.shape) == (B, cfg.vocab_padded)
    assert torch.isfinite(logits).all(), f"{arch}: NaN prefill"
    tok = torch.argmax(logits, -1).to(torch.int32)
    logits2, cache = model.decode_step(params, tok, cache)
    assert tuple(logits2.shape) == (B, cfg.vocab_padded)
    assert torch.isfinite(logits2).all(), f"{arch}: NaN decode"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_builds_on_the_meta_device(arch):
    """The full config's params as meta tensors (no storage), as many as
    the reference's template holds, in the reference's band."""
    band = {
        "falcon-mamba-7b": 7e9, "llama3.2-3b": 3e9, "tinyllama-1.1b": 1.1e9,
        "qwen1.5-32b": 32e9, "minicpm3-4b": 4e9, "internvl2-1b": 0.6e9,
        "deepseek-v3-671b": 671e9, "qwen2-moe-a2.7b": 14e9,
        "jamba-v0.1-52b": 52e9, "seamless-m4t-medium": 1.2e9,
    }[arch]
    cfg = get_config(arch)
    model = Model(RunConfig(model=cfg, shape=ShapeProfile("d", S, B,
                                                          "decode")))
    leaves = _tree.tree_leaves(model.abstract_params())
    assert all(t.device.type == "meta" for t in leaves)
    n = sum(t.numel() for t in leaves)
    assert n == count_params(jmodel_template(jget_config(arch)))
    assert 0.5 * band < n < 2.2 * band, f"{arch}: {n / 1e9:.2f}B params"


# ---------------------------------------------------------------------------
# Stage patterns (``tests/test_models.py``), without hypothesis
# ---------------------------------------------------------------------------

def _tiny(**kw):
    base = dict(name="tiny", family="dense", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128,
                dtype="float32", param_dtype="float32")
    base.update(kw)
    return ModelConfig(**base)


PATTERN_KINDS = {
    "dense": {},
    "moe_every_2nd": dict(family="moe", n_experts=4, experts_per_token=2,
                          moe_d_ff=8, moe_layer_period=2, moe_layer_offset=1),
    "jamba": dict(family="hybrid", ssm_state=4, dt_rank=4,
                  attn_layer_period=8, attn_layer_offset=4, n_experts=4,
                  experts_per_token=2, moe_d_ff=8, moe_layer_period=2,
                  moe_layer_offset=1),
    "first_dense": dict(family="moe", n_experts=4, experts_per_token=2,
                        moe_d_ff=8, first_dense_layers=3),
}


@pytest.mark.parametrize("kind", list(PATTERN_KINDS))
def test_stage_compression_reconstructs_block_types(kind):
    """Every depth 1..64: the stages expand back to the per-layer block
    types, and equal the reference's stages."""
    from repro.configs.base import ModelConfig as JModelConfig
    for n_layers in range(1, 65):
        kw = dict(PATTERN_KINDS[kind], n_layers=n_layers)
        if kind == "first_dense":
            kw["first_dense_layers"] = min(3, n_layers)
        cfg = _tiny(**kw)
        rebuilt = []
        for pattern, reps in cfg.stages():
            rebuilt.extend(list(pattern) * reps)
        assert rebuilt == [cfg.block_type(i) for i in range(n_layers)]
        jcfg = JModelConfig(**dataclasses.asdict(cfg))
        assert cfg.stages() == jcfg.stages()


def test_jamba_pattern():
    cfg = _tiny(n_layers=32, **PATTERN_KINDS["jamba"])
    types = [cfg.block_type(i) for i in range(32)]
    assert types[4] == ATTN_DENSE and types[12] == ATTN_DENSE
    assert sum(1 for t in types if t in (ATTN_DENSE, ATTN_MOE)) == 4
    assert sum(1 for t in types if t in (MAMBA_MOE, ATTN_MOE)) == 16
    # the depth chip_smoke.py serves: one attention period
    assert _tiny(n_layers=8, **PATTERN_KINDS["jamba"]).stages() == (
        ((MAMBA_DENSE, MAMBA_MOE), 2), ((ATTN_DENSE,), 1), ((MAMBA_MOE,), 1),
        ((MAMBA_DENSE,), 1), ((MAMBA_MOE,), 1))
