"""The port's MLA (``repro_torch.models.attention``) held against the
reference's ``repro.models.attention`` on the same params (the
reference's ``init_params``, converted) and the same numpy inputs, in f32
on the CPU (where ``mla_full`` runs the flash op's plain version); and the
reference's absorbed-decode check (``tests/test_models.py``) on the port.

Tolerance: 1e-5 absolute against the reference (the frameworks sum in
different orders); 2e-4 for absorbed decode against full attention, the
reference's own bound (the two associate the products differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import attention as JA
from repro.models.params import init_params as jinit_params
from repro.parallel.sharding import get_rules
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import attention as A
from repro_torch.models.params import from_reference

RULES = get_rules("fsdp")
ATOL = 1e-5
# (q_lora, kv_lora, nope, rope, v): the reference's test config, and
# minicpm3's and deepseek-v3's head dims (flash dq/dv 96/64 and 192/128)
DIMS = {"tiny": (16, 8, 8, 4, 8), "minicpm3": (64, 32, 64, 32, 64),
        "deepseek-v3": (64, 32, 128, 64, 128)}


def _setup(dims="tiny", seed=0, B=2, S=9):
    ql, kl, dn, dr, dv = DIMS[dims]
    kw = dict(name="tiny", family="dense", n_layers=2, d_model=32,
              n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128,
              dtype="float32", param_dtype="float32", attn_type="mla",
              q_lora_rank=ql, kv_lora_rank=kl, qk_nope_head_dim=dn,
              qk_rope_head_dim=dr, v_head_dim=dv)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jp = jinit_params(JA.mla_template(jcfg), jax.random.PRNGKey(seed),
                      "float32")
    x = (np.random.default_rng(seed + 1).normal(size=(B, S, cfg.d_model))
         * 0.3).astype(np.float32)
    return jcfg, cfg, jp, from_reference(jax.tree.map(np.asarray, jp)), x


def _caches(jcfg, cfg, B, seq):
    spec = A.mla_cache_spec(cfg, B, seq)
    tc = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in spec.items()}
    jc = {k: jnp.zeros(v.shape, v.dtype)
          for k, v in JA.mla_cache_spec(jcfg, B, seq)[0].items()}
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    return jc, tc


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


@pytest.mark.parametrize("dims", list(DIMS))
def test_mla_full_and_decode_match_reference(dims):
    """Prefill output and latent caches, then two absorbed decode steps
    (outputs and caches), against the reference."""
    jcfg, cfg, jp, p, x = _setup(dims)
    jc, tc = _caches(jcfg, cfg, 2, 16)
    jo, jc = JA.mla_full(jcfg, jp, jnp.asarray(x[:, :7]), RULES, cache=jc)
    to, tc = A.mla_full(cfg, p, torch.from_numpy(x[:, :7]), cache=tc)
    _close(to, jo)
    for k in ("ckv", "krope", "pos"):
        _close(tc[k], jc[k])
    for t in (7, 8):
        jo, jc = JA.mla_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jc,
                               RULES)
        to, tc = A.mla_decode(cfg, p, torch.from_numpy(x[:, t:t + 1]), tc,
                              int(tc["pos"]))
        _close(to, jo)
    for k in ("ckv", "krope", "pos"):
        _close(tc[k], jc[k])


@pytest.mark.parametrize("dims", list(DIMS))
def test_mla_full_calls_flash_with_its_head_dims(dims, monkeypatch):
    """``mla_full`` hands the flash op q, k of width nope + rope and v of
    width v_head_dim (minicpm3 96/64, deepseek-v3 192/128)."""
    _, cfg, _, p, x = _setup(dims)
    seen = []
    real = fops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(fops, "flash_attention", spy)
    A.mla_full(cfg, p, torch.from_numpy(x))
    dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    assert seen == [(dq, dq, cfg.v_head_dim, True)]


def test_mla_absorbed_decode_matches_full():
    """Absorbed-latent decode == expanded full attention at the last pos
    (the reference's test, on the port)."""
    jcfg, cfg, _, p, x = _setup()
    xt = torch.from_numpy(x)
    full_out, _ = A.mla_full(cfg, p, xt)
    _, tc = _caches(jcfg, cfg, 2, 16)
    _, tc = A.mla_full(cfg, p, xt[:, :8], cache=tc)
    dec_out, _ = A.mla_decode(cfg, p, xt[:, 8:9], tc, 8)
    np.testing.assert_allclose(dec_out[:, 0].numpy(), full_out[:, 8].numpy(),
                               atol=2e-4)
