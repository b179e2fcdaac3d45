"""The port's synthetic LM data (``repro_torch.data.pipeline``) against
``repro.data.pipeline``: the same (seed, step) gives the same batch, bit
for bit (tokens int32; stub embeds the same float32 draws, cast to the
config's dtype), as CPU tensors; and the scenarios of
``tests/test_data.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeProfile as JShape
from repro.configs.base import reduced as jreduced
from repro.data import pipeline as jpipe
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeProfile, reduced
from repro_torch.data.pipeline import SyntheticLMData, token_batch_shapes


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _ref_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-1b",
                                  "seamless-m4t-medium", "falcon-mamba-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batches_bit_identical_to_reference(arch, dtype):
    cfg = reduced(get_config(arch), dtype=dtype)
    jcfg = jreduced(jget_config(arch), dtype=dtype)
    sp, jsp = ShapeProfile("t", 32, 3, "train"), JShape("t", 32, 3, "train")
    assert token_batch_shapes(cfg, sp) == jpipe.token_batch_shapes(jcfg, jsp)
    mine, ref = SyntheticLMData(cfg, sp, seed=5), jpipe.SyntheticLMData(
        jcfg, jsp, seed=5)
    for step in (0, 1, 7, 1000):
        b, jb = mine.batch(step), ref.batch(step)
        assert list(b) == list(jb)
        for k in b:
            assert b[k].device.type == "cpu"
            assert str(b[k].dtype).split(".")[-1] == str(jb[k].dtype), k
            np.testing.assert_array_equal(_bits(b[k]), _ref_bits(jb[k]))


def test_deterministic_per_step():
    cfg = reduced(get_config("tinyllama-1.1b"))
    sp = ShapeProfile("t", 32, 4, "train")
    d1, d2 = SyntheticLMData(cfg, sp, seed=3), SyntheticLMData(cfg, sp, seed=3)
    b1, b2 = d1.batch(17), d2.batch(17)
    for k in b1:
        assert torch.equal(b1[k], b2[k])
    assert not torch.equal(b1["tokens"], d1.batch(18)["tokens"])


def test_tokens_in_vocab():
    cfg = reduced(get_config("tinyllama-1.1b"))
    b = SyntheticLMData(cfg, ShapeProfile("t", 64, 2, "train")).batch(0)
    toks = b["tokens"]
    assert toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    assert b["labels"] is toks


def test_vlm_batch_has_frontend_stub():
    cfg = reduced(get_config("internvl2-1b"))
    sp = ShapeProfile("t", 32, 2, "train")
    shapes = token_batch_shapes(cfg, sp)
    assert shapes["frontend_embeds"] == (2, cfg.frontend_tokens, cfg.d_model)
    assert shapes["tokens"] == (2, 32 - cfg.frontend_tokens)
    b = SyntheticLMData(cfg, sp).batch(0)
    assert tuple(b["frontend_embeds"].shape) == shapes["frontend_embeds"]


def test_encdec_batch_has_encoder_stub():
    cfg = reduced(get_config("seamless-m4t-medium"))
    shapes = token_batch_shapes(cfg, ShapeProfile("t", 32, 2, "train"))
    assert shapes["encoder_embeds"] == (2, 32, cfg.d_model)
    assert shapes["tokens"] == (2, 32)


def test_full_config_batch_shapes():
    """A full config's batch (tinyllama-1.1b at the train profile of the
    card run) without drawing it: int32 tokens of (4, 2048)."""
    cfg = get_config("tinyllama-1.1b")
    shapes = token_batch_shapes(cfg, ShapeProfile("train", 2048, 4, "train"))
    assert shapes == {"tokens": (4, 2048), "labels": (4, 2048)}
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jget_config("tinyllama-1.1b"))
