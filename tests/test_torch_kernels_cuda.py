"""The port's Hopper kernels against their plain versions, on the card.

These need a CUDA card and skip without one; on a machine with an H100
run ``PYTHONPATH=src python -m pytest -q -m cuda tests/``. This file
imports torch and the port only, as that machine has no jax.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel, ops, ref

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # the reference's


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,kv_len,causal", [
    (1, 128, 2, 2, 128, None, True),
    (2, 256, 4, 2, 128, None, False),
    (1, 384, 2, 1, 128, None, True),
    (1, 200, 2, 1, 96, None, True),
    (1, 128, 2, 2, 128, 70, False),
    (4, 448, 32, 4, 64, None, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(B, S, H, KV, D, kv_len,
                                              causal, dtype):
    _card()
    g = torch.Generator().manual_seed(S + H)
    q, k, v = (torch.randn(shape, generator=g).to("cuda", dtype)
               for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    before = kernel.launches
    got = ops.flash_attention(q, k, v, scale=D ** -0.5, causal=causal,
                              kv_len=kv_len)
    want = ref.attention_ref(q, k, v, scale=D ** -0.5, causal=causal,
                             kv_len=kv_len)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_kernel_takes_strided_inputs():
    """q, k, v straight out of a fused projection: no copy first."""
    _card()
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((2, 96, 3 * 4, 64), generator=g).to("cuda",
                                                           torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:8]
    assert not q.is_contiguous()
    got = kernel.flash_attention_fwd(q, k, v, scale=0.125, causal=True)
    want = ref.attention_ref(q, k, v, scale=0.125, causal=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)
