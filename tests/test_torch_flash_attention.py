"""The port's flash attention held against the JAX package's: its plain
version against ``repro``'s ``attention_ref`` and the Pallas kernel (in
interpret mode, as ``tests/test_kernels.py`` runs it), on the same numpy
inputs over the reference's sweep; and CPU dispatch. The Hopper kernel
itself is held against its plain version on the card in
``test_torch_kernels_cuda.py`` and by ``chip_smoke.py``."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as jref
from repro.kernels.flash_attention.kernel import flash_attention_fwd as jfwd
from repro.kernels.flash_attention.ops import flash_attention_kernel_call
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel, ops, ref

# the reference's tolerances (tests/test_kernels.py)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B, Sq, Skv, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, D)).astype(np.float32))


def _torch(xs, dt):
    return [torch.from_numpy(x).to(TDT[dt]) for x in xs]


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("B,H,KV,S,D", [
    (1, 2, 2, 128, 128),      # MHA
    (2, 4, 2, 256, 128),      # GQA 2:1
    (1, 8, 2, 128, 128),      # GQA 4:1
    (1, 2, 1, 384, 128),      # non-pow2 block count
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_and_pallas(B, H, KV, S, D, dtype, causal):
    xs = _inputs(B, S, S, H, KV, D, seed=S + H)
    q, k, v = (jnp.asarray(x, JDT[dtype]) for x in xs)
    scale = D ** -0.5
    want = np.asarray(jref.attention_ref(q, k, v, scale=scale,
                                         causal=causal), np.float32)
    pallas = np.asarray(jfwd(*(t.transpose(0, 2, 1, 3) for t in (q, k, v)),
                             scale=scale, causal=causal, interpret=True),
                        np.float32).transpose(0, 2, 1, 3)
    got = _np(ref.attention_ref(*_torch(xs, dtype), scale=scale,
                                causal=causal))
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)


def test_padding_case_matches_pallas_wrapper():
    """Seq not a multiple of the TPU block, head dim not lane-aligned:
    the port needs no padding, the reference's wrapper pads."""
    xs = _inputs(1, 200, 200, 2, 1, 96, seed=1)
    want = np.asarray(flash_attention_kernel_call(
        *(jnp.asarray(x) for x in xs), scale=96 ** -0.5, causal=True,
        interpret=True))
    got = _np(ref.attention_ref(*_torch(xs, "float32"), scale=96 ** -0.5,
                                causal=True))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_kv_len_mask_matches_reference():
    xs = _inputs(1, 128, 128, 2, 2, 128, seed=2)
    want = np.asarray(jref.attention_ref(*(jnp.asarray(x) for x in xs),
                                         scale=0.1, causal=False, kv_len=70))
    got = _np(ref.attention_ref(*_torch(xs, "float32"), scale=0.1,
                                causal=False, kv_len=70))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_cross_attention_shape_matches_reference():
    """Non-causal Sq != Skv, the reference's cross-attention call."""
    xs = _inputs(2, 24, 40, 4, 2, 16, seed=3)
    want = np.asarray(jref.attention_ref(*(jnp.asarray(x) for x in xs),
                                         scale=0.25, causal=False))
    got = _np(ops.flash_attention(*_torch(xs, "float32"), scale=0.25,
                                  causal=False))
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_matches_direct(causal):
    q, k, v = _torch(_inputs(2, 320, 320, 4, 2, 64, seed=4), "float32")
    a = ref.attention_ref(q, k, v, scale=0.3, causal=causal)
    b = ref.attention_ref_chunked(q, k, v, scale=0.3, causal=causal,
                                  q_chunk=128)
    np.testing.assert_allclose(_np(b), _np(a), atol=2e-5)


def test_cpu_dispatch_takes_plain_version_and_launches_nothing(monkeypatch):
    monkeypatch.setattr(kernel, "launches", 0)
    q, k, v = _torch(_inputs(1, 1100, 1100, 2, 1, 16, seed=5), "float32")
    # above the chunk threshold: the chunked plain version, as the
    # reference's CPU path
    got = ops.flash_attention(q, k, v, scale=0.25, causal=True)
    want = ref.attention_ref_chunked(q, k, v, scale=0.25, causal=True)
    assert torch.equal(got, want)
    small = [t[:, :64] for t in (q, k, v)]
    assert torch.equal(ops.flash_attention(*small, scale=0.25),
                       ref.attention_ref(*small, scale=0.25))
    assert kernel.launches == 0


def test_cuda_tensors_go_to_the_kernel(monkeypatch):
    """A CUDA tensor never takes the plain version: it launches the
    kernel (the custom op ``_launch``, whose CUDA body is
    ``kernel.flash_attention_fwd``), or the kernel's error propagates."""
    class CudaLike:
        is_cuda = True
        shape = (1, 4, 2, 8)

    calls = []

    def fake(q, k, v, scale, causal, kv_len):
        calls.append((scale, causal, kv_len))
        raise RuntimeError("launch refused")

    monkeypatch.setattr(ops, "_launch", fake)
    with pytest.raises(RuntimeError, match="launch refused"):
        ops.flash_attention(CudaLike(), CudaLike(), CudaLike(), scale=0.5)
    assert calls == [(0.5, True, None)]


def test_kernel_wrapper_refuses_what_it_cannot_run():
    q, k, v = _torch(_inputs(1, 8, 8, 2, 1, 16, seed=6), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_fwd(q, k, v, scale=1.0)
    with pytest.raises(ValueError, match="no path"):
        ops.flash_attention(*(t.to("meta") for t in (q, k, v)), scale=1.0)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.build()
    assert not (tmp_path / "build").exists()


def test_kernel_module_imports_without_nvcc(tmp_path):
    code = ("import torch\n"
            "from repro_torch.kernels.flash_attention import kernel, ops\n"
            "x = torch.ones(1, 4, 2, 8)\n"
            "ops.flash_attention(x, x[:, :, :1], x[:, :, :1], scale=1.0)\n"
            "assert kernel.launches == 0 and kernel._lib is None\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "no-cuda"),
               PYTHONPATH=os.path.join(root, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("layout", ["contiguous", "qkv_slices"])
def test_body_takes_tma_where_tma_can_address(D, layout):
    """The tma body for bf16 whose bases are 16-B aligned and whose
    strides are multiples of 16 B: contiguous tensors and slices of a fused
    qkv projection alike. Shapes and strides only; nothing launches."""
    if layout == "contiguous":
        q, k, v = _bf16((2, 40, 8, D)), _bf16((2, 40, 2, D)), \
            _bf16((2, 40, 2, D))
    else:
        qkv = _bf16((2, 40, 12, D))
        q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:12]
        assert not q.is_contiguous()
    assert kernel._body(q, k, v) == "tma"


def test_body_takes_mma_where_tma_cannot_address():
    q, k, v = _bf16((1, 16, 2, 5)), _bf16((1, 16, 1, 5)), \
        _bf16((1, 16, 1, 5))
    assert kernel._body(q, k, v) == "mma"            # head dim of 5
    # a sequence stride of 65 elements (130 B) is not a multiple of 16 B
    wide = _bf16((1, 16, 65))
    q = wide[:, :, :64].reshape(1, 16, 1, 64)
    k = _bf16((1, 16, 1, 64))
    assert q.stride(1) == 65
    assert kernel._body(q, k, k) == "mma"
    # a base 2 B past a 16-B boundary
    flat = _bf16((1 + 16 * 64,))
    q = flat[1:].reshape(1, 16, 1, 64)
    assert kernel._body(q, k, k) == "mma"
    assert kernel._body(k, k, k) == "tma"


def test_body_takes_f32_for_float32():
    q = torch.zeros((1, 16, 2, 64))
    k = torch.zeros((1, 16, 1, 64))
    assert kernel._body(q, k, k) == "f32"


def test_size_one_dims_take_dense_strides():
    """A size-1 dim is never stepped: its stride may be anything torch
    gives it, and the kernel gets the dense one."""
    q = _bf16((1, 40, 1, 64)).as_strided((1, 40, 1, 64), (3, 64, 7, 1))
    assert kernel._strides(q) == (40 * 64, 64, 64)
    assert kernel._body(q, q, q) == "tma"


# ------------------------------------------------------------------ gradient
@pytest.mark.parametrize("B,H,KV,S,D", [
    (1, 2, 2, 128, 128),      # MHA
    (2, 4, 2, 256, 128),      # GQA 2:1
    (1, 8, 2, 128, 128),      # GQA 4:1
    (1, 2, 1, 384, 128),      # non-pow2 block count
])
@pytest.mark.parametrize("causal", [True, False])
def test_gradient_matches_reference_vjp(B, H, KV, S, D, causal):
    """The autograd.Function's q, k, v cotangents against ``jax.vjp`` of
    the reference's ``attention_ref`` (its ``_fa_bwd``), f32 at 2e-5; GQA's
    k and v gradients sum over each group of q heads."""
    import jax
    xs = _inputs(B, S, S, H, KV, D, seed=S + H + KV)
    g = np.random.default_rng(S).normal(size=(B, S, H, D)).astype(np.float32)
    scale = D ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(
        q, k, v, scale=scale, causal=causal), *map(jnp.asarray, xs))
    want = vjp(jnp.asarray(g))
    qkv = [torch.from_numpy(x).requires_grad_() for x in xs]
    o = ops.flash_attention(*qkv, scale=scale, causal=causal)
    got = torch.autograd.grad(o, qkv, torch.from_numpy(g))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-5,
                                   rtol=2e-5)


def test_gradient_above_chunk_threshold_is_the_chunked_vjp():
    """Above ``CHUNK_THRESHOLD`` the backward recomputes the chunked plain
    version the forward ran: its VJP, bit for bit."""
    qkv = [t.requires_grad_() for t in
           _torch(_inputs(1, 1100, 1100, 2, 1, 16, seed=6), "float32")]
    g = torch.randn(1, 1100, 2, 16, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(ops.flash_attention(*qkv, scale=0.25), qkv, g)
    want = torch.autograd.grad(ref.attention_ref_chunked(*qkv, scale=0.25,
                                                         causal=True), qkv, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
