"""The port's Hopper kernels (flash attention, selective scan) against
their plain versions, on the card.

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
    body = kernel._body(q, k, v)
    assert body == ("f32" if dtype == torch.float32 else "tma")
    before, by_body = kernel.launches, kernel.launches_by_body[body]
    got = ops.flash_attention(q, k, v, scale=D ** -0.5, causal=causal,
                              kv_len=kv_len)
    want = ref.attention_ref(q, k, v, scale=D ** -0.5, causal=causal,
                             kv_len=kv_len)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert kernel.launches_by_body[body] == by_body + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,kv_len,causal", [
    (1, 128, 2, 2, 128, None, True),
    (2, 256, 4, 2, 128, None, False),
    (1, 8, 8, 2, 128, None, True),
    (1, 200, 2, 1, 96, None, True),
    (1, 128, 2, 2, 128, 70, False),
    (4, 448, 32, 4, 64, None, True),
    (4, 2048, 32, 4, 64, None, True),      # the serve profile's full prompt
])
@pytest.mark.parametrize("body", ["tma", "mma"])
def test_flash_attention_bf16_bodies_match_plain(B, S, H, KV, D, kv_len,
                                                 causal, body):
    """Both bf16 bodies on the same inputs: the tma body that ``_body``
    picks, and the mma.sync body forced through the private entry."""
    _card()
    g = torch.Generator().manual_seed(S + H + 1)
    q, k, v = (torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
               for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    before = kernel.launches_by_body[body]
    got = kernel._flash_attention_fwd(q, k, v, scale=D ** -0.5,
                                      causal=causal, kv_len=kv_len,
                                      body=body)
    want = ref.attention_ref(q, k, v, scale=D ** -0.5, causal=causal,
                             kv_len=kv_len)
    torch.cuda.synchronize()
    assert kernel.launches_by_body[body] == before + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_flash_attention_cross_attention_shape():
    """Non-causal Sq != Skv (the reference's cross-attention call), on the
    tma body."""
    _card()
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 150, 8, 64), generator=g).to("cuda", torch.bfloat16)
    k, v = (torch.randn((2, 300, 2, 64), generator=g).to("cuda",
                                                         torch.bfloat16)
            for _ in range(2))
    assert kernel._body(q, k, v) == "tma"
    got = kernel.flash_attention_fwd(q, k, v, scale=0.125, causal=False)
    want = ref.attention_ref(q, k, v, scale=0.125, causal=False)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_flash_attention_kernel_takes_strided_inputs():
    """q, k, v straight out of a fused projection: no copy first."""
    _card()
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((2, 96, 3 * 4, 64), generator=g).to("cuda",
                                                           torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:8]
    assert not q.is_contiguous()
    assert kernel._body(q, k, v) == "tma"
    got = kernel.flash_attention_fwd(q, k, v, scale=0.125, causal=True)
    want = ref.attention_ref(q, k, v, scale=0.125, causal=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,dq,dv,causal", [
    (2, 200, 8, 96, 64, True),       # minicpm3's MLA: 64 + 32 / 64
    (2, 256, 8, 192, 128, True),     # deepseek-v3's MLA: 128 + 64 / 128
    (1, 130, 4, 192, 128, False),
    (1, 96, 2, 256, 128, True),      # the kernel's dq limit
])
@pytest.mark.parametrize("body", ["f32", "tma", "mma"])
def test_flash_attention_mla_head_dims_match_plain(B, S, H, dq, dv, causal,
                                                   body):
    """dq != dv, up to dq 256, on every body: MLA's k and v have one head
    per q head."""
    _card()
    dtype = torch.float32 if body == "f32" else torch.bfloat16
    g = torch.Generator().manual_seed(S + dq)
    q, k, v = (torch.randn(shape, generator=g).to("cuda", dtype)
               for shape in ((B, S, H, dq), (B, S, H, dq), (B, S, H, dv)))
    assert kernel._body(q, k, v) == ("f32" if body == "f32" else "tma")
    before = kernel.launches_by_body[body]
    got = kernel._flash_attention_fwd(q, k, v, scale=dq ** -0.5,
                                      causal=causal, body=body)
    want = ref.attention_ref(q, k, v, scale=dq ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert kernel.launches_by_body[body] == before + 1
    assert got.shape == (B, S, H, dv)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dq,dv", [(264, 128), (192, 136)])
def test_flash_attention_kernel_refuses_head_dims_past_its_limits(dq, dv):
    _card()
    q, k = (torch.zeros((1, 8, 2, dq), device="cuda") for _ in range(2))
    v = torch.zeros((1, 8, 2, dv), device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        kernel.flash_attention_fwd(q, k, v, scale=1.0)


# ------------------------------------------------------------- selective scan
def _scan_inputs(Bt, L, di, N, dtype, seed):
    """The reference's ``_scan_args`` draws; x, B, C in ``dtype``, the
    rest f32 (the model's mix)."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dt)
    return (t(rng.normal(size=(Bt, L, di)), dtype),
            t(rng.uniform(1e-3, 0.1, (Bt, L, di))),
            t(-rng.uniform(0.5, 2.0, (di, N))),
            t(rng.normal(size=(Bt, L, N)), dtype),
            t(rng.normal(size=(Bt, L, N)), dtype),
            t(rng.normal(size=(di,))),
            t(rng.normal(size=(Bt, di, N))))


@pytest.mark.cuda
@pytest.mark.parametrize("Bt,L,di,N", [
    (1, 64, 32, 8), (2, 128, 64, 16), (2, 96, 48, 16),   # the reference's
    (1, 200, 8000, 16),       # ragged time tile and channel block
    (2, 37, 130, 5),          # N outside 4/8/16
    (4, 2048, 8192, 16),      # the serve profile's full prompt
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_matches_plain(Bt, L, di, N, dtype):
    """The kernel runs the recurrence in time order, the plain version an
    associative scan: only rounding differs, so the reference's
    tolerances hold (y f32 2e-5 / bf16 2e-2, h_last 2e-4)."""
    _card()
    from repro_torch.kernels.mamba_scan import kernel as sk
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.mamba_scan import ref as sref
    args = _scan_inputs(Bt, L, di, N, dtype, seed=L + di)
    before = sk.launches
    y, h = sops.selective_scan(*args, chunk=64)
    y_ref, h_ref = sref.selective_scan_ref(*args, chunk=64)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_ref.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(h.cpu().numpy(), h_ref.cpu().numpy(),
                               atol=2e-4)


@pytest.mark.cuda
def test_selective_scan_kernel_takes_x_proj_slices():
    """B and C straight out of the x_proj output: no copy first."""
    _card()
    from repro_torch.kernels.mamba_scan import kernel as sk
    from repro_torch.kernels.mamba_scan import ref as sref
    x, dt, A, _, _, D, h0 = _scan_inputs(2, 50, 256, 16, torch.bfloat16,
                                         seed=1)
    proj = torch.randn((2, 50, 8 + 32), device="cuda").to(torch.bfloat16)
    B, C = proj[..., 8:24], proj[..., 24:]
    assert not B.is_contiguous()
    y, h = sk.selective_scan_fwd(x, dt, A, B, C, D, h0)
    y_ref, h_ref = sref.selective_scan_ref(x, dt, A, B, C, D, h0)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_ref.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(h.cpu().numpy(), h_ref.cpu().numpy(),
                               atol=2e-4)


@pytest.mark.cuda
def test_selective_scan_kernel_jamba_shape():
    """jamba-v0.1-52b's mixer: d_inner 8192, N 16, B and C slices of the
    x_proj output behind a dt_rank of 256."""
    _card()
    from repro_torch.kernels.mamba_scan import kernel as sk
    from repro_torch.kernels.mamba_scan import ref as sref
    x, dt, A, _, _, D, h0 = _scan_inputs(2, 256, 8192, 16, torch.bfloat16,
                                         seed=2)
    proj = torch.randn((2, 256, 256 + 32), device="cuda").to(torch.bfloat16)
    B, C = proj[..., 256:272], proj[..., 272:]
    y, h = sk.selective_scan_fwd(x, dt, A, B, C, D, h0)
    y_ref, h_ref = sref.selective_scan_ref(x, dt, A, B, C, D, h0)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_ref.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(h.cpu().numpy(), h_ref.cpu().numpy(),
                               atol=2e-4)


# -------------------------------------------------------------- gradients
def _assert_grads_close(got, want, tol):
    """Each cotangent within ``tol`` relative and ``tol`` times the
    reference's scale (its rms, at least 1) absolute: a gradient is a sum
    of terms as large as the gradient itself, and f32 sums in another
    order round relative to that scale, not to an element that cancels to
    near zero."""
    for a, b in zip(got, want):
        scale = max(1.0, float(b.square().mean().sqrt()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol * scale,
                                   rtol=tol)


def _grads(fn, inputs, cot, device, dtypes):
    """Cotangents of ``fn``'s inputs on ``device``, the inputs cast to
    ``dtypes`` there (None keeps float32)."""
    ts = [t.to(device, dt or torch.float32).requires_grad_()
          for t, dt in zip(inputs, dtypes)]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    cots = [c.to(device, o.dtype) for c, o in zip(cot, outs)]
    return [g.float().cpu() for g in torch.autograd.grad(outs, ts, cots)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,causal", [
    (1, 128, 2, 2, 128, True), (2, 256, 4, 2, 128, False),
    (1, 128, 8, 2, 128, True), (1, 384, 2, 1, 128, False),
    (2, 2048, 32, 4, 64, True),            # tinyllama's train shape
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_matches_cpu(B, S, H, KV, D, causal, dtype):
    """The autograd.Function on the card (kernel forward, the plain
    version's VJP backward) against the same Function on the CPU (plain
    forward and backward), in the same dtype: f32 2e-5, bf16 2e-2 (the
    backward's bf16 products round alike on both, up to the order of
    their f32 sums), scaled as ``_assert_grads_close`` says."""
    _card()
    g = torch.Generator().manual_seed(S + H)
    qkv = [torch.randn(s, generator=g).to(dtype).float()
           for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]
    cot = [torch.randn((B, S, H, D), generator=g)]

    def fn(q, k, v):
        return ops.flash_attention(q, k, v, scale=D ** -0.5, causal=causal)
    before = kernel.launches
    card = _grads(fn, qkv, cot, "cuda", [dtype] * 3)
    assert kernel.launches == before + 1
    host = _grads(fn, qkv, cot, "cpu", [dtype] * 3)
    _assert_grads_close(card, host, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("Bt,L,di,N", [
    (1, 64, 32, 8), (2, 128, 64, 16), (2, 96, 48, 16),   # the reference's
    (2, 1024, 8192, 16),      # falcon-mamba-7b's train shape
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_backward_matches_cpu(Bt, L, di, N, dtype):
    """The CUDA Function (kernel forward, closed-form backward at f32)
    against the CPU Function (closed-form forward and backward at f32),
    from the same inputs (x, B, C in ``dtype``): f32 2e-5; bf16 2e-2,
    where the cotangents of x, B and C are rounded to bf16 on both;
    scaled as ``_assert_grads_close`` says (at the train shape, f32 sums
    of terms up to ~40 leave ~4e-5 on a few of 16.7 M elements of the
    dt cotangent that cancel to ~5e-3)."""
    _card()
    from repro_torch.kernels.mamba_scan import kernel as sk
    from repro_torch.kernels.mamba_scan import ops as sops
    args = [t.float().cpu() for t in _scan_inputs(Bt, L, di, N, dtype,
                                                  seed=L + di)]
    rng = np.random.default_rng(L)
    cot = [torch.from_numpy(rng.normal(size=(Bt, L, di)).astype(np.float32)),
           torch.from_numpy(rng.normal(size=(Bt, di, N)).astype(np.float32))]
    dts = [dtype, None, None, dtype, dtype, None, None]

    def fn(*a):
        return sops.selective_scan(*a, chunk=512)
    before = sk.launches
    card = _grads(fn, args, cot, "cuda", dts)
    assert sk.launches == before + 1
    host = _grads(fn, args, cot, "cpu", dts)
    _assert_grads_close(card, host, TOL[dtype])
