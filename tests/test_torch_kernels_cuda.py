"""The port's Hopper kernels (flash attention, selective scan, SHA-256 of
chunks) against their plain versions, on the card.

These need a CUDA card and skip without one; on a machine with an H100
run ``PYTHONPATH=src python -m pytest -q -m cuda tests/``. This file
imports torch and the port only, as that machine has no jax.
"""
import collections

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
def test_flash_attention_kernel_takes_head_dims_past_one_pass(dq, dv):
    """Past the old limits (dq 256, dv 128) the kernel returns what the
    plain version does: dq streamed in slices, dv in column blocks, one
    launch per block."""
    _card()
    g = torch.Generator().manual_seed(dq + dv)
    q, k = (torch.randn((1, 8, 2, dq), generator=g).cuda() for _ in range(2))
    v = torch.randn((1, 8, 2, dv), generator=g).cuda()
    before = kernel.launches
    got = kernel.flash_attention_fwd(q, k, v, scale=dq ** -0.5)
    want = ref.attention_ref(q, k, v, scale=dq ** -0.5)
    torch.cuda.synchronize()
    assert kernel.launches == before + -(-dv // kernel.MAX_DV)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])


# chip_smoke.py's phase 2b cases past the old limits: (B, Sq, Skv, H, KV,
# dq, dv, causal) and the bodies each runs (f32; bf16 on the body
# ``_body`` picks, and the others that can take it)
FLASH_WIDE = [
    ((2, 463, 463, 16, 2, 320, 320, True), ("f32", "mma")),
    ((2, 463, 463, 16, 16, 192, 256, True), ("f32", "tma", "mma")),
    ((1, 1024, 1024, 16, 1, 576, 512, True), ("f32", "mma")),   # MLA latent
    ((2, 384, 512, 16, 16, 320, 320, False), ("f32", "mma")),
    ((1, 64, 64, 2, 1, 264, 136, True), ("f32", "mma")),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,body", [(s, b) for s, bodies in FLASH_WIDE
                                        for b in bodies])
def test_flash_attention_wide_head_dims_match_plain(shape, body):
    """dq past 256 and dv past 128 on every body that takes them, one
    launch per 128 columns of v: f32 2e-5, bf16 2e-2."""
    _card()
    B, Sq, Skv, H, KV, dq, dv, causal = shape
    dtype = torch.float32 if body == "f32" else torch.bfloat16
    g = torch.Generator().manual_seed(dq + dv + Sq)
    q, k, v = (torch.randn(s, generator=g).to("cuda", dtype) for s in
               ((B, Sq, H, dq), (B, Skv, KV, dq), (B, Skv, KV, dv)))
    picked = kernel._body(q, k, v)
    assert picked == ("f32" if body == "f32" else
                      "tma" if dq <= kernel.MAX_DQ else "mma")
    before = kernel.launches_by_body[body]
    got = kernel._flash_attention_fwd(q, k, v, scale=dq ** -0.5,
                                      causal=causal, body=body)
    want = ref.attention_ref(q, k, v, scale=dq ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert kernel.launches_by_body[body] == before + -(-dv // 128)
    assert got.shape == (B, Sq, H, dv)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_wide_kv_len_mask(dtype):
    """The kv_len mask past dq 256 and dv 128: every column block and
    head-dim slice masks the same keys."""
    _card()
    g = torch.Generator().manual_seed(7)
    q, k = (torch.randn((2, 128, 4, 320), generator=g).to("cuda", dtype)
            for _ in range(2))
    v = torch.randn((2, 128, 4, 200), generator=g).to("cuda", dtype)
    got = kernel.flash_attention_fwd(q, k, v, scale=0.05, causal=False,
                                     kv_len=70)
    want = ref.attention_ref(q, k, v, scale=0.05, causal=False, kv_len=70)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV", [(65537, 2, 1), (1, 65537, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_past_the_grid_runs_in_passes(B, H, KV, dtype):
    """More than 65535 batch rows or q heads: two launches, each within
    the grid, together the plain version's output."""
    _card()
    g = torch.Generator().manual_seed(B + H)
    q = torch.randn((B, 4, H, 16), generator=g).to("cuda", dtype)
    k, v = (torch.randn((B, 4, KV, 16), generator=g).to("cuda", dtype)
            for _ in range(2))
    before = kernel.launches
    got = kernel.flash_attention_fwd(q, k, v, scale=0.25)
    want = ref.attention_ref(q, k, v, scale=0.25)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_copies_a_strided_head_dim(dtype):
    """A last dim that is not contiguous is copied contiguous, not
    refused."""
    _card()
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((2, 64, 4, 128), generator=g).to("cuda", dtype)
               [..., ::2] for _ in range(3))
    assert q.stride(3) == 2
    got = kernel.flash_attention_fwd(q, k, v, scale=0.125)
    want = ref.attention_ref(q, k, v, scale=0.125)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


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


# chip_smoke.py's phase 2b cases past N = 16: (Bt, L, di, N), with the
# lanes per channel and state groups the kernel takes for bf16 and f32
SCAN_WIDE = [
    ((2, 463, 8192, 17), (4, 1), (8, 1)),
    ((2, 463, 8192, 32), (4, 1), (8, 1)),
    ((2, 463, 8192, 64), (8, 1), (16, 1)),
    ((2, 463, 2048, 320), (32, 2), (32, 3)),     # past one warp
    ((1, 200, 4096, 32), (4, 1), (8, 1)),        # ragged
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bf16,f32", SCAN_WIDE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_wide_states_match_plain(shape, bf16, f32, dtype):
    """N past 16: more lanes per channel, past a warp state groups whose
    f32 partials are added before y is rounded once; the reference's
    tolerances (y f32 2e-5 / bf16 2e-2, h_last 2e-4)."""
    _card()
    from repro_torch.kernels.mamba_scan import kernel as sk
    from repro_torch.kernels.mamba_scan import ref as sref
    Bt, L, di, N = shape
    assert (sk.lanes(dtype, N), sk.groups(dtype, N)) == (
        bf16 if dtype == torch.bfloat16 else f32)
    args = _scan_inputs(Bt, L, di, N, dtype, seed=N + di)
    before = sk.launches
    y, h = sk.selective_scan_fwd(*args)
    y_ref, h_ref = sref.selective_scan_ref(*args)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_ref.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(h.cpu().numpy(), h_ref.cpu().numpy(),
                               atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_past_the_grid_runs_in_passes(N, dtype):
    """More than 65535 batch rows, x's channels strided and h0 a
    transposed view: two launches on contiguous copies."""
    _card()
    from repro_torch.kernels.mamba_scan import kernel as sk
    from repro_torch.kernels.mamba_scan import ref as sref
    x, dt, A, B, C, D, h0 = _scan_inputs(65537, 3, 8, N, dtype, seed=N)
    xs = torch.stack([x, x], -1)[..., 0]
    h0t = h0.transpose(1, 2).contiguous().transpose(1, 2)
    before = sk.launches
    y, h = sk.selective_scan_fwd(xs, dt, A, B, C, D, h0t)
    y_ref, h_ref = sref.selective_scan_ref(x, dt, A, B, C, D, h0)
    torch.cuda.synchronize()
    assert sk.launches == before + 2
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
    """The CUDA Function (the forward and backward kernels) against the
    CPU Function (closed-form forward and backward at f32),
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
    before, bwd_before = sk.launches, sk.bwd_launches
    card = _grads(fn, args, cot, "cuda", dts)
    assert (sk.launches, sk.bwd_launches) == (before + 1, bwd_before + 1)
    host = _grads(fn, args, cot, "cpu", dts)
    _assert_grads_close(card, host, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_backward_matches_cpu(dtype):
    """Both Functions' backward past the old limits, card against CPU as
    above: flash at dq 320 / dv 256 (GQA 2:1), the scan at N = 64."""
    _card()
    from repro_torch.kernels.mamba_scan import kernel as sk
    from repro_torch.kernels.mamba_scan import ops as sops
    g = torch.Generator().manual_seed(11)
    qkv = [torch.randn(s, generator=g).to(dtype).float()
           for s in ((1, 192, 4, 320), (1, 192, 2, 320), (1, 192, 2, 256))]
    cot = [torch.randn((1, 192, 4, 256), generator=g)]

    def fa(q, k, v):
        return ops.flash_attention(q, k, v, scale=320 ** -0.5, causal=True)
    before = kernel.launches
    card = _grads(fa, qkv, cot, "cuda", [dtype] * 3)
    assert kernel.launches == before + 2
    _assert_grads_close(card, _grads(fa, qkv, cot, "cpu", [dtype] * 3),
                        TOL[dtype])

    Bt, L, di, N = 2, 128, 256, 64
    args = [t.float().cpu() for t in _scan_inputs(Bt, L, di, N, dtype,
                                                  seed=N)]
    rng = np.random.default_rng(N)
    cot = [torch.from_numpy(rng.normal(size=(Bt, L, di)).astype(np.float32)),
           torch.from_numpy(rng.normal(size=(Bt, di, N)).astype(np.float32))]
    dts = [dtype, None, None, dtype, dtype, None, None]

    def ss(*a):
        return sops.selective_scan(*a, chunk=512)
    before = sk.launches
    card = _grads(ss, args, cot, "cuda", dts)
    assert sk.launches == before + 1
    _assert_grads_close(card, _grads(ss, args, cot, "cpu", dts), TOL[dtype])


# ------------------------------------------------- the scan's backward kernel
def _bwd_inputs(Bt, L, di, N, dtype, seed, proj=None):
    """The scan's inputs (x, B, C in ``dtype``; h0 nonzero) and nonzero
    cotangents of y and h_last; with ``proj``, B and C are the last 2N
    columns of a (Bt, L, proj) x_proj output, as the model slices them."""
    x, dt, A, B, C, D, h0 = _scan_inputs(Bt, L, di, N, dtype, seed)
    if proj:
        g = torch.Generator(device="cuda").manual_seed(seed)
        p = torch.randn((Bt, L, proj), generator=g, device="cuda").to(dtype)
        B, C = p[..., proj - 2 * N:proj - N], p[..., proj - N:]
    rng = np.random.default_rng(seed + 1)
    y_bar = torch.from_numpy(rng.normal(size=(Bt, L, di)).astype(
        np.float32)).to("cuda", dtype)
    h_bar = torch.from_numpy(rng.normal(size=(Bt, di, N)).astype(
        np.float32)).to("cuda")
    return (x, dt, A, B, C, D, h0), (y_bar, h_bar)


def _ref_grads(args, cots):
    """``torch.autograd.grad`` of the plain ``selective_scan_ref``."""
    from repro_torch.kernels.mamba_scan import ref as sref
    ts = [t.detach().clone().requires_grad_() for t in args]
    y, h = sref.selective_scan_ref(*ts, chunk=256)
    return torch.autograd.grad((y, h), ts, cots)


SCAN_BWD = [
    # the train cell's shape, B and C slices of a 576-B x_proj row
    ((2, 2048, 8192, 16), torch.bfloat16, 256 + 32),
    ((2, 463, 8192, 16), torch.bfloat16, 256 + 32),   # jamba's, ragged
    ((2, 463, 8192, 16), torch.float32, None),
    ((1, 2048, 4096, 16), torch.bfloat16, None),       # 18a's local shard
    ((2, 300, 1000, 17), torch.float32, None),         # the wide path
    ((2, 128, 512, 32), torch.float32, 40 + 64),       # 12b's state
    ((2, 128, 512, 32), torch.bfloat16, None),
    ((1, 64, 32, 8), torch.float32, None),             # the reference's
    ((2, 37, 130, 5), torch.bfloat16, None),           # odd N, ragged
    ((1, 32, 64, 16), torch.float32, None),            # one tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,proj", SCAN_BWD)
def test_selective_scan_bwd_kernel_matches_plain(shape, dtype, proj):
    """The backward kernel's seven cotangents against ``closed_form_bwd``
    at f32 (the plain version it replaces) and against autograd of the
    plain forward, from nonzero h0 and h_last cotangent: f32 2e-5, bf16
    2e-2, scaled as ``_assert_grads_close`` says (the kernel sums over
    time, channels and rows in another order than either)."""
    _card()
    from repro_torch.kernels.mamba_scan import kernel as sk
    from repro_torch.kernels.mamba_scan import ops as sops
    Bt, L, di, N = shape
    args, cots = _bwd_inputs(Bt, L, di, N, dtype, seed=L + N, proj=proj)
    if proj:
        assert not args[3].is_contiguous() and args[3].stride(1) == proj
    before = sk.bwd_launches
    got = sk.selective_scan_bwd(*args, *cots)
    torch.cuda.synchronize()
    assert sk.bwd_launches == before + 1
    assert [g.dtype for g in got] == [t.dtype for t in args]
    assert [g.shape for g in got] == [t.shape for t in args]
    got = [g.float().cpu() for g in got]
    plain = sops.closed_form_bwd(*args, *cots, chunk=L)
    _assert_grads_close(got, [g.float().cpu() for g in plain], TOL[dtype])
    del plain
    ref = _ref_grads(args, cots)
    _assert_grads_close(got, [g.float().cpu() for g in ref], TOL[dtype])


@pytest.mark.cuda
def test_selective_scan_bwd_repeats_its_bits():
    """Every sum over channels, groups and rows is taken in a fixed order
    (no atomics): two calls give equal bits, at the train shape and on
    the wide path."""
    _card()
    from repro_torch.kernels.mamba_scan import kernel as sk
    for shape, dtype in (((2, 2048, 8192, 16), torch.bfloat16),
                         ((2, 128, 512, 40), torch.float32)):
        args, cots = _bwd_inputs(*shape, dtype, seed=3, proj=None)
        a = sk.selective_scan_bwd(*args, *cots)
        b = sk.selective_scan_bwd(*args, *cots)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 20])
def test_selective_scan_bwd_past_the_grid_runs_in_launches(N):
    """More than 65535 batch rows: two launches, then the rows' dA and dD
    added once; y_bar with a strided channel dim, copied first."""
    _card()
    from repro_torch.kernels.mamba_scan import kernel as sk
    from repro_torch.kernels.mamba_scan import ops as sops
    args, (y_bar, h_bar) = _bwd_inputs(65537, 3, 8, N, torch.float32,
                                       seed=N)
    ys = torch.stack([y_bar, y_bar], -1)[..., 0]
    before = sk.bwd_launches
    got = sk.selective_scan_bwd(*args, ys, h_bar)
    torch.cuda.synchronize()
    assert sk.bwd_launches == before + 2
    want = sops.closed_form_bwd(*args, y_bar, h_bar, chunk=3)
    _assert_grads_close([g.cpu() for g in got], [g.cpu() for g in want],
                        TOL[torch.float32])


@pytest.mark.cuda
def test_selective_scan_bwd_refuses_what_it_cannot_take():
    _card()
    from repro_torch.kernels.mamba_scan import kernel as sk
    args, (y_bar, h_bar) = _bwd_inputs(1, 40, 64, 16, torch.bfloat16,
                                       seed=5)
    with pytest.raises(TypeError, match="y_bar"):
        sk.selective_scan_bwd(*args, y_bar.float(), h_bar)
    with pytest.raises(ValueError, match="hlast_bar"):
        sk.selective_scan_bwd(*args, y_bar, h_bar[:, :8])
    with pytest.raises(ValueError, match="CUDA"):
        sk.selective_scan_bwd(*args, y_bar.cpu(), h_bar)
    with pytest.raises(TypeError, match="float32 dt"):
        sk.selective_scan_bwd(args[0], args[1].bfloat16(), *args[2:], y_bar,
                              h_bar)


@pytest.mark.cuda
def test_selective_scan_train_path_never_takes_the_plain_backward(
        monkeypatch):
    """The CUDA Function's backward is one kernel launch; the plain
    version is not reached."""
    _card()
    from repro_torch.kernels.mamba_scan import kernel as sk
    from repro_torch.kernels.mamba_scan import ops as sops

    def refused(*a, **k):
        raise AssertionError("closed_form_bwd on a CUDA path")
    monkeypatch.setattr(sops, "closed_form_bwd", refused)
    args, cots = _bwd_inputs(2, 96, 256, 16, torch.bfloat16, seed=7,
                             proj=16 + 32)
    ts = [t.detach().clone().requires_grad_() for t in args]
    f0, b0 = sk.launches, sk.bwd_launches
    y, h = sops.selective_scan(*ts)
    grads = torch.autograd.grad((y, h), ts, cots)
    torch.cuda.synchronize()
    assert (sk.launches, sk.bwd_launches) == (f0 + 1, b0 + 1)
    _assert_grads_close([g.float().cpu() for g in grads],
                        [g.float().cpu() for g in _ref_grads(args, cots)],
                        TOL[torch.bfloat16])


# ---------------------------------------------------------------------------
# The launches as custom ops: fake shapes and FLOPs (the dry run's path)
# ---------------------------------------------------------------------------

def _visible_pairs(Sq, kv_len, causal):
    """(q, k) pairs counted one by one: query ``i`` sees keys ``<
    kv_len`` and, causal, ``<= i``."""
    return sum(1 for i in range(Sq) for j in range(kv_len)
               if not causal or j <= i)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,KV,dq,dv,causal,kv_len", [
    (2, 2048, 2048, 16, 2, 64, 64, True, None),
    (1, 300, 300, 8, 8, 96, 64, True, 257),
    (2, 384, 512, 16, 16, 64, 64, False, None),
    (2, 463, 463, 128, 128, 192, 128, True, None),
])
def test_flash_attention_op_is_fake_and_counts_its_flops(B, Sq, Skv, H, KV,
                                                         dq, dv, causal,
                                                         kv_len):
    """On fake CUDA tensors the launch is the custom op's fake: the
    output's shape and dtype, no launch; FlopCounterMode counts the
    registered formula, the two products (2 x (dq + dv) per visible
    pair) counted here by hand."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    _card()
    before = kernel.launches
    with FakeTensorMode():
        q = torch.empty(B, Sq, H, dq, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(B, Skv, KV, dq, device="cuda", dtype=torch.bfloat16)
        v = torch.empty(B, Skv, KV, dv, device="cuda", dtype=torch.bfloat16)
        with FlopCounterMode(display=False) as fc:
            o = ops.flash_attention(q, k, v, scale=0.1, causal=causal,
                                    kv_len=kv_len)
    assert tuple(o.shape) == (B, Sq, H, dv) and o.dtype == torch.bfloat16
    assert kernel.launches == before
    pairs = _visible_pairs(Sq, Skv if kv_len is None else kv_len, causal)
    assert fc.get_total_flops() == B * H * pairs * 2 * (dq + dv)


@pytest.mark.cuda
@pytest.mark.parametrize("Bt,L,di,N", [(2, 1024, 8192, 16),
                                       (4, 384, 8192, 16)])
def test_selective_scan_op_is_fake_and_counts_its_flops(Bt, L, di, N):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.mamba_scan import kernel as skernel
    from repro_torch.kernels.mamba_scan import ops as sops
    _card()
    before = skernel.launches
    with FakeTensorMode():
        f = lambda *s, dt=torch.float32: torch.empty(*s, device="cuda",
                                                     dtype=dt)
        x = f(Bt, L, di, dt=torch.bfloat16)
        args = (x, f(Bt, L, di), f(di, N), f(Bt, L, N, dt=torch.bfloat16),
                f(Bt, L, N, dt=torch.bfloat16), f(di), f(Bt, di, N))
        with FlopCounterMode(display=False) as fc:
            y, h = sops.selective_scan(*args)
    assert tuple(y.shape) == (Bt, L, di) and y.dtype == torch.bfloat16
    assert tuple(h.shape) == (Bt, di, N) and h.dtype == torch.float32
    assert skernel.launches == before
    # four f32 operations per (row, step, channel, state) element
    assert fc.get_total_flops() == 4 * Bt * L * di * N


@pytest.mark.cuda
def test_kernel_ops_launch_on_real_cuda_tensors():
    """On real CUDA tensors the custom op launches the kernel once."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 128, 4, 64, device="cuda", dtype=torch.bfloat16,
                    generator=g)
    before = kernel.launches
    o = ops.flash_attention(q, q[:, :, :2], q[:, :, :2], scale=0.125)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = ref.attention_ref(q.float(), q[:, :, :2].float(),
                             q[:, :, :2].float(), scale=0.125, causal=True)
    assert float((o.float() - want).abs().max()) < TOL[torch.bfloat16]


# ------------------------------------------------------ SHA-256 of chunks
MiB = 1 << 20
_Pair = collections.namedtuple("_Pair", "a b")


def _bytes_on_card(n, seed=0):
    g = torch.Generator().manual_seed(seed + n)
    return torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 55, 56, 63, 64, 65, 119, MiB - 1, MiB,
                               MiB + 1, 7 * MiB // 2])
def test_sha256_chunks_match_hashlib(n):
    from repro_torch.cloud import wire
    from repro_torch.kernels.sha256 import kernel as sha
    _card()
    host = _bytes_on_card(n)
    want = [wire.digest_of(bytes(host.numpy()[o:o + MiB]))
            for o in range(0, n, MiB)]
    before = sha.launches
    assert sha.chunk_digests([host.cuda()]) == [want]
    assert sha.launches == before + (1 if n else 0)


@pytest.mark.cuda
def test_sha256_kernel_rows_of_any_length():
    """One launch over hand-made rows: lengths 0 (a null pointer, nothing
    read) to 129, each the truncated SHA-256 of its bytes."""
    import hashlib
    from repro_torch.kernels.sha256 import kernel as sha
    _card()
    data = _bytes_on_card(4096).cuda()
    lens = [0, 1, 55, 56, 63, 64, 65, 119, 120, 128, 129]
    n = len(lens)
    out = torch.zeros(2 * n, dtype=torch.int64, device="cuda")
    rows = [[0 if ln == 0 else data.data_ptr() + 256 * i, ln,
             out.data_ptr() + 16 * i] for i, ln in enumerate(lens)]
    sha._launch(torch.tensor(rows, dtype=torch.int64, device="cuda"), n)
    raw = out.cpu().numpy().tobytes()
    host = data.cpu().numpy()
    for i, ln in enumerate(lens):
        want = hashlib.sha256(bytes(host[256 * i:256 * i + ln])).digest()
        assert raw[16 * i:16 * i + 16] == want[:16], ln


def _views():
    """name -> (a CPU tensor, the view of it that is hashed), the view
    taken on the card of the tensor's copy there."""
    g = torch.Generator().manual_seed(7)
    f32 = torch.randn(3 * MiB // 4 + 5, generator=g)
    whole = lambda t: t
    return {
        "bf16": (torch.randn(MiB + 3, generator=g).to(torch.bfloat16), whole),
        "f32": (f32, whole),
        "int64": (torch.randint(-2 ** 62, 2 ** 62, (MiB // 8 + 9,),
                                generator=g), whole),
        "uint8": (_bytes_on_card(2 * MiB + 17), whole),
        "bool": (torch.rand(MiB + 1, generator=g) > 0.5, whole),
        "0-d": (torch.tensor(3.5), whole),
        "non-contiguous": (f32, lambda t: t[:3 * MiB // 4]
                           .reshape(3 * 256, 1024).t()),
        "odd offset": (f32, lambda t: t[1:]),
        "odd offset bf16": (torch.randn(4099, generator=g)
                            .to(torch.bfloat16), lambda t: t[3:]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_views()))
def test_sha256_chunks_of_every_dtype_and_view(name):
    from repro_torch.kernels.sha256 import kernel as sha
    _card()
    base, view = _views()[name]
    dev = view(base.cuda())
    if view(base) is not base:
        assert not dev.is_contiguous() or dev.data_ptr() % 16
    assert sha.chunk_digests([dev]) == [sha.plain(view(base))]


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [0, 1])
def test_mdss_hash_on_the_card_equals_manifest_of_its_copy(extra):
    """Just below ``CARD_HASH_CHUNKS`` chunks on the card the host path
    runs, at it the kernel, once per value; both give ``manifest_of`` of
    the value's CPU copy, digest and chunk list."""
    from repro_torch.cloud import wire
    from repro_torch.core import MDSS, default_tiers
    from repro_torch.core import mdss as mdss_mod
    from repro_torch.kernels.sha256 import kernel as sha
    from repro_torch.obs.tracing import Tracer
    _card()
    K = mdss_mod.CARD_HASH_CHUNKS
    P = _Pair
    g = torch.Generator().manual_seed(extra)
    # K - 4 chunks, 2, 1 and ``extra``: K - 1 + extra on the card
    host = {"w": torch.randn((K - 4) * MiB // 2, generator=g)
            .to(torch.bfloat16).reshape(-1, 1024),
            "mu": [torch.randn(MiB // 4 + 3, generator=g),
                   np.arange(5, dtype=np.int32)],
            "p": P(torch.tensor(2.0), _bytes_on_card(extra, 3)),
            "cpu": torch.ones(MiB + 9), "tag": "x"}
    value = {k: v for k, v in host.items()}
    value["w"] = host["w"].cuda()
    value["mu"] = [host["mu"][0].cuda(), host["mu"][1]]
    value["p"] = P(host["p"].a.cuda(), host["p"].b.cuda())
    assert mdss_mod.hashes_on_card(value) is bool(extra)
    store = MDSS(default_tiers(cloud_device="cpu"))
    store.tracer = Tracer()
    before = sha.launches
    got = store._hash("v", value)
    assert sha.launches == before + extra
    assert got == wire.manifest_of(host)
    (sha_span,) = [s for s in store.tracer.spans()
                   if s.name == "mdss.sha256"]
    dev_bytes = sum(t.nbytes for t in (value["w"], value["mu"][0],
                                       value["p"].a, value["p"].b))
    assert sha_span.attrs["card_bytes"] == (dev_bytes if extra else 0)
