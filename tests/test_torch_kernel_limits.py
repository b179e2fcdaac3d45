"""The kernels' wrappers at every head dim, state width and batch the
reference runs, held against the JAX package on the same numpy inputs.

On the card one launch of flash attention takes at most 128 columns of v
and 65535 batch rows and q heads, and one launch of the selective scan
65535 batch rows; the wrappers cut larger calls into such launches
(``kernel._passes``, ``kernel._run``), and make a last dim that is not
contiguous contiguous first. Here ``_run`` is driven with a stand-in for
the launch that refuses whatever one launch cannot take and computes the
rest with the plain version, and the grid limit is lowered so that the
batch and head runs are cut as well. The result is held against the
reference's Pallas kernels in interpret mode (the reference's wrapper
pads any head dim to 128 lanes) and its plain versions, at the
reference's tolerances: f32 2e-5, bf16 2e-2, the scan's h_last 2e-4
(``tests/test_kernels.py``). The kernels themselves run these shapes on
the card in ``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.

Last, the port's ``Model`` against the JAX ``Model`` at 1e-4 with a head
dim past 256 (reduced tinyllama, ``head_dim=320``) and a state past 16
(reduced falcon-mamba, ``ssm_state=32``), at ``test_torch_archs.py``'s
bounds.
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
from repro.data.pipeline import SyntheticLMData as JData
from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.flash_attention.ops import flash_attention_kernel_call
from repro.kernels.mamba_scan import ref as jss_ref
from repro.kernels.mamba_scan.kernel import selective_scan_fwd as jss_fwd
from repro.models.model_zoo import Model as JModel
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.mamba_scan import kernel as ss_kernel
from repro_torch.kernels.mamba_scan import ref as ss_ref
from repro_torch.models.model_zoo import Model
from repro_torch.models.params import from_reference

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
H_TOL = 2e-4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRID = 3     # the lowered grid limit: cuts B = 4 rows and G = 4 q heads


# ------------------------------------------------------------ flash attention
class FlashStandIn:
    """One launch: refuses what the kernel cannot take in one launch,
    computes the rest with the plain version into its output view."""

    def __init__(self):
        self.passes = []

    def __call__(self, body, q, k, v, o, scale, causal, kv_len):
        B, _, H, dq = q.shape
        assert v.shape[3] <= fa_kernel.MAX_DV, f"dv {v.shape[3]} in a pass"
        assert B <= fa_kernel.MAX_GRID and H <= fa_kernel.MAX_GRID
        assert all(t.stride(3) == 1 for t in (q, k, v, o))
        assert body == ("f32" if q.dtype == torch.float32 else body)
        assert body != "tma" or dq <= fa_kernel.MAX_DQ, "tma past dq 256"
        o.copy_(fa_ref.attention_ref(q, k, v, scale=scale, causal=causal,
                                     kv_len=kv_len))
        self.passes.append((B, H, k.shape[2], dq, v.shape[3]))


def _fa_inputs(B, S, H, KV, dq, dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, dq)).astype(np.float32),
            rng.normal(size=(B, S, KV, dq)).astype(np.float32),
            rng.normal(size=(B, S, KV, dv)).astype(np.float32))


@pytest.mark.parametrize("dq,dv", [(264, 136), (320, 320), (192, 256),
                                   (576, 512)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_passes_match_the_reference(monkeypatch, dq, dv, causal,
                                          dtype):
    """Column blocks of v and o, batch runs and q-head runs (GQA 4:1, the
    head runs cutting kv groups at the lowered limit) against the
    reference's padded Pallas kernel and its plain version."""
    monkeypatch.setattr(fa_kernel, "MAX_GRID", GRID)
    B, S, H, KV = 4, 40, 8, 2
    xs = _fa_inputs(B, S, H, KV, dq, dv, seed=dq + dv)
    scale = dq ** -0.5
    jx = [jnp.asarray(x, JDT[dtype]) for x in xs]
    pallas = np.asarray(flash_attention_kernel_call(
        *jx, scale=scale, causal=causal, interpret=True), np.float32)
    plain = np.asarray(jfa_ref.attention_ref(*jx, scale=scale,
                                             causal=causal), np.float32)
    launch = FlashStandIn()
    got = fa_kernel._run(*(torch.from_numpy(x).to(TDT[dtype]) for x in xs),
                         scale, causal, None, None, launch)
    assert got.shape == (B, S, H, dv) and got.dtype == TDT[dtype]
    # batch runs [0, 3) and [3, 4), each kv head's q heads [0, 3) and
    # [3, 4), and ceil(dv / 128) column blocks
    assert len(launch.passes) == 2 * KV * 2 * -(-dv // 128)
    tol = TOL[dtype]
    for want in (pallas, plain):
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("dq,dv,body", [(264, 136, "mma"), (320, 320, "mma"),
                                        (192, 256, "tma"), (64, 64, "tma")])
def test_flash_picks_the_body_that_takes_the_head_dims(dq, dv, body):
    """bf16 past dq 256 goes to the mma body, which streams q and k in
    head-dim slices; up to 256 the tma body keeps its inputs, whatever dv
    (its column blocks start at multiples of 256 B)."""
    q, k, v = (torch.zeros(s, dtype=torch.bfloat16) for s in
               ((1, 8, 4, dq), (1, 8, 2, dq), (1, 8, 2, dv)))
    assert fa_kernel._body(q, k, v) == body
    launch = FlashStandIn()
    fa_kernel._run(q, k, v, 1.0, True, None, None, launch)
    assert launch.passes == [(1, 4, 2, dq, min(dv - c0, 128))
                             for c0 in range(0, dv, 128)]


def test_flash_call_within_the_limits_is_one_pass_of_the_whole_tensors():
    q, k, v = (torch.randn(s) for s in ((2, 16, 4, 64), (2, 16, 2, 64),
                                       (2, 16, 2, 128)))
    seen = []
    o = fa_kernel._run(q, k, v, 0.125, True, None, None,
                       lambda body, *a: seen.append((body, a)))
    (body, (qp, kp, vp, op, *_)), = seen
    assert body == "f32" and op.data_ptr() == o.data_ptr()
    assert all(a.shape == b.shape and a.data_ptr() == b.data_ptr()
               for a, b in ((qp, q), (kp, k), (vp, v)))


def test_flash_copies_a_strided_head_dim_contiguous():
    """A last dim that is not contiguous goes to the kernel as a copy
    (the reference transposes and pads whatever it is given)."""
    xs = _fa_inputs(1, 24, 4, 2, 16, 16, seed=9)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(
        np.repeat(x, 2, axis=3)))[..., ::2] for x in xs)
    assert q.stride(3) == 2
    launch = FlashStandIn()
    got = fa_kernel._run(q, k, v, 0.25, False, 20, None, launch)
    want = np.asarray(jfa_ref.attention_ref(
        *(jnp.asarray(x) for x in xs), scale=0.25, causal=False, kv_len=20))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert len(launch.passes) == 1


def test_flash_still_refuses_what_the_reference_refuses():
    q, k = torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="not a multiple"):
        fa_kernel._run(q, k, k, 1.0, True, None, None, FlashStandIn())
    odd = torch.zeros(1, 8, 2, 5, dtype=torch.bfloat16)    # head dim 5
    with pytest.raises(ValueError, match="tma body cannot"):
        fa_kernel._run(odd, odd, odd, 1.0, True, None, "tma",
                       FlashStandIn())
    wide = torch.zeros(1, 8, 2, 264, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tma body cannot"):
        fa_kernel._run(wide, wide, wide, 1.0, True, None, "tma",
                       FlashStandIn())


# ------------------------------------------------------------- selective scan
class ScanStandIn:
    """One launch: refuses more than ``MAX_GRID`` rows and any input the
    kernel would not address, computes the plain scan into y, h_last."""

    def __init__(self):
        self.rows = []

    def __call__(self, x, dt, A, B, C, D, h0, y, h_last):
        assert x.shape[0] <= ss_kernel.MAX_GRID
        assert all(t.stride(-1) == 1 for t in (x, dt, B, C))
        assert all(t.is_contiguous() for t in (A, D, h0, y, h_last))
        yr, hr = ss_ref.selective_scan_ref(x, dt, A, B, C, D, h0)
        y.copy_(yr)
        h_last.copy_(hr)
        self.rows.append(x.shape[0])


def _ss_inputs(Bt, L, di, N, seed):
    """x, dt, A, B, C, D, h0 as numpy f32, drawn as the reference's
    ``_scan_args``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return [rng.normal(size=(Bt, L, di)).astype(f32),
            rng.uniform(1e-3, 0.1, (Bt, L, di)).astype(f32),
            -rng.uniform(0.5, 2.0, (di, N)).astype(f32),
            rng.normal(size=(Bt, L, N)).astype(f32),
            rng.normal(size=(Bt, L, N)).astype(f32),
            rng.normal(size=(di,)).astype(f32),
            rng.normal(size=(Bt, di, N)).astype(f32)]


def _as(args, dtype, lib):
    """x, B and C in ``dtype``; dt, A, D, h0 f32 (the model's mix)."""
    if lib == "jax":
        return [jnp.asarray(a, JDT[dtype] if i in (0, 3, 4) else jnp.float32)
                for i, a in enumerate(args)]
    return [torch.from_numpy(a).to(TDT[dtype] if i in (0, 3, 4)
                                   else torch.float32)
            for i, a in enumerate(args)]


@pytest.mark.parametrize("N", [17, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_at_wide_states_matches_the_reference(monkeypatch, N, dtype):
    """N past the kernel's narrow body, in batch runs of at most the
    lowered limit, against the reference's Pallas kernel and its plain
    version."""
    monkeypatch.setattr(ss_kernel, "MAX_GRID", GRID)
    Bt, L, di = 4, 64, 32
    args = _ss_inputs(Bt, L, di, N, seed=N)
    ja = _as(args, dtype, "jax")
    want = [jss_fwd(*ja, chunk=32, block_d=16, interpret=True),
            jss_ref.selective_scan_ref(*ja, chunk=32)]
    launch = ScanStandIn()
    y, h = ss_kernel._run(*_as(args, dtype, "torch"), launch)
    assert launch.rows == [3, 1]
    assert y.dtype == TDT[dtype] and h.dtype == torch.float32
    tol = TOL[dtype]
    for y_want, h_want in want:
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(y_want, np.float32),
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_want),
                                   atol=H_TOL)


def test_scan_copies_strided_inputs_contiguous():
    """x with a strided channel dim, A and h0 transposed views: copied,
    not refused."""
    args = _ss_inputs(2, 40, 16, 20, seed=3)
    x, dt, A, B, C, D, h0 = _as(args, "float32", "torch")
    xs = torch.stack([x, x], -1)[..., 0]
    At = A.t().contiguous().t()
    h0t = h0.transpose(1, 2).contiguous().transpose(1, 2)
    assert xs.stride(2) == 2 and not At.is_contiguous()
    launch = ScanStandIn()
    y, h = ss_kernel._run(xs, dt, At, B, C, D, h0t, launch)
    y_want, h_want = jss_ref.selective_scan_ref(*_as(args, "float32", "jax"))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=H_TOL)


# ---------------------------------------------------------------- the models
S, B = 32, 2
ATOL = 1e-4
TRAIN_RTOL = {"loss": 1e-5, "xent": 1e-5, "grad_norm": 1e-4}


def _prefill_batch(batch):
    pb = {k: v for k, v in batch.items() if k != "labels"}
    pb["tokens"] = pb["tokens"][:, :S // 2]
    return pb


@pytest.mark.parametrize("arch,override", [
    ("tinyllama-1.1b", {"head_dim": 320}),
    ("falcon-mamba-7b", {"ssm_state": 32}),
])
def test_model_past_the_old_limits_matches_reference(arch, override):
    """Prefill and two greedy decode steps' logits at 1e-4, and one
    train step's loss, xent (rel 1e-5) and grad_norm (rel 1e-4), against
    the reference's Model from the same params and batch."""
    jcfg = jreduced(jget_config(arch), **override)
    cfg = reduced(get_config(arch), **override)
    jp = JModel(JRunConfig(model=jcfg, shape=JShape("t", S, B, "train"))
                ).init_params(jax.random.PRNGKey(0))
    p = from_reference(jax.tree.map(np.asarray, jp))
    jbatch = JData(jcfg, JShape("t", S, B, "train")).batch(0)
    batch = SyntheticLMData(cfg, ShapeProfile("t", S, B, "train")).batch(0)

    jm = JModel(JRunConfig(model=jcfg, shape=JShape("d", S, B, "decode"),
                           remat="none"))
    m = Model(RunConfig(model=cfg, shape=ShapeProfile("d", S, B, "decode"),
                        remat="none"))
    jl, jc = jax.jit(jm.prefill)(jp, _prefill_batch(jbatch),
                                 jm.init_cache())
    tl, tc = m.prefill(p, _prefill_batch(batch), m.init_cache())
    jstep = jax.jit(jm.decode_step)
    for step in range(3):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        if step == 2:
            break
        jtok, ttok = jnp.argmax(jl, -1), torch.argmax(tl, -1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jstep(jp, jtok, jc)
        tl, tc = m.decode_step(p, ttok, tc)

    jm = JModel(JRunConfig(model=jcfg, shape=JShape("t", S, B, "train"),
                           remat="none"))
    m = Model(RunConfig(model=cfg, shape=ShapeProfile("t", S, B, "train"),
                        remat="full"))
    _, _, jmet = jax.jit(jm.train_step)(jp, jm.opt_init(jp), jbatch)
    _, _, met = m.train_step(p, m.opt_init(p), batch)
    for k, rtol in TRAIN_RTOL.items():
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=rtol,
                                   atol=0, err_msg=k)
