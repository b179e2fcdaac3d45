"""The port's selective scan held against the JAX package's: its plain
versions against ``repro``'s ``selective_scan_ref``, the Pallas kernel (in
interpret mode, as ``tests/test_kernels.py`` runs it), ``selective_step_ref``
and the closed-form ``_cf_scan``, on the same numpy inputs; and CPU
dispatch. The Hopper kernel itself is held against its plain version on
the card in ``test_torch_kernels_cuda.py`` and by ``chip_smoke.py``.

Tolerances: y at the reference's f32 2e-5 / bf16 2e-2 and h_last at its
2e-4 (``tests/test_kernels.py``); both sides run the same associative
scan in f32, so only the order of a few sums differs. The closed-form
path with bf16 scan pairs is held at 2e-2: both sides round the pairs to
bf16 at the same points, and f32 sums in another order can move a value
across a bf16 rounding boundary.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import ops as jops
from repro.kernels.mamba_scan import ref as jref
from repro.kernels.mamba_scan.kernel import selective_scan_fwd as jfwd
from repro_torch.kernels.mamba_scan import kernel, ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
H_TOL = 2e-4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(Bt, L, di, N, seed):
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


def _jax(args, dtype):
    """x, B and C in ``dtype``; dt, A, D, h0 f32 (the model's mix)."""
    return [jnp.asarray(a, JDT[dtype] if i in (0, 3, 4) else jnp.float32)
            for i, a in enumerate(args)]


def _torch(args, dtype):
    return [torch.from_numpy(a).to(TDT[dtype] if i in (0, 3, 4)
                                   else torch.float32)
            for i, a in enumerate(args)]


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t, np.float32))


@pytest.mark.parametrize("Bt,L,di,N,chunk,block_d", [
    (1, 64, 32, 8, 16, 32),
    (2, 128, 64, 16, 32, 32),
    (2, 96, 48, 16, 32, 16),      # L not a power of two
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_and_pallas(Bt, L, di, N, chunk, block_d,
                                            dtype):
    args = _inputs(Bt, L, di, N, seed=L + di)
    ja = _jax(args, dtype)
    y_ref, h_ref = jref.selective_scan_ref(*ja, chunk=chunk)
    y_pl, h_pl = jfwd(*ja, chunk=chunk, block_d=block_d, interpret=True)
    y, h = ref.selective_scan_ref(*_torch(args, dtype), chunk=chunk)
    assert y.dtype == TDT[dtype] and h.dtype == torch.float32
    tol = TOL[dtype]
    for want_y, want_h in ((y_ref, h_ref), (y_pl, h_pl)):
        np.testing.assert_allclose(_np(y), _np(want_y), atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(h), _np(want_h), atol=H_TOL)
    # the CPU dispatch (closed-form path) agrees as well
    y2, h2 = ops.selective_scan(*_torch(args, dtype), chunk=chunk)
    np.testing.assert_allclose(_np(y2), _np(y_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(h2), _np(h_ref), atol=H_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_length_matches_reference(dtype):
    """L = 200 with chunk 64: a ragged last chunk (the Pallas kernel
    asserts L % chunk == 0; the reference's plain version takes any L)."""
    args = _inputs(2, 200, 40, 5, seed=7)
    y_ref, h_ref = jref.selective_scan_ref(*_jax(args, dtype), chunk=64)
    y, h = ref.selective_scan_ref(*_torch(args, dtype), chunk=64)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(h), _np(h_ref), atol=H_TOL)


def test_step_matches_reference_and_scan():
    """Decode's single step against ``selective_step_ref``, and stepped
    one token at a time against the scan."""
    Bt, L, di, N = 2, 8, 16, 4
    args = _inputs(Bt, L, di, N, seed=3)
    x, dt, A, B, C, D, h0 = _torch(args, "float32")
    jx, jdt, jA, jB, jC, jD, jh0 = _jax(args, "float32")
    h, jh = h0, jh0
    ys = []
    for t in range(L):
        y_t, h = ops.selective_step(x[:, t], dt[:, t], A, B[:, t], C[:, t],
                                    D, h)
        jy_t, jh = jref.selective_step_ref(jx[:, t], jdt[:, t], jA, jB[:, t],
                                           jC[:, t], jD, jh)
        np.testing.assert_allclose(_np(y_t), _np(jy_t), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(_np(h), _np(jh), atol=2e-5)
        ys.append(y_t)
    y_scan, h_scan = ref.selective_scan_ref(x, dt, A, B, C, D, h0, chunk=8)
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(y_scan),
                               atol=1e-4)
    np.testing.assert_allclose(_np(h), _np(h_scan), atol=1e-4)


def test_chunk_invariance():
    """Chunk size must not change results (cross-chunk carry)."""
    args = _torch(_inputs(1, 64, 16, 8, seed=4), "float32")
    y1, h1 = ref.selective_scan_ref(*args, chunk=8)
    y2, h2 = ref.selective_scan_ref(*args, chunk=64)
    y3, h3 = ref.cf_scan(*args, chunk=24)
    for y, h in ((y2, h2), (y3, h3)):
        np.testing.assert_allclose(_np(y1), _np(y), atol=1e-4)
        np.testing.assert_allclose(_np(h1), _np(h), atol=1e-4)


@pytest.mark.parametrize("scan_dtype,tol", [("float32", 2e-5),
                                            ("bfloat16", 2e-2)])
@pytest.mark.parametrize("chunk", [32, 96])
def test_closed_form_matches_reference(scan_dtype, tol, chunk):
    """The CPU path against ``ops._cf_scan`` with its pairs materialized
    in ``scan_dtype``; chunk 32 of L=96 carries state across chunks."""
    args = _inputs(2, 96, 24, 8, seed=5)
    y_ref, h_ref = jops._cf_scan(*_jax(args, "float32"), chunk,
                                 jnp.dtype(scan_dtype))
    y, h = ref.cf_scan(*_torch(args, "float32"), chunk=chunk,
                       sdt=TDT[scan_dtype])
    assert h.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(h), _np(h_ref), atol=tol, rtol=tol)
    # the public op: the reference's mem chunk (whole L here) and dtype
    y_op, _ = ops.selective_scan(*_torch(args, "float32"), chunk=chunk,
                                 scan_dtype=scan_dtype)
    y_jop, _ = jops.selective_scan(*_jax(args, "float32"), chunk=chunk,
                                   scan_dtype=scan_dtype)
    np.testing.assert_allclose(_np(y_op), _np(y_jop), atol=tol, rtol=tol)


def test_cpu_dispatch_takes_plain_version_and_launches_nothing(monkeypatch):
    monkeypatch.setattr(kernel, "launches", 0)
    args = _torch(_inputs(1, 40, 8, 4, seed=6), "float32")
    got = ops.selective_scan(*args, chunk=16)
    want = ref.cf_scan(*args, chunk=ops._mem_chunk(16, args[0]))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernel.launches == 0


def test_cuda_tensors_go_to_the_kernel(monkeypatch):
    """A CUDA tensor never takes the plain version: it launches the
    kernel (the custom op ``_launch``, whose CUDA body is
    ``kernel.selective_scan_fwd``), or the kernel's error propagates."""
    class CudaLike:
        is_cuda = True

    calls = []

    def fake(*args):
        calls.append(len(args))
        raise RuntimeError("launch refused")

    monkeypatch.setattr(ops, "_launch", fake)
    with pytest.raises(RuntimeError, match="launch refused"):
        ops.selective_scan(*[CudaLike()] * 7, chunk=8, scan_dtype="bfloat16")
    assert calls == [7]


def test_kernel_wrapper_refuses_what_it_cannot_run():
    args = _torch(_inputs(1, 8, 8, 4, seed=8), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.selective_scan_fwd(*args)
    with pytest.raises(ValueError, match="no path"):
        ops.selective_scan(*(t.to("meta") for t in args))


def test_kernel_module_imports_without_nvcc(tmp_path):
    code = ("import torch\n"
            "from repro_torch.kernels.mamba_scan import kernel, ops\n"
            "x = torch.ones(1, 4, 8)\n"
            "ops.selective_scan(x, x, -torch.ones(8, 2), torch.ones(1, 4, 2),"
            " torch.ones(1, 4, 2), torch.ones(8), torch.zeros(1, 8, 2))\n"
            "assert kernel.launches == 0 and kernel._lib is None\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "no-cuda"),
               PYTHONPATH=os.path.join(root, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# ------------------------------------------------------------------ gradient
def _vjp_reference(args, g_y, g_h, chunk, scan_dtype):
    """``jax.vjp`` of ``_cf_scan``, compiled (op by op, the associative
    scan's VJP takes tens of seconds on the CPU) with XLA's excess
    precision off, so that the bf16 pairs are rounded at every op, as the
    op-by-op run rounds them (with it on, XLA keeps fused bf16
    intermediates in f32)."""
    import jax

    def vjp(a, cot):
        return jax.vjp(lambda *a: jops._cf_scan(*a, chunk,
                                                jnp.dtype(scan_dtype)),
                       *a)[1](cot)
    a = (_jax(args, "float32"), (jnp.asarray(g_y), jnp.asarray(g_h)))
    return jax.jit(vjp).lower(*a).compile(
        compiler_options={"xla_allow_excess_precision": False})(*a)


def _cotangents(Bt, L, di, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Bt, L, di)).astype(np.float32),
            rng.normal(size=(Bt, di, N)).astype(np.float32))


def _grads(fn, args, g_y, g_h):
    ts = [t.requires_grad_() for t in _torch(args, "float32")]
    y, h = fn(*ts)
    return torch.autograd.grad((y, h), ts, (torch.from_numpy(g_y),
                                            torch.from_numpy(g_h)))


SWEEP = [(1, 64, 32, 8), (2, 128, 64, 16), (2, 96, 48, 16)]


@pytest.mark.parametrize("Bt,L,di,N", SWEEP)
@pytest.mark.parametrize("scan_dtype,tol", [("float32", 2e-5),
                                            ("bfloat16", 2e-2)])
def test_cpu_gradient_matches_reference_vjp(Bt, L, di, N, scan_dtype, tol):
    """The CPU Function (closed-form forward and backward, pairs in
    ``scan_dtype``) against ``jax.vjp`` of the reference's ``_cf_scan``
    at the same outer chunk: the cotangents of x, dt, A, B, C, D and h0,
    with both outputs' cotangents nonzero."""
    args = _inputs(Bt, L, di, N, seed=L + di + 1)
    g_y, g_h = _cotangents(Bt, L, di, N, seed=L)
    want = _vjp_reference(args, g_y, g_h, jops._mem_chunk(16, args[0]),
                          scan_dtype)
    got = _grads(lambda *a: ops.selective_scan(*a, chunk=16,
                                               scan_dtype=scan_dtype),
                 args, g_y, g_h)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("chunk", [32, 96])
def test_closed_form_bwd_carries_across_chunks(chunk):
    """The reverse scan's carry across outer chunks (chunk 32 of L=96)
    against the reference's closed-form VJP at the same chunk."""
    args = _inputs(2, 96, 24, 8, seed=9)
    g_y, g_h = _cotangents(2, 96, 24, 8, seed=10)
    want = _vjp_reference(args, g_y, g_h, chunk, "float32")
    got = _grads(lambda *a: ops._ClosedFormScan.apply(*a, chunk,
                                                       torch.float32),
                 args, g_y, g_h)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-5,
                                   rtol=2e-5)


class ScanBwdStandIn:
    """One launch of the backward kernel: refuses more than ``MAX_GRID``
    rows, an input it would not address and workspaces of other shapes
    than ``bwd_workspaces`` gives; computes each row's cotangents with the
    plain ``closed_form_bwd`` into the run's outputs and row partials."""

    def __init__(self):
        self.rows = []
        self.ins = []

    def __call__(self, ins, outs, ws):
        x, dt, A, B, C, D, h0, y_bar, h_bar = ins
        Bt, L, di = x.shape
        N = A.shape[1]
        assert Bt <= kernel.MAX_GRID
        assert all(t.stride(-1) == 1 for t in (x, dt, B, C, y_bar))
        assert all(t.is_contiguous() for t in (A, D, h0, h_bar, *outs,
                                               *ws[:2]))
        want = kernel.bwd_workspaces(Bt, L, di, N)
        assert [t.shape[0] for t in ws[:2]] == [Bt, Bt]
        for name, t in zip(("hb", "part", "sums"), ws[2:]):
            shape = want[name]
            assert (t is None) == (shape is None)
            if t is not None:
                assert t.dtype == torch.float32 and t.is_contiguous()
                rows = 2 if name == "sums" else 0
                assert t.shape[rows] >= Bt
                assert t.shape[:rows] + t.shape[rows + 1:] == \
                    shape[:rows] + shape[rows + 1:]
        for r in range(Bt):
            one = [t if i in (2, 5) else t[r:r + 1]
                   for i, t in enumerate(ins)]
            dx, ddt, dA, dB, dC, dD, dh0 = ops.closed_form_bwd(*one,
                                                               chunk=L)
            for out, g in zip(outs, (dx, ddt, dB, dC, dh0)):
                out[r] = g[0]
            ws[0][r], ws[1][r] = dA, dD
        self.rows.append(Bt)
        self.ins.append(ins)


def _add_rows(dA_rows, dD_rows, dA, dD):
    dA.copy_(dA_rows.sum(0))
    dD.copy_(dD_rows.sum(0))


@pytest.mark.parametrize("Bt,L,di,N", SWEEP)
def test_kernel_function_backward_matches_reference_vjp(Bt, L, di, N,
                                                        monkeypatch):
    """The CUDA Function's wiring, on the CPU: its forward is the kernel
    and its backward the backward kernel (here the plain versions stand in
    for them, through the backward's wrapper, as the kernels run only on
    the card), against the reference's closed-form VJP at f32
    (``_scan_bwd``)."""
    calls = []

    def stand_in(*a):
        calls.append("fwd")
        return ref.selective_scan_ref(*a)

    def bwd_stand_in(*a):
        calls.append("bwd")
        return kernel._run_bwd(*a, ScanBwdStandIn(), _add_rows)

    monkeypatch.setattr(kernel, "selective_scan_fwd", stand_in)
    monkeypatch.setattr(kernel, "selective_scan_bwd", bwd_stand_in)
    args = _inputs(Bt, L, di, N, seed=L + di + 2)
    g_y, g_h = _cotangents(Bt, L, di, N, seed=L + 1)
    want = _vjp_reference(args, g_y, g_h, jops._mem_chunk(16, args[0]),
                          "float32")
    got = _grads(lambda *a: ops._KernelScan.apply(*a, 16), args, g_y, g_h)
    assert calls == ["fwd", "bwd"]
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("N", [5, 17, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_bwd_wrapper_runs_past_the_grid(monkeypatch, N, dtype):
    """More batch rows than one launch takes (the limit lowered to 3):
    runs of 3 and 1 rows, each on its views of the outputs, then dA and
    dD added over every row once; the cotangents, each in its input's
    dtype, against the plain backward of the whole batch and, at f32,
    the reference's closed-form VJP."""
    monkeypatch.setattr(kernel, "MAX_GRID", 3)
    Bt, L, di = 4, 40, 12
    args = _inputs(Bt, L, di, N, seed=N)
    g_y, g_h = _cotangents(Bt, L, di, N, seed=N + 1)
    ts = _torch(args, dtype)
    cots = (torch.from_numpy(g_y).to(TDT[dtype]), torch.from_numpy(g_h))
    launch = ScanBwdStandIn()
    got = kernel._run_bwd(*ts, *cots, launch, _add_rows)
    assert launch.rows == [3, 1]
    assert [g.dtype for g in got] == [t.dtype for t in ts]
    plain = ops.closed_form_bwd(*ts, *cots, chunk=L)
    tol = TOL[dtype]
    for a, b in zip(got, plain):
        np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)
    if dtype == "float32":
        want = _vjp_reference(args, g_y, g_h, L, "float32")
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=tol,
                                       rtol=tol)


def test_kernel_bwd_workspaces():
    """The backward's f32 workspaces: at the train cell's shape the state
    entering each of 63 later tiles (66 MB) and 256 channel blocks'
    partials of dB and dC; a group's partials only past 16 state columns;
    one launch's rows at most; no tile state for a single tile."""
    ws = kernel.bwd_workspaces(2, 2048, 8192, 16)
    assert ws == {"hb": (2, 63, 8192, 16), "part": (2, 256, 2048, 32),
                  "sums": None, "dA_rows": (2, 8192, 16),
                  "dD_rows": (2, 8192)}
    assert 4 * np.prod(ws["hb"]) == 66_060_288
    assert kernel.bwd_workspaces(2, 463, 1000, 17)["sums"] == (
        2, 2, 2, 463, 1000)
    assert kernel.bwd_workspaces(2, 463, 1000, 17)["part"] == (
        2, 32, 463, 34)
    big = kernel.bwd_workspaces(70000, 32, 8, 4)
    assert big["hb"] == (65535, 0, 8, 4) and big["dA_rows"] == (70000, 8, 4)
    assert big["part"] == (65535, 1, 32, 8)


def _bad_bwd_args(case):
    x, dt, A, B, C, D, h0 = _torch(_inputs(2, 8, 6, 4, seed=12), "bfloat16")
    y_bar, h_bar = torch.zeros(2, 8, 6, dtype=torch.bfloat16), \
        torch.zeros(2, 6, 4)
    return {"y_bar dtype": (x, dt, A, B, C, D, h0, y_bar.float(), h_bar),
            "hlast_bar dtype": (x, dt, A, B, C, D, h0, y_bar, h_bar.double()),
            "y_bar shape": (x, dt, A, B, C, D, h0, y_bar[:, :4], h_bar),
            "hlast_bar shape": (x, dt, A, B, C, D, h0, y_bar, h_bar[..., :2]),
            "x float16": (x.half(), dt, A, B.half(), C.half(), D, h0,
                          y_bar.half(), h_bar),
            "dt bfloat16": (x, dt.bfloat16(), A, B, C, D, h0, y_bar, h_bar),
            "B shape": (x, dt, A, B[:, :4], C, D, h0, y_bar, h_bar),
            "empty": (x[:, :0], dt[:, :0], A, B[:, :0], C[:, :0], D, h0,
                      y_bar[:, :0], h_bar)}[case]


@pytest.mark.parametrize("case,error,match", [
    ("y_bar dtype", TypeError, "y_bar in x's dtype"),
    ("hlast_bar dtype", TypeError, "float32 hlast_bar"),
    ("y_bar shape", ValueError, "y_bar"),
    ("hlast_bar shape", ValueError, "hlast_bar"),
    ("x float16", TypeError, "float32 or bfloat16 x"),
    ("dt bfloat16", TypeError, "float32 dt"),
    ("B shape", ValueError, "B"),
    ("empty", ValueError, "empty dim"),
])
def test_kernel_bwd_wrapper_checks_its_arguments(case, error, match):
    """What the backward kernel cannot take raises before any launch."""
    launch = ScanBwdStandIn()
    with pytest.raises(error, match=match):
        kernel._run_bwd(*_bad_bwd_args(case), launch, _add_rows)
    assert launch.rows == []


def test_kernel_bwd_refuses_cpu_tensors():
    args = _torch(_inputs(1, 8, 8, 4, seed=8), "float32")
    with pytest.raises(ValueError, match="selective_scan_bwd takes CUDA"):
        kernel.selective_scan_bwd(*args, torch.zeros(1, 8, 8),
                                  torch.zeros(1, 8, 4))
    assert kernel.bwd_launches == 0


def test_kernel_bwd_wrapper_takes_views():
    """B and C strided in time (slices of the x_proj output) reach the
    launch as they are; y_bar with a strided channel dim and A, h0 as
    transposed views are copied first."""
    Bt, L, di, N = 2, 24, 8, 4
    x, dt, A, _, _, D, h0 = _torch(_inputs(Bt, L, di, N, seed=13),
                                   "float32")
    proj = torch.randn(Bt, L, 3 + 2 * N)
    B, C = proj[..., 3:3 + N], proj[..., 3 + N:]
    g_y, g_h = _cotangents(Bt, L, di, N, seed=14)
    y_bar = torch.from_numpy(g_y)
    ys = torch.stack([y_bar, y_bar], -1)[..., 0]
    At = A.t().contiguous().t()
    h0t = h0.transpose(1, 2).contiguous().transpose(1, 2)
    assert ys.stride(2) == 2 and not At.is_contiguous()
    launch = ScanBwdStandIn()
    got = kernel._run_bwd(x, dt, At, B, C, D, h0t, ys,
                          torch.from_numpy(g_h), launch, _add_rows)
    ins = launch.ins[0]
    assert ins[3].data_ptr() == B.data_ptr() and ins[3].stride(1) == 3 + 2 * N
    assert ins[7].stride(-1) == 1
    want = ops.closed_form_bwd(x, dt, A, B, C, D, h0, y_bar,
                               torch.from_numpy(g_h), chunk=L)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16"])
def test_cpu_backward_stays_closed_form(monkeypatch, scan_dtype):
    """CPU tensors take ``_ClosedFormScan``: its gradients are those of
    ``closed_form_bwd`` at the path's outer chunk and ``scan_dtype``, bit
    for bit, and the backward kernel is neither called nor counted."""
    def refused(*a):
        raise AssertionError("the backward kernel on a CPU path")

    monkeypatch.setattr(kernel, "selective_scan_bwd", refused)
    monkeypatch.setattr(kernel, "bwd_launches", 0)
    args = _inputs(2, 40, 12, 6, seed=15)
    g_y, g_h = _cotangents(2, 40, 12, 6, seed=16)
    got = _grads(lambda *a: ops.selective_scan(*a, chunk=16,
                                               scan_dtype=scan_dtype),
                 args, g_y, g_h)
    ts = _torch(args, "float32")
    want = ops.closed_form_bwd(*ts, torch.from_numpy(g_y),
                               torch.from_numpy(g_h),
                               chunk=ops._mem_chunk(16, ts[0]),
                               sdt=TDT[scan_dtype])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernel.bwd_launches == 0


def test_bwd_op_is_fake_and_counts_its_flops():
    """On fake tensors the backward's custom op gives each cotangent's
    shape and dtype without a launch; FlopCounterMode counts
    ``bwd_flops``, 19 per (row, step, channel, state) element."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    Bt, L, di, N = 2, 2048, 8192, 16
    bf = torch.bfloat16
    with FakeTensorMode():
        f = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt)
        args = (f(Bt, L, di, dt=bf), f(Bt, L, di), f(di, N),
                f(Bt, L, N, dt=bf), f(Bt, L, N, dt=bf), f(di), f(Bt, di, N),
                f(Bt, L, di, dt=bf), f(Bt, di, N))
        with FlopCounterMode(display=False) as fc:
            outs = torch.ops.repro_torch.selective_scan_bwd(*args)
    assert [(tuple(o.shape), o.dtype) for o in outs] == [
        (tuple(a.shape), a.dtype) for a in args[:7]]
    assert fc.get_total_flops() == 19 * Bt * L * di * N
    assert kernel.bwd_launches == 0
