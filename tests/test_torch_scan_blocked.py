"""The port's two-level blocked selective scan held against the JAX
package's ``selective_scan_blocked`` and against ``selective_scan_ref``
(both sides' and the port's), on the same numpy inputs: the reference's
sweep and ragged lengths.

Tolerances are the reference's (``tests/test_kernels.py``): y f32 2e-5 /
bf16 2e-2, h_last 2e-4. The blocked form associates the recurrence in
another order than the associative scan, so only f32 rounding differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import ref as jref
from repro_torch.kernels.mamba_scan import ref

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
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def _check(args, dtype, block, chunk=8192):
    ja, ta = _jax(args, dtype), _torch(args, dtype)
    y, h = ref.selective_scan_blocked(*ta, block=block, chunk=chunk)
    assert y.dtype == TDT[dtype] and h.dtype == torch.float32
    tol = TOL[dtype]
    wants = [jref.selective_scan_blocked(*ja, block=block, chunk=chunk),
             jref.selective_scan_ref(*ja, chunk=64),
             ref.selective_scan_ref(*ta, chunk=64)]
    for want_y, want_h in wants:
        np.testing.assert_allclose(_np(y), _np(want_y), atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(h), _np(want_h), atol=H_TOL)


@pytest.mark.parametrize("Bt,L,di,N,block", [
    (1, 64, 32, 8, 16),
    (2, 128, 64, 16, 32),
    (2, 96, 48, 16, 32),      # L not a power of two
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_matches_reference_sweep(Bt, L, di, N, block, dtype):
    _check(_inputs(Bt, L, di, N, seed=L + di), dtype, block)


@pytest.mark.parametrize("L,block,chunk", [
    (200, 32, 8192),          # 6 blocks and an 8-step tail
    (37, 8, 8192),            # 4 blocks and a 5-step tail
    (200, 32, 64),            # chunks carry the state, each with a tail
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_ragged_length_matches_reference(L, block, chunk, dtype):
    _check(_inputs(2, L, 24, 16, seed=L), dtype, block, chunk)
