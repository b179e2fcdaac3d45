"""Selective-scan dispatch: the Hopper kernel for CUDA tensors, the plain
closed-form path for CPU tensors.

A CUDA tensor launches the kernel (``kernel.selective_scan_fwd``, whose
``launches`` counter records it) or raises; there is no fallback. Its
state lives in registers in f32, so ``scan_dtype`` does not apply there,
just as the reference's TPU kernel ignores it. A CPU tensor takes the
forward of the reference's closed-form path (``ref.cf_scan``), chunked by
``_mem_chunk`` and with its pairs materialized in ``scan_dtype``.
Forward only: the gradient (``_closed_form_bwd`` and an
``autograd.Function`` around the kernel) comes with the train path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan import kernel, ref


def _mem_chunk(chunk: int, x) -> int:
    """Outer chunk bounding the (B, chunk, d, N) working set."""
    return min(x.shape[1], max(chunk, 4096))


def selective_scan(x, dt, A, B, C, D, h0, *, chunk: int = 512,
                   scan_dtype: str = "float32"):
    """Shapes as in ``ref.selective_scan_ref``. Returns (y, h_last)."""
    if x.is_cuda:
        return kernel.selective_scan_fwd(x, dt, A, B, C, D, h0)
    if x.device.type != "cpu":
        raise ValueError(f"selective_scan: no path for {x.device} tensors")
    return ref.cf_scan(x, dt, A, B, C, D, h0, chunk=_mem_chunk(chunk, x),
                       sdt=getattr(torch, scan_dtype))


selective_step = ref.selective_step_ref
