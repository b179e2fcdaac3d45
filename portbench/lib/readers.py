"""Arithmetic the per-layer metric readers share. Each returns None
where the run holds nothing to read, never 0 for a share of a peak."""
from __future__ import annotations

import statistics
from typing import Optional

from portbench.lib import roofline


def idle_share_pct(r) -> Optional[float]:
    p = r.profile
    if not p or p["busy_s"] <= 0 or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def scan_roofline_pct(r) -> Optional[float]:
    """The frozen bound of every ``selective_scan_fwd`` call in the
    traced stretch, at its launched shapes, over the device time of the
    scan's kernels there."""
    p = r.profile
    if not p or not p["scan_calls"]:
        return None
    dev_s = sum(s for name, s in p["kernel_s"].items() if "ss_fwd" in name)
    if dev_s <= 0:
        return None
    bound_ms = 0.0
    for dims, types in p["scan_calls"]:
        (Bt, L, di), (_, N) = dims[0], dims[2]
        dtype = "bfloat16" if "BFloat16" in str(types[0]) else "float32"
        bound_ms += roofline.ss_bound_ms(Bt, L, di, N, dtype)[0]
    return 100.0 * bound_ms * 1e-3 / dev_s


def mean_span_s(r, name: str) -> Optional[float]:
    """Mean per unit of its summed ``name`` spans, (name, seconds)."""
    per = [sum(d for n, d in u["spans"] if n == name)
           for u in r.units if "spans" in u]
    return statistics.mean(per) if per else None


def window_spans(r, label: str):
    a, b = r.t_window
    return [s for s in r.program_spans() if s[0] == label and a <= s[1] <= b]
