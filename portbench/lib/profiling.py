"""The traced stretch: torch.profiler over a short steady part of the
window, read back from its Chrome trace.

``busy_s`` is the length of the union of every device interval (kernels,
copies and sets) inside the stretch, ``window_s`` the stretch's length
on the host's clock between two synchronisations; the idle share is one
minus their ratio. The stretch also gives each kernel's device time by
name, the shapes each ``repro_torch::selective_scan_fwd`` call was
launched with, and the idle gaps labelled by what the host was doing.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "portbench.stretch"


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Total length covered by ``intervals`` (start, end)."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps_of(intervals: List[Tuple[float, float]], lo: float, hi: float,
            min_len: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, each at least
    ``min_len`` long."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur and a - cur >= min_len:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
    if hi - cur >= min_len:
        out.append((cur, hi))
    return out


class Stretch:
    """``with Stretch(host_spans) as st: ...`` profiles the block on the
    card; ``st.read()`` later gives what the metric readers take from it."""

    def __init__(self, host_spans):
        self.host_spans = host_spans       # callable -> [(label, t0, t1)] perf
        self.summary: Optional[dict] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        kw = {}
        try:    # the program's steps run on the runtime's lane threads
            kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except TypeError:
            pass
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             record_shapes=True, **kw)
        self._prof.__enter__()
        with record_function(MARK):
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(*exc)
        return False

    def read(self) -> dict:
        """Parse the trace (after the window: parsing takes seconds)."""
        if self.summary is None:
            self.summary = self._read()
        return self.summary

    def _read(self) -> dict:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        mark = [e for e in events if e.get("name") == MARK
                and e.get("cat") == "user_annotation"]
        if not mark:
            raise RuntimeError("the profiler's trace lacks the stretch mark")
        # profiler µs -> host perf seconds
        off = self.t0 - float(mark[0]["ts"]) * 1e-6
        lo, hi = self.t0, self.t1
        dev, by_name, cpu, scan_calls = [], {}, [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"]) * 1e-6 + off
            b = a + float(e["dur"]) * 1e-6
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                dev.append((max(a, lo), min(b, hi)))
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
            elif cat in ("cpu_op", "user_annotation"):
                cpu.append((a, b, e["name"]))
                if e["name"] == "repro_torch::selective_scan_fwd":
                    args = e.get("args", {})
                    scan_calls.append((args.get("Input Dims"),
                                       args.get("Input type")))
        dev = [(a, b) for a, b in dev if b > a]
        busy = union_length(dev)
        return {"window_s": hi - lo, "busy_s": busy, "kernel_s": by_name,
                "scan_calls": scan_calls,
                "gaps": self._label(gaps_of(dev, lo, hi, 1e-4), cpu)}

    def _label(self, gaps, cpu) -> Dict[str, float]:
        """Idle seconds by what the host was doing at each gap's middle:
        the innermost span around it (the program's, else the harness's)
        and the innermost profiled host op inside that."""
        spans = self.host_spans()
        out: Dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            around = [(t1 - t0, lab) for lab, t0, t1 in spans if t0 <= mid <= t1]
            ops = [(e - s, n) for s, e, n in cpu
                   if s <= mid <= e and n != MARK]
            parts = [min(around)[1]] if around else []
            if ops:
                parts.append(min(ops)[1])
            label = " / ".join(parts) or "host, outside every span and op"
            out[label] = out.get(label, 0.0) + (b - a)
        return out


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k[:160], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]
