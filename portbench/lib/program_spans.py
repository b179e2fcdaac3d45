"""Arithmetic over the program's own spans (``r.program_spans()``) that
the MDSS and batching readers share: sums per window step, and each
FrontDoor request's wait and service. Each returns None where the run
holds no such span, as a program without them gives."""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

from portbench.lib.readers import window_spans


def per_step(r, label: str,
             value: Callable[[tuple], float] = lambda s: s[2] - s[1]
             ) -> Optional[float]:
    """``value`` summed over the ``label`` spans that start in the window,
    per timed unit (seconds, by default)."""
    spans = window_spans(r, label)
    if not spans or not r.units:
        return None
    return sum(value(s) for s in spans) / len(r.units)


def p95(values: List[float]) -> float:
    """Nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def requests_ms(r) -> List[Tuple[float, float]]:
    """(wait ms, service ms) of each FrontDoor request submitted in the
    window before the traced stretch opened (the stretch makes requests
    pile up): ``frontdoor.wait`` runs from its submission to its flush's
    start, the rest of its ``frontdoor.request`` from there to its row
    handed back. Without a stretch, every request of the window."""
    a, b = r.t_window
    cut = getattr(r._stretch, "t0", b)
    spans = r.program_spans()
    waits = {s[3]["trace"]: s[2] - s[1] for s in spans
             if s[0] == "frontdoor.wait"}
    out = []
    for label, t0, t1, attrs in spans:
        if label != "frontdoor.request" or not a <= t0 < cut:
            continue
        wait = waits.get(attrs["trace"])
        if wait is not None:
            out.append((1e3 * wait, 1e3 * (t1 - t0 - wait)))
    return out
