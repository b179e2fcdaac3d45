"""Rows per fused forward over the window: the coalescer's
``frontdoor.fused_batch`` sum over its ``frontdoor.flushes`` count,
differences across the window."""


def read(r):
    a, b = r.counters.get("before"), r.counters.get("after")
    if not a or not b:
        return None
    flushes = b.get("frontdoor.flushes", 0) - a.get("frontdoor.flushes", 0)
    rows = (b.get("frontdoor.fused_batch", {}).get("sum", 0.0)
            - a.get("frontdoor.fused_batch", {}).get("sum", 0.0))
    return rows / flushes if flushes > 0 else None
