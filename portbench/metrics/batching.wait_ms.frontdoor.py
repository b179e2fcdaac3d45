"""Nearest-rank p95 (ms) of each request's ``frontdoor.wait``, from its
submission to the start of its bucket's fused call, over the requests
submitted in the window before the traced stretch opened."""
from portbench.lib.program_spans import p95, requests_ms


def read(r):
    got = requests_ms(r)
    return p95([w for w, _ in got]) if got else None
