"""Nearest-rank p95 (ms) of each request's ``frontdoor.request`` less its
``frontdoor.wait``: from its flush's start to its row handed back, over
the requests submitted in the window before the traced stretch opened."""
from portbench.lib.program_spans import p95, requests_ms


def read(r):
    got = requests_ms(r)
    return p95([s for _, s in got]) if got else None
