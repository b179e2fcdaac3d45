"""Seconds per training step in ``mdss.sha256`` spans: MDSS's SHA-256
over the host bytes of the values it hashes, summed over the spans that
start in the window."""
from portbench.lib.program_spans import per_step


def read(r):
    return per_step(r, "mdss.sha256")
