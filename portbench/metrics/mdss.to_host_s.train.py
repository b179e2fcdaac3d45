"""Seconds per training step in ``mdss.to_host`` spans: MDSS copying the
values it hashes (the step's new params and AdamW state) off the card,
summed over the spans that start in the window."""
from portbench.lib.program_spans import per_step


def read(r):
    return per_step(r, "mdss.to_host")
