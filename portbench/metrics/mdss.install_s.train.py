"""Seconds per training step in the ``install`` span: MDSS publishing
the step's outputs (hashing the new params and AdamW state)."""
from portbench.lib.readers import mean_span_s


def read(r):
    return mean_span_s(r, "install")
