"""Seconds per training step in the ``exec`` span: the train step's
forward, backward and AdamW on the card, to a synchronize."""
from portbench.lib.readers import mean_span_s


def read(r):
    return mean_span_s(r, "exec")
