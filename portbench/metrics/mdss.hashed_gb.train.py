"""GB per training step that MDSS hashed: the ``bytes`` of the
``mdss.sha256`` spans that start in the window, over 1e9."""
from portbench.lib.program_spans import per_step


def read(r):
    got = per_step(r, "mdss.sha256", lambda s: s[3]["bytes"])
    return None if got is None else got / 1e9
