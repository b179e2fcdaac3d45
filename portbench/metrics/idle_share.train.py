"""Share of the traced stretch in which no kernel, copy or set ran on
the card: one minus the union of the profiler's device intervals over
the stretch's length (%)."""
from portbench.lib.readers import idle_share_pct


def read(r):
    return idle_share_pct(r)
