"""The selective scan's share of its roofline (%): the frozen
``ss_bound_ms`` of every ``repro_torch::selective_scan_fwd`` call in the
traced stretch, at its launched shapes, over the profiler's device time
of the scan's kernels (``ss_fwd*``) there."""
from portbench.lib.readers import scan_roofline_pct


def read(r):
    return scan_roofline_pct(r)
