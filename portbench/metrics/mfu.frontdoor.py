"""The scoring forwards' share of the card's bf16 peak (%): 2·N·T of
every answered row (the body over its window, the head at its last
position) over the summed ``exec`` spans of the fused forwards in the
window, over 989 TFLOP/s."""
from portbench.lib import roofline
from portbench.lib.readers import window_spans


def read(r):
    spans = window_spans(r, "exec:decode")
    busy = sum(b - a for _, a, b, _ in spans)
    done = [u for u in r.units if not u["failed"]]
    if busy <= 0 or not done:
        return None
    flops = sum(roofline.lm_forward_flops(r.extra["n_body"], r.extra["n_head"],
                                          u["tokens"], 1) for u in done)
    return 100.0 * flops / busy / roofline.PEAK_FLOPS["bfloat16"]
