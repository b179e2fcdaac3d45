"""The whole training step's share of the card's bf16 peak (%): 6·N·T
per step, N the parameters less the input embedding, T the step's
tokens, over the window's wall time per step, over 989 TFLOP/s."""
from portbench.lib import roofline


def read(r):
    n = r.extra.get("n_params_no_embed")
    if not n or not r.units:
        return None
    flops = sum(roofline.lm_train_flops(n, u["tokens"]) for u in r.units)
    return 100.0 * flops / r.window_s / roofline.PEAK_FLOPS["bfloat16"]
