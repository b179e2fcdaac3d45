"""Peaks of one H100 and the work arithmetic the per-layer metrics use.

Peaks are NVIDIA's data sheet for the SXM part, dense, at its 700 W
limit; a run records the card's power limit beside its numbers.
``ss_bound_ms`` is a frozen copy of the bound the port's smoke script
uses for the selective scan; ``lm_train_flops`` the 6·N·T model count.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# special-function units: 16 exponentials per clock per SM, 132 SMs at
# the boost clock
SFU_EXP_PER_S = 16 * 132 * 1.98e9


def scan_flops(Bt: int, L: int, di: int, N: int) -> int:
    """The recurrence's f32 FLOPs, four per (row, step, channel, state)."""
    return 4 * Bt * L * di * N


def ss_bound_ms(Bt: int, L: int, di: int, N: int, dtype: str):
    """(least ms, what bounds it) of one ``selective_scan_fwd`` call: x,
    dt, A, B, C, D, h0 read once and y, h_last written once over HBM
    bandwidth, or the Bt·L·di·N exponentials over the special-function
    units' rate (the recurrence's ~4 f32 FLOPs per exponential at
    67 TFLOP/s take less); the larger bounds it."""
    es = 2 if dtype == "bfloat16" else 4
    nbytes = (es * (2 * Bt * L * di + 2 * Bt * L * N)
              + 4 * (Bt * L * di + di * N + di + 2 * Bt * di * N))
    exps = Bt * L * di * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(exps / SFU_EXP_PER_S,
                scan_flops(Bt, L, di, N) / PEAK_FLOPS["float32"]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lm_train_flops(n_params: int, tokens: int) -> float:
    """6·N·T: forward and backward of N parameters over T tokens, not
    counting what remat recomputes."""
    return 6.0 * n_params * tokens


def lm_forward_flops(n_body: int, n_head: int, tokens: int, rows: int) -> float:
    """2·N·T of a forward whose head runs on each row's last position
    only (a prefill's logits)."""
    return 2.0 * (n_body * tokens + n_head * rows)
