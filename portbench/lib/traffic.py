"""The one traffic generator: every cell's inputs from its parameters and
the seed.

A cell's ``traffic`` block (in ``workloads/<cell>.json``) names a
``kind`` and its parameters; the function of that kind below makes what
the cell's driver feeds the program. Every seed gets the same set of
sizes and gaps, in another order, with other token ids: the seed changes
the data and the order, never the amount of work.

Kinds:
  * ``lm_batches``   closed loop of training batches: ``seq``, ``batch``;
                     batch ``i`` of a seed is fixed (``lm_batch``).
  * ``open_windows`` open loop of scoring requests: ``rate_per_s``,
                     ``lengths`` and ``weights`` of their windows.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng((int(seed),) + tuple(int(s) for s in stream))


# ------------------------------------------------------------------- batches
def lm_batch(seed: int, step: int, batch: int, seq: int,
             vocab: int) -> Dict[str, np.ndarray]:
    """One training batch: a low-entropy token stream per row (a random
    base plus a cumulative drift of 0-6), labels the tokens themselves.
    A frozen copy of the port's synthetic recipe (numpy, int32)."""
    rng = rng_for(seed, step)
    base = rng.integers(0, vocab, batch)[:, None]
    drift = rng.integers(0, 7, (batch, seq))
    toks = ((base + np.cumsum(drift, -1)) % vocab).astype(np.int32)
    return {"tokens": toks, "labels": toks}


# ------------------------------------------------------------- open arrivals
def arrival_gaps(n: int, rate: float) -> np.ndarray:
    """n exponential gaps at ``rate``: the distribution's n midpoint
    quantiles, so their sum and spread are the same for every seed."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


def open_windows(tr: dict, seed: int, seconds: float, vocab: int) -> List[dict]:
    """Requests due within ``seconds``: ``{"due_s", "tokens"}`` sorted by
    due time. Window lengths keep ``weights``' shares exactly."""
    rng = rng_for(seed, 1)
    rate = float(tr["rate_per_s"])
    n = max(1, int(math.floor(rate * seconds)))
    gaps = rng.permutation(arrival_gaps(n, rate))
    due = np.cumsum(gaps) * (seconds / gaps.sum()) * (n / (n + 0.5))
    counts = np.floor(np.asarray(tr["weights"], float) * n).astype(int)
    counts[0] += n - counts.sum()
    lengths = rng.permutation(np.repeat(np.asarray(tr["lengths"]), counts))
    return [{"due_s": float(due[i]),
             "tokens": rng.integers(0, vocab, int(lengths[i]),
                                    dtype=np.int64).astype(np.int32)}
            for i in range(n)]


def sample(seed: int, n_total: int, n_pick: int) -> List[int]:
    """A seeded sample of ``n_pick`` indices of ``range(n_total)``; sorted."""
    return sorted(rng_for(seed, 4).permutation(n_total)[:n_pick].tolist())
