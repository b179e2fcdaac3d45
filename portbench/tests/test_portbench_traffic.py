"""The traffic generator: the same seed gives the same inputs, and every
seed gives the same amount of work in another order."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench.lib import traffic

ROOT = Path(__file__).resolve().parents[2]
SPEC = {p.stem: json.loads(p.read_text())
        for p in (ROOT / "portbench" / "workloads").glob("*.json")}
SEEDS = (7, 2 ** 31 + 12345)


def _cell(kind):
    return next(s for s in SPEC.values() if s["traffic"]["kind"] == kind)


def test_lm_batches_per_seed():
    tr = _cell("lm_batches")["traffic"]
    a = traffic.lm_batch(SEEDS[1], 3, tr["batch"], 64, 65024)
    b = traffic.lm_batch(SEEDS[1], 3, tr["batch"], 64, 65024)
    c = traffic.lm_batch(SEEDS[0], 3, tr["batch"], 64, 65024)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].dtype == np.int32 and a["tokens"].shape == (tr["batch"], 64)
    assert len({r.tobytes() for r in a["tokens"]}) == tr["batch"]   # rows differ


def test_open_windows_same_work_every_seed():
    tr = _cell("open_windows")["traffic"]
    runs = {s: traffic.open_windows(tr, s, 20.0, 65024) for s in SEEDS}
    again = traffic.open_windows(tr, SEEDS[0], 20.0, 65024)
    assert [q["due_s"] for q in again] == [q["due_s"] for q in runs[SEEDS[0]]]
    assert all(np.array_equal(x["tokens"], y["tokens"])
               for x, y in zip(again, runs[SEEDS[0]]))
    a, b = (runs[s] for s in SEEDS)
    assert len(a) == len(b) == int(tr["rate_per_s"] * 20.0)
    assert sorted(len(q["tokens"]) for q in a) == sorted(len(q["tokens"]) for q in b)
    gaps = [np.sort(np.diff([0.0] + [q["due_s"] for q in r])) for r in (a, b)]
    assert np.allclose(gaps[0], gaps[1])
    assert all(0 <= q["due_s"] < 20.0 for q in a)
    assert [q["due_s"] for q in a] == sorted(q["due_s"] for q in a)
    shares = np.bincount([tr["lengths"].index(len(q["tokens"])) for q in a]) / len(a)
    assert np.allclose(shares, tr["weights"], atol=2 / len(a))


@pytest.mark.parametrize("n,k", [(10, 3), (40, 40), (5, 8)])
def test_sample_seeded(n, k):
    s = traffic.sample(9, n, k)
    assert s == traffic.sample(9, n, k)
    assert s == sorted(set(s)) and len(s) == min(n, k)
    assert all(0 <= i < n for i in s)
