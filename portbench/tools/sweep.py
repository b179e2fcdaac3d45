"""Find the knee of the scoring cell: the highest rate the program
sustains without a growing backlog.

    python3 portbench/tools/sweep.py --workload falcon-mamba-7b.frontdoor \
        --seed 5 --seconds 20 --rates 5 10 20 30 40

One process sets the cell up once, then offers each rate in turn (open
loop, the cell's own window lengths) and prints one JSON line per rate:
latency quantiles, the rate answered, and the backlog's growth (the
median latency of the last quarter of requests over the first
quarter's). A rate is sustained while that growth stays under 2 and
every request is answered. The cell's rate is then fixed at 0.8 of the
knee, as a number in its file.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None) -> int:
    from portbench.lib import harness as h
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = h.find_cell(args.workload)
    h.cache_env()
    h.require_cards(1)
    import numpy as np
    from portbench.drivers import frontdoor as fdrv
    from portbench.lib import traffic
    from repro_torch.launch.serve import FrontDoor
    r = h.Run(types.SimpleNamespace(seed=args.seed, seconds=args.seconds,
                                    trace=0), cell)
    tr, vocab = r.traffic, r.config["vocab_size"]
    _, _, decode_window = fdrv.setup(r)
    warm = np.random.default_rng(0)
    for L in tr["lengths"]:
        for k in tr["warm_batches"]:
            decode_window(warm.integers(0, vocab, (k, L)).astype(np.int32))
    rt = fdrv.runtime(r)
    fd = FrontDoor(rt, decode_window, window_s=tr["window_s"],
                   max_batch=tr["max_batch"])
    try:
        for rate in args.rates:
            reqs = traffic.open_windows(dict(tr, rate_per_s=rate), args.seed,
                                        args.seconds, vocab)
            before = rt.metrics.snapshot()
            _, lat, failed, late, (t0, t1), most = fdrv.open_loop(r, fd, reqs)
            after = rt.metrics.snapshot()
            q = max(1, len(lat) // 4)
            flushes = after["frontdoor.flushes"] - before.get("frontdoor.flushes", 0)
            print(json.dumps({
                "rate_per_s": rate, "requests": len(reqs),
                "failed": int(sum(failed)), "answered_per_s": len(reqs) / (t1 - t0),
                "p50_ms": 1e3 * statistics.median(lat),
                "p95_ms": 1e3 * fdrv.p95(lat), "max_ms": 1e3 * max(lat),
                "growth": statistics.median(lat[-q:]) / statistics.median(lat[:q]),
                "rows_per_flush": len(reqs) / max(flushes, 1),
                "late_p99_ms": 1e3 * float(np.percentile(late, 99)),
                "most_outstanding": most}), flush=True)
    finally:
        fd.close()
        rt.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
