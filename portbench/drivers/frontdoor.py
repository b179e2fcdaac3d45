"""Scoring through the port's ``FrontDoor``: open loop, Poisson arrivals.

Each request is one window of tokens; its answer is the next-token
logits after the window, from ``Model.prefill`` over the window on the
card (a row-independent, host-in host-out ``decode_fn``, the params
resident on the card, the step not remotable: MDSS is bypassed). The
``FrontDoor`` runs over a shared ``EmeraldRuntime`` with the port's
coalescing window and batch limit, so concurrent requests of one length
fuse into one forward.

Set-up draws the weights on the card and warms every window length at
the batch sizes coalescing gives. The window is every request due within
``--seconds`` at the cell's fixed rate; a request's latency runs from
when it was due to its answer, and the run ends when the last one has
its answer or has failed. Afterwards the plain reference recomputes a
seeded sample of the answered rows, each window alone.
"""
from __future__ import annotations

import math
import sys
import threading
import time

import numpy as np
import torch

WAIT_PAST_CLOSE_S = 60.0


def p95(values):
    """Nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def setup(r):
    """(model config, params on the card, decode_fn)."""
    from portbench.drivers._shared import model_config
    from portbench.lib import weights
    from repro_torch.configs.base import RunConfig, ShapeProfile
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model_zoo import Model
    mc = model_config(r.config)
    model = Model(RunConfig(model=mc, shape=ShapeProfile(
        "score", max(r.traffic["lengths"]), 1, "prefill"), remat="none"))
    params = weights.nest(weights.draw(weights.mamba1_leaves(r.config),
                                       r.seed, r.device))
    prefill, dev = model.prefill, r.device

    def decode_window(tokens):
        """Logits after each row's window: row-independent, stateless."""
        toks = torch.from_numpy(np.ascontiguousarray(tokens)).to(dev)
        cache = tfm.init_cache(mc, toks.shape[0], toks.shape[1], dev)
        logits, _ = prefill(params, {"tokens": toks}, cache)
        return logits.float().cpu().numpy()

    return mc, params, decode_window


def runtime(r):
    from repro_torch.core import (CostModel, EmeraldRuntime, MDSS,
                                  MigrationManager, default_tiers)
    tiers = default_tiers(cloud_device="cpu" if r.device == "cpu" else None)
    cm = CostModel(tiers)
    mgr = MigrationManager(tiers, MDSS(tiers, cost_model=cm), cm)
    return EmeraldRuntime(mgr, max_workers=4)


def open_loop(r, fd, reqs, stretch=None):
    """Submit ``reqs`` at their due times (open loop) and wait for every
    answer. Each request gets a waiter thread of its own, started as it
    is submitted, so its clock stops when its answer comes however many
    are outstanding. Returns (rows, latency s, failed flags, lateness s,
    the window's (start, end), the most requests outstanding at once)."""
    n = len(reqs)
    rows, lat, failed = [None] * n, [0.0] * n, [False] * n
    late = [0.0] * n
    t_open = time.perf_counter()
    limit = max(q["due_s"] for q in reqs) + WAIT_PAST_CLOSE_S
    lock = threading.Lock()
    outstanding = [0, 0]                    # now, most

    def waiter(i, ticket):
        due = t_open + reqs[i]["due_s"]
        try:
            rows[i] = ticket.result(max(0.0, t_open + limit - time.perf_counter()))
            lat[i] = time.perf_counter() - due
        except Exception as e:          # a failed or timed-out request
            failed[i], lat[i] = True, limit - reqs[i]["due_s"]
            print(f"portbench: request {i} failed: {e!r}", file=sys.stderr)
        with lock:
            outstanding[0] -= 1

    threads = []
    prof = None
    for i, q in enumerate(reqs):
        if stretch is not None and prof is None and q["due_s"] >= stretch[0]:
            prof = r.stretch()
            prof.__enter__()
        if prof is not None and stretch is not None and q["due_s"] >= stretch[1]:
            prof.__exit__(None, None, None)
            stretch = None
        wait = t_open + q["due_s"] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[i] = max(0.0, time.perf_counter() - (t_open + q["due_s"]))
        try:
            ticket = fd.decode(q["tokens"])
        except Exception as e:
            failed[i], lat[i] = True, limit - q["due_s"]
            print(f"portbench: request {i} refused: {e!r}", file=sys.stderr)
            continue
        with lock:
            outstanding[0] += 1
            outstanding[1] = max(outstanding)
        t = threading.Thread(target=waiter, args=(i, ticket), daemon=True)
        t.start()
        threads.append(t)
    if prof is not None and stretch is not None:
        prof.__exit__(None, None, None)
    for t in threads:
        t.join(max(0.0, t_open + limit + 10.0 - time.perf_counter()))
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a waiter outlived its requests' limit")
    return rows, lat, failed, late, (t_open, time.perf_counter()), outstanding[1]


def run(r):
    from portbench.drivers._shared import free_device, spans_of
    from portbench.lib import checks, traffic, weights
    from portbench.reference import mamba1
    from repro_torch.launch.serve import FrontDoor
    tr = r.traffic
    vocab = r.config["vocab_size"]
    mc, params, decode_window = setup(r)
    warm = np.random.default_rng(0)
    for L in tr["lengths"]:
        for k in tr["warm_batches"]:
            decode_window(warm.integers(0, vocab, (k, L)).astype(np.int32))
    r.note("weights drawn, shapes warmed")
    rt = runtime(r)
    fd = FrontDoor(rt, decode_window, window_s=tr["window_s"],
                   max_batch=tr["max_batch"])
    tracer = rt.tracer
    r.program_spans = lambda: spans_of(tracer)
    try:
        for L in tr["lengths"]:
            fd.decode(warm.integers(0, vocab, L).astype(np.int32)).result(120)
        reqs = traffic.open_windows(tr, r.seed, r.seconds, vocab)
        before = rt.metrics.snapshot()
        r.open_window()
        mid = 0.4 * r.seconds
        rows, lat, failed, late, (t0, t1), most = open_loop(
            r, fd, reqs, (mid, mid + tr["traced_s"]) if r.trace else None)
        r.t_window = (t0, t1)
        r.read_peak()
        r.counters = {"before": before, "after": rt.metrics.snapshot()}
    finally:
        fd.close()
        rt.close()
    r.attempted, r.failed = len(reqs), int(sum(failed))
    r.units = [{"tokens": len(q["tokens"]), "latency_s": l, "failed": f}
               for q, l, f in zip(reqs, lat, failed)]
    r.extra["n_body"] = sum(v.numel() for k, v in
                            weights.flatten(params).items()
                            if k.startswith("stage_0/"))
    r.extra["n_head"] = params["embed"]["lm_head"].numel()
    r.e2e["setup_s"] = r.setup_s
    r.e2e["request_p95_ms"] = 1e3 * p95(lat)
    print(f"portbench: generator late p50 {1e3 * float(np.median(late))!r} ms, "
          f"p99 {1e3 * float(np.percentile(late, 99))!r} ms, max "
          f"{1e3 * max(late)!r} ms over {len(reqs)} requests; at most "
          f"{most} outstanding at once",
          file=sys.stderr, flush=True)
    del params, fd, rt
    free_device()
    answered = [i for i, f in enumerate(failed) if not f]
    r.note(f"window closed: {len(reqs)} requests")
    picked = pick_rows(r, reqs, answered)
    mamba1.no_tf32()
    w = weights.draw(weights.mamba1_leaves(r.config), r.seed, r.device)
    got, want = [], []
    for L in sorted({len(reqs[i]["tokens"]) for i in picked}):
        idx = [i for i in picked if len(reqs[i]["tokens"]) == L]
        toks = torch.as_tensor(np.stack([reqs[i]["tokens"] for i in idx]),
                               device=r.device)
        with torch.no_grad():
            want.append(mamba1.logits(r.config, w, toks, last_only=True)
                        .double().cpu().numpy())
        got.append(np.stack([rows[i] for i in idx]))
    r.note("reference done")
    r.compare("row_err", checks.row_error(np.concatenate(got),
                                          np.concatenate(want)),
              r.spec["check"]["row_err"])


def pick_rows(r, reqs, answered):
    """A seeded sample of ``checked_per_length`` answered rows of each
    window length (the longest among them)."""
    from portbench.lib import traffic
    out = []
    for L in r.traffic["lengths"]:
        mine = [i for i in answered if len(reqs[i]["tokens"]) == L]
        take = traffic.sample(r.seed + L, len(mine),
                              r.traffic["checked_per_length"])
        out += [mine[j] for j in take]
    return sorted(out)
