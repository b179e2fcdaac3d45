"""The port's serving front door (``repro_torch.core.batching``,
``repro_torch.launch.serve.FrontDoor``) and the runtime's admission
parking and SLO preemption, as ``tests/test_frontdoor.py`` checks them in
the JAX package: parked admission and symmetric release, the coalescer's
flush reasons, keys, charges and error fan-out, broker preemption with
real worker processes, and the SLO guard. A ``FrontDoor`` over the port's
runtime is held against the JAX package's on the same decode function.
(The explorer-model cases of that file come with the port's explorer.)
"""
import threading
import time

import numpy as np
import pytest

from repro.core.batching import BatchCoalescer as JBatchCoalescer
from repro_torch.core import (AdmissionRefused, CostModel, EmeraldRuntime,
                              MDSS, MigrationManager, RunCancelled,
                              RuntimeClosed, Workflow, default_tiers)
from repro_torch.core.batching import BatchCoalescer, CoalesceError


def emerald():
    tiers = default_tiers(cloud_device="cpu")
    cm = CostModel(tiers)
    mdss = MDSS(tiers, cost_model=cm)
    return MigrationManager(tiers, mdss, cm)


def sleeper_wf(name, seconds=0.0):
    def fn(x):
        if seconds:
            time.sleep(seconds)
        return {"y": np.float64(float(x) + 1.0)}
    wf = Workflow(name)
    wf.var("x")
    wf.step("s", fn, inputs=("x",), outputs=("y",), remotable=False,
            device_step=False)
    return wf


# ------------------------------------------------------------- admission
def test_park_drains_oldest_deadline_first():
    with EmeraldRuntime(emerald(), max_workers=2, max_active_runs=1,
                        park_limit=4, telemetry=False) as rt:
        head = rt.submit(sleeper_wf("head", 0.25), {"x": 0.0})
        # loose deadline parked first, tight deadline second: admission
        # must reorder them (oldest deadline first), not FIFO
        loose = rt.submit(sleeper_wf("loose"), {"x": 10.0}, park=True,
                          deadline_s=60.0)
        tight = rt.submit(sleeper_wf("tight"), {"x": 20.0}, park=True,
                          deadline_s=1.0)
        assert loose.state == "parked" and tight.state == "parked"
        snap = rt.introspect()["frontdoor"]
        assert snap["depth"] == 2 and snap["queue_limit"] == 4
        assert [p["run_id"] for p in snap["parked"]] == \
            [tight.run_id, loose.run_id]           # deadline order

        assert head.result(10)["y"] == 1.0
        assert tight.result(10)["y"] == 21.0
        assert loose.result(10)["y"] == 11.0
        assert tight.state == "done" and loose.state == "done"
        admit_t = {}
        for h in (tight, loose):
            (ev,) = [e for e in h.events if e.kind == "admit"]
            admit_t[h.run_id] = ev.t
            assert any(e.kind == "park" for e in h.events)
        assert admit_t[tight.run_id] <= admit_t[loose.run_id]
        assert rt.admitted_total == 2 and rt.parked_total == 2


def test_queue_full_is_the_only_refusal_and_release_is_symmetric():
    with EmeraldRuntime(emerald(), max_workers=2, max_active_runs=1,
                        park_limit=2, telemetry=False) as rt:
        head = rt.submit(sleeper_wf("head", 0.4), {"x": 0.0})
        parked = [rt.submit(sleeper_wf(f"p{i}"), {"x": float(i)}, park=True)
                  for i in range(2)]
        # the head run is still sleeping, so the queue is full now
        with pytest.raises(AdmissionRefused, match="queue_full"):
            rt.submit(sleeper_wf("overflow"), {"x": 9.0}, park=True)
        # non-parking submission over the run-slot cap refuses outright
        with pytest.raises(AdmissionRefused, match="run slots"):
            rt.submit(sleeper_wf("refused"), {"x": 9.0})
        head.result(10)
        for i, h in enumerate(parked):
            assert h.result(10)["y"] == i + 1.0
        # every path released its state: nothing reserved, nothing live
        with rt._runs_lock:
            assert not rt._reserved and rt._live == 0 and not rt._parked


def test_park_validation_runs_before_queueing():
    from repro_torch.analysis import WorkflowRejected
    with EmeraldRuntime(emerald(), max_workers=2, max_active_runs=1,
                        telemetry=False) as rt:
        head = rt.submit(sleeper_wf("head", 0.2), {"x": 0.0})
        bad = Workflow("bad")
        bad.var("missing")          # declared but never provided: W002
        bad.step("s", lambda missing: {}, inputs=("missing",),
                 outputs=("y",), device_step=False)
        with pytest.raises(WorkflowRejected):
            rt.submit(bad, {}, park=True)
        # the rejected submission never landed in the queue
        assert rt.introspect()["frontdoor"]["depth"] == 0
        head.result(10)
        with rt._runs_lock:
            assert not rt._reserved and rt._live == 0


def test_cancel_while_parked():
    with EmeraldRuntime(emerald(), max_workers=2, max_active_runs=1,
                        telemetry=False) as rt:
        head = rt.submit(sleeper_wf("head", 0.3), {"x": 0.0})
        h = rt.submit(sleeper_wf("victim"), {"x": 1.0}, park=True)
        assert h.state == "parked"
        h.cancel()
        with pytest.raises(RunCancelled):
            h.result(10)
        assert h.state == "cancelled"
        head.result(10)
        assert rt.admitted_total == 0


def test_close_fails_parked_with_runtime_closed():
    rt = EmeraldRuntime(emerald(), max_workers=2, max_active_runs=1,
                        telemetry=False)
    head = rt.submit(sleeper_wf("head", 0.2), {"x": 0.0})
    h = rt.submit(sleeper_wf("stuck"), {"x": 1.0}, park=True)
    head.result(10)
    rt.close()
    if h.state == "done":         # admitted before close won the race
        assert h.result(0)["y"] == 2.0
    else:
        with pytest.raises(RuntimeClosed):
            h.result(10)


def test_concurrent_park_refuse_finalize_hammer():
    """Park, refuse, and finalize racing from many threads must never
    leak a reservation or a run slot (the symmetric-release bugfix)."""
    with EmeraldRuntime(emerald(), max_workers=4, max_active_runs=2,
                        park_limit=3, telemetry=False) as rt:
        handles, refused = [], []
        lock = threading.Lock()

        def tenant(i):
            for j in range(4):
                try:
                    h = rt.submit(sleeper_wf(f"t{i}.{j}", 0.01),
                                  {"x": float(i)}, park=(j % 2 == 0),
                                  deadline_s=5.0)
                    with lock:
                        handles.append(h)
                    if j % 2:
                        h.result(30)
                except AdmissionRefused:
                    with lock:
                        refused.append((i, j))

        threads = [threading.Thread(target=tenant, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for h in handles:
            assert "y" in h.result(30)
        deadline = time.time() + 10.0
        while time.time() < deadline:
            with rt._runs_lock:
                if not rt._reserved and rt._live == 0 and not rt._parked:
                    break
            time.sleep(0.01)
        with rt._runs_lock:
            assert not rt._reserved and rt._live == 0 and not rt._parked


# -------------------------------------------------------------- coalescer
def test_coalescer_window_flush_and_rows():
    got = []

    def fuse(key, stacked, k):
        got.append((key, stacked.shape, k))
        return stacked * 2

    c = BatchCoalescer(fuse, window_s=0.03, max_batch=8)
    try:
        tickets = [c.submit("k", np.full((2,), i)) for i in range(3)]
        rows = [t.result(5.0) for t in tickets]
        assert len(got) == 1 and got[0] == ("k", (3, 2), 3)
        for i, row in enumerate(rows):
            np.testing.assert_array_equal(row, np.full((2,), i * 2))
        (flush,) = [e for e in c.events if e.kind == "flush"]
        assert flush.info["reason"] == "window" and flush.info["batch"] == 3
    finally:
        c.close()


def test_coalescer_full_flush_is_immediate():
    c = BatchCoalescer(lambda key, stacked, k: stacked, window_s=10.0,
                       max_batch=4)
    try:
        t0 = time.perf_counter()
        tickets = [c.submit("k", np.float64(i)) for i in range(4)]
        for t in tickets:
            t.result(5.0)
        assert time.perf_counter() - t0 < 5.0      # did not wait the window
        (flush,) = [e for e in c.events if e.kind == "flush"]
        assert flush.info["reason"] == "full"
    finally:
        c.close()


def test_coalescer_deadline_forces_early_flush():
    c = BatchCoalescer(lambda key, stacked, k: stacked, window_s=30.0,
                       max_batch=8)
    try:
        t = c.submit("k", np.float64(1.0), deadline_s=0.05)
        t.result(5.0)
        (flush,) = [e for e in c.events if e.kind == "flush"]
        assert flush.info["reason"] == "deadline"
        assert flush.info["waited_s"] < 5.0
    finally:
        c.close()


def test_coalescer_keys_never_fuse_and_charges_are_fair():
    shares = []
    c = BatchCoalescer(lambda key, stacked, k: stacked, window_s=0.02,
                       max_batch=8)
    try:
        a = [c.submit("ka", np.float64(i), charge=shares.append)
             for i in range(3)]
        b = c.submit("kb", np.float64(9.0))
        for t in a:
            t.result(5.0)
        b.result(5.0)
        assert c.flushes == 2                       # one per key
        # the three ka participants each paid the same 1/3 share
        assert len(shares) == 3 and len({round(s, 12) for s in shares}) == 1
    finally:
        c.close()


def test_coalescer_error_fans_out_to_every_ticket():
    def boom(key, stacked, k):
        raise ValueError("fused failure")

    c = BatchCoalescer(boom, window_s=0.02, max_batch=8)
    try:
        tickets = [c.submit("k", np.float64(i)) for i in range(2)]
        for t in tickets:
            with pytest.raises(CoalesceError, match="fused failure"):
                t.result(5.0)
    finally:
        c.close()


# ------------------------------------------------------------- preemption
def test_broker_preempt_longest_is_attempt_free():
    from repro_torch.cloud import Fabric
    with Fabric(workers=1) as fabric:
        t = fabric.broker.submit(step="sleep", kwargs={"seconds": 1.0},
                                 preemptible=True)
        deadline = time.time() + 10.0
        while time.time() < deadline and not fabric.broker._inflight:
            time.sleep(0.01)
        victim = fabric.broker.preempt_longest()
        assert victim is t
        assert t.preempted == 1
        assert fabric.broker.tasks_preempted == 1
        # the requeued task completes on the replacement worker, and the
        # preempted placement was refunded: exactly one charged attempt
        t.result(60)
        assert t.attempts == 1


def test_broker_preempt_longest_skips_non_preemptible():
    from repro_torch.cloud import Fabric
    with Fabric(workers=1) as fabric:
        fabric.broker.submit(step="sleep", kwargs={"seconds": 0.3})
        time.sleep(0.05)
        assert fabric.broker.preempt_longest() is None


def test_slo_guard_fires_once_per_threatened_run():
    class FakeTask:
        task_id = 7
        step = "bat"

    class FakeBroker:
        def __init__(self):
            self.calls = 0

        def preempt_longest(self):
            self.calls += 1
            return FakeTask()

    class FakeFabric:
        def __init__(self):
            self.broker = FakeBroker()

    with EmeraldRuntime(emerald(), max_workers=2, max_active_runs=1,
                        telemetry=False) as rt:
        rt._fabric = FakeFabric()
        head = rt.submit(sleeper_wf("head", 0.3), {"x": 0.0})
        h = rt.submit(sleeper_wf("urgent"), {"x": 1.0}, park=True,
                      deadline_s=0.05, slo_ms=10_000.0)
        assert h.result(10)["y"] == 2.0
        head.result(10)
        assert rt._fabric.broker.calls == 1      # once, despite many ticks
        assert any(e.kind == "preempt" for e in h.events)


# ------------------------------------------------- FrontDoor vs reference
def _decode_fn(tokens):
    """Row-independent numpy decode: each row's logits from its tokens."""
    t = np.asarray(tokens, np.float64)
    return np.stack([np.sin(t).sum(-1), np.cos(t).sum(-1), t.max(-1)], -1)


def _jax_runtime():
    import repro.core as jcore
    tiers = jcore.default_tiers()
    cm = jcore.CostModel(tiers)
    mdss = jcore.MDSS(tiers, cost_model=cm)
    return jcore.EmeraldRuntime(jcore.MigrationManager(tiers, mdss, cm),
                                max_workers=2, telemetry=False)


def _serve_through(frontdoor_cls, rt, requests):
    """Groups of 4, 4 and 2 requests, each group served before the next
    joins (a bucket takes whatever arrives before its flush thread wakes,
    so back-to-back groups could fuse)."""
    fd = frontdoor_cls(rt, _decode_fn, window_s=0.3, max_batch=4)
    try:
        rows = []
        for group in (requests[:4], requests[4:8], requests[8:]):
            tickets = [fd.decode(r) for r in group]
            rows += [t.result(30) for t in tickets]
        reasons = [e.info["reason"] for e in fd.coalescer.events
                   if e.kind == "flush"]
        return rows, fd.coalescer.flushes, reasons
    finally:
        fd.close()


def test_frontdoor_matches_reference_frontdoor():
    """Ten requests through a window of 0.3 s and batches of 4: two full
    flushes and one window flush on either runtime, and the same rows."""
    from repro.launch.serve import FrontDoor as JFrontDoor
    from repro_torch.launch.serve import FrontDoor
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 1000, 8).astype(np.int32) for _ in range(10)]
    with EmeraldRuntime(emerald(), max_workers=2, telemetry=False) as rt:
        rows, flushes, reasons = _serve_through(FrontDoor, rt, requests)
    with _jax_runtime() as jrt:
        jrows, jflushes, jreasons = _serve_through(JFrontDoor, jrt, requests)
    assert flushes == jflushes == 3
    assert reasons == jreasons == ["full", "full", "window"]
    for r, jr, req in zip(rows, jrows, requests):
        assert isinstance(r, np.ndarray)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(r, _decode_fn(req[None])[0])


def test_coalescer_flushes_like_reference():
    """Both coalescers, fed the same keys in the same order, flush the
    same batches for the same reasons."""
    def run(cls):
        seen = []
        c = cls(lambda key, stacked, k: (seen.append((key, k)), stacked)[1],
                window_s=0.05, max_batch=3)
        try:
            tickets = [c.submit(f"k{i % 2}", np.float64(i)) for i in range(7)]
            rows = [float(t.result(5.0)) for t in tickets]
            reasons = sorted(e.info["reason"] for e in c.events
                             if e.kind == "flush")
            return rows, sorted(seen), reasons
        finally:
            c.close()
    assert run(BatchCoalescer) == run(JBatchCoalescer)
