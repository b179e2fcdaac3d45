"""Unified metrics registry: counters, gauges, histograms.

One process-wide (or per-runtime) :class:`MetricsRegistry` absorbs the
stats that were previously scattered as private attributes across the
broker, worker pool, MDSS, wire channels, memo table, fair-share
scheduler and autoscaler. Components register themselves via their
``register_metrics(registry)`` methods; consumers read everything with
one :meth:`MetricsRegistry.snapshot` call.

Design points:

  * **Lock-striped counters** — ``inc()`` takes one of 16 stripe locks
    chosen by the metric's name hash, so hot-path increments from lane
    threads, broker reader threads and the driver loop rarely contend on
    the same lock. A counter caches its stripe lock at construction;
    after the first ``counter()`` lookup the increment is just
    ``with lock: value += n``.
  * **Pull gauges** — a gauge is a callback sampled at ``snapshot()``
    time (e.g. ``broker.queue_depth``). Sampling never throws: a failing
    callback yields ``None`` for that gauge. Re-registering a gauge name
    replaces the callback (last wins), which makes repeated
    ``attach_fabric``-style wiring idempotent.
  * **Consistent snapshot** — ``snapshot()`` takes all stripe locks in a
    fixed order while copying counter/histogram values, so a reader
    never observes a torn multi-field histogram; gauges are sampled
    after release (they read component state under those components'
    own locks).
  * **Opt-out** — a registry built with ``enabled=False`` turns ``inc``
    / ``observe`` into no-ops (one ``if`` each) and ``snapshot()``
    returns an empty dict, for minimum-overhead runs.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

_N_STRIPES = 16

# Default histogram buckets (seconds-ish scale; upper bounds, +inf last).
_DEFAULT_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0)


class Counter:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.value = 0
        self._lock = lock

    def inc(self, n: int = 1):
        with self._lock:
            self.value += n

    def set(self, v: int):
        """Absolute set — for mirroring an externally-maintained total."""
        with self._lock:
            self.value = v


class Histogram:
    __slots__ = ("name", "count", "sum", "min", "max", "buckets",
                 "bucket_counts", "_lock")

    def __init__(self, name: str, lock: threading.Lock,
                 buckets=_DEFAULT_BUCKETS):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.buckets = tuple(buckets)
        self.bucket_counts = [0] * (len(self.buckets) + 1)
        self._lock = lock

    def observe(self, v: float):
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    self.bucket_counts[i] += 1
                    break
            else:
                self.bucket_counts[-1] += 1


class MetricsRegistry:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._stripes = [threading.Lock() for _ in range(_N_STRIPES)]
        self._meta = threading.Lock()       # guards the name->metric maps
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Callable[[], Any]] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _stripe(self, name: str) -> threading.Lock:
        return self._stripes[hash(name) % _N_STRIPES]

    # ---------------------------------------------------------- registration
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._meta:
                c = self._counters.get(name)
                if c is None:
                    c = self._counters[name] = Counter(name,
                                                       self._stripe(name))
        return c

    def gauge(self, name: str, fn: Callable[[], Any]):
        """Register (or replace) a pull gauge. Last registration wins."""
        with self._meta:
            self._gauges[name] = fn

    def histogram(self, name: str, buckets=_DEFAULT_BUCKETS) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._meta:
                h = self._histograms.get(name)
                if h is None:
                    h = self._histograms[name] = Histogram(
                        name, self._stripe(name), buckets)
        return h

    # ------------------------------------------------------------- hot paths
    def inc(self, name: str, n: int = 1):
        if not self.enabled:
            return
        self.counter(name).inc(n)

    def set(self, name: str, v: int):
        if not self.enabled:
            return
        self.counter(name).set(v)

    def observe(self, name: str, v: float):
        if not self.enabled:
            return
        self.histogram(name).observe(v)

    # --------------------------------------------------------------- reading
    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time view of every metric: ``{name: value}`` for
        counters and gauges, ``{name: {count,sum,min,max,avg,buckets}}``
        for histograms. Counter/histogram reads are torn-free (all
        stripe locks held while copying); gauges sample afterwards."""
        if not self.enabled:
            return {}
        with self._meta:
            counters = list(self._counters.values())
            gauges = list(self._gauges.items())
            histograms = list(self._histograms.values())
        out: Dict[str, Any] = {}
        for lk in self._stripes:
            lk.acquire()
        try:
            for c in counters:
                out[c.name] = c.value
            for h in histograms:
                out[h.name] = {
                    "count": h.count, "sum": h.sum,
                    "min": h.min, "max": h.max,
                    "avg": (h.sum / h.count) if h.count else None,
                    "buckets": dict(zip(
                        [str(b) for b in h.buckets] + ["+inf"],
                        list(h.bucket_counts))),
                }
        finally:
            for lk in self._stripes:
                lk.release()
        for name, fn in gauges:
            try:
                out[name] = fn()
            except Exception:
                out[name] = None
        return out

    def names(self) -> List[str]:
        with self._meta:
            return sorted(set(self._counters) | set(self._gauges)
                          | set(self._histograms))


# Process-wide default registry; runtimes default to their own private
# registry (cross-test isolation) but share this one when asked.
REGISTRY = MetricsRegistry()


#: name -> one-line doc, one row per metric name used in src/. The
#: ``emlint --self`` L002 rule (``repro_torch.analysis.selfcheck``) greps the
#: source tree for ``inc("/observe("/gauge("/set("`` call sites and fails
#: on any dotted metric name missing from this table — same contract as
#: ``EVENT_SCHEMA`` for event kinds.
METRIC_CATALOG: Dict[str, str] = {
    "autoscaler.desired_workers": "Autoscaler's current target pool size.",
    "autoscaler.scale_ups": "Scale-up decisions taken.",
    "autoscaler.scale_downs": "Scale-down decisions taken.",
    "autoscaler.ticks": "Autoscaler control-loop iterations.",
    "broker.queue_depth": "Tasks waiting for a worker.",
    "broker.inflight": "Tasks currently executing on workers.",
    "broker.num_workers": "Live workers attached to the broker.",
    "broker.num_workers_with_warm": "Workers holding a warm module set.",
    "broker.idle_workers": "Workers with no task in flight.",
    "broker.tasks_done": "Tasks completed successfully.",
    "broker.tasks_requeued": "Tasks requeued after worker loss/failure.",
    "broker.tasks_cancelled": "Tasks cancelled before completion.",
    "broker.workers_lost": "Workers declared dead by heartbeat.",
    "broker.tasks_preempted": "In-flight tasks checkpoint-aborted for SLO.",
    "broker.warm_hits": "Tasks routed to a warm worker.",
    "compile_cache.entries": "Compiled-executable cache entries.",
    "compile_cache.hits": "Compiled-executable cache hits.",
    "emcheck.schedules_explored": "Complete interleavings model-checked.",
    "emcheck.states_deduped": "Explorer prefixes cut by visited-state dedup.",
    "emcheck.por_pruned": "Branches collapsed by partial-order reduction.",
    "emcheck.hazards_found": "Findings raised across explored schedules.",
    "emcheck.replays": "Reproducer schedules replayed.",
    "fanout.scatters": "Fan-out scatter steps completed.",
    "fanout.shards_dispatched": "Fan-out shard steps granted a lane.",
    "fanout.shards_completed": "Fan-out shard steps completed.",
    "fanout.gathers": "Fan-out gather steps completed.",
    "frontdoor.parked_depth": "Submissions currently parked for admission.",
    "frontdoor.parked_total": "Submissions ever parked by the front door.",
    "frontdoor.admitted_total": "Parked submissions drained into the runtime.",
    "frontdoor.queue_full": "Submissions refused because the queue was full.",
    "frontdoor.park_wait_s": "Seconds parked submissions waited for admission.",
    "frontdoor.preemptions": "SLO-driven preemptions of in-flight batch work.",
    "frontdoor.coalesced": "Decode requests absorbed into a fused batch.",
    "frontdoor.flushes": "Coalescer buckets flushed as one fused task.",
    "frontdoor.fused_batch": "Request count of fused batches (histogram).",
    "mdss.resident_bytes": "Bytes resident across tiers.",
    "mdss.bytes_moved": "Bytes transferred between tiers.",
    "mdss.modeled_seconds": "Cost-model seconds charged to transfers.",
    "mdss.prefetch_ops": "Prefetch operations issued.",
    "mdss.prefetch_bytes": "Bytes moved by prefetch.",
    "mdss.fenced_puts": "Fenced put_many publishes.",
    "mdss.evictions": "Replicas evicted by residency budgets.",
    "mdss.eviction_bytes": "Bytes reclaimed by eviction.",
    "mdss.dedup_bytes_elided": "Bytes elided by content-chunk dedup.",
    "mdss.entries": "Distinct URIs tracked by the store.",
    "mdss.chunk_index_bytes": "Bytes held by the chunk dedup index.",
    "memo.entries": "Cross-run memo table entries.",
    "memo.bytes": "Bytes held by the memo table.",
    "memo.hits": "Step executions answered from the memo table.",
    "memo.waits": "Executions that waited on an in-flight memo twin.",
    "pool.spawned_total": "Worker processes spawned over the pool's life.",
    "pool.pending_hellos": "Spawned workers not yet handshaken.",
    "runtime.active_runs": "Admitted, unfinished runs.",
    "runtime.offload_backlog": "Ready offload-lane steps awaiting a slot.",
    "runtime.lane_busy.offload": "Busy offload-lane slots.",
    "runtime.lane_busy.local": "Busy local-lane slots.",
    "runtime.runs_completed": "Runs finished (done/failed/cancelled).",
    "runtime.steps_dispatched": "Steps handed to a lane executor.",
    "runtime.steps_completed": "Steps whose results were committed.",
    "runtime.step_retries": "Step re-executions after failure.",
    "runtime.submissions_rejected": "Workflows rejected by the verifier.",
    "scheduler.fair_share": "Fair-share scheduler pass statistics.",
    "wire.bytes_sent": "Bytes written to worker sockets.",
    "wire.bytes_received": "Bytes read from worker sockets.",
    "wire.dedup_saved_bytes": "Wire bytes elided by chunk dedup.",
    "wire.dedup_chunks": "Chunks answered from the receiver's cache.",
    "wire.dedup_hit_rate": "Fraction of chunks deduped on the wire.",
}
