"""Elastic worker autoscaling: queue depth + cost model, warm-pool reuse.

``tick()`` is a pure control step (call it from a loop, a timer, or a
test) that compares the broker's observed state against two signals:

  * **queue pressure** — more than ``queue_high`` queued tasks per live
    worker means we are under-provisioned; scale up proportionally.
  * **drain-time estimate** — when the broker has a task-duration EMA,
    size the pool so the current backlog drains within
    ``target_drain_s`` (the cost-model signal: seconds of queued work,
    not just task count).

Under the multi-tenant runtime, pressure is **aggregate across runs**:
the broker queue already pools every tenant's submitted tasks, and an
optional ``backlog_fn`` adds work the runtime is still holding in its
per-run ready heaps (steps admitted but not yet granted a lane), so a
burst of concurrent submissions scales the pool before the broker queue
alone would show it — and a nonzero runtime backlog blocks scale-down.

A third signal is **residency churn**: ``churn_fn`` reads the MDSS's
cumulative evicted-byte counter, and a churn *rate* above
``churn_high_bytes_per_s`` means tenants are thrashing their residency
budgets — evicting warm data only to re-stage it. Growing the pool (and
with it the working capacity per tenant) is the productive response;
while churn is nonzero, scale-down is also held off.

Scale-down is deliberately slower than scale-up (classic asymmetric
policy): only after the pool has been fully idle with an empty queue for
``idle_scale_down_s`` does one worker retire per tick — and retiring
parks the process in the broker's *warm pool* rather than killing it, so
a traffic burst right after a lull revives the same PID in microseconds
instead of paying process cold-start. ``reap_warm`` finally kills warm
workers older than ``warm_ttl_s``.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.cloud.broker import Broker


@dataclass
class AutoscalerConfig:
    min_workers: int = 1
    max_workers: int = 4
    queue_high: float = 2.0         # queued tasks per worker that trip scale-up
    target_drain_s: float = 1.0     # desired backlog drain time (cost signal)
    idle_scale_down_s: float = 2.0  # full-idle dwell before retiring a worker
    warm_ttl_s: float = 30.0        # warm worker lifetime before real kill
    churn_high_bytes_per_s: float = 32e6   # eviction churn that means thrash


class Autoscaler:
    def __init__(self, broker: Broker, config: Optional[AutoscalerConfig] = None,
                 backlog_fn: Optional[Callable[[], int]] = None,
                 churn_fn: Optional[Callable[[], int]] = None):
        self.broker = broker
        self.config = config or AutoscalerConfig()
        # aggregate pressure beyond the broker queue: e.g. the multi-tenant
        # runtime's cross-run count of ready-but-unlaned offload steps
        self.backlog_fn = backlog_fn
        # cumulative evicted-bytes counter (MDSS residency budgets); the
        # tick differentiates it into a churn rate
        self.churn_fn = churn_fn
        self._churn_mark: tuple = (None, 0.0)     # (t, cumulative bytes)
        self._idle_since: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.scale_ups = 0
        self.scale_downs = 0
        self.ticks = 0
        self.last_action: dict = {}

    def register_metrics(self, registry):
        registry.gauge("autoscaler.scale_ups", lambda: self.scale_ups)
        registry.gauge("autoscaler.scale_downs", lambda: self.scale_downs)
        registry.gauge("autoscaler.ticks", lambda: self.ticks)
        registry.gauge("autoscaler.desired_workers", self.desired_workers)

    def _backlog(self) -> int:
        if self.backlog_fn is None:
            return 0
        try:
            return max(0, int(self.backlog_fn()))
        except Exception:
            return 0   # runtime mid-shutdown

    def _churn_rate(self, now: float) -> float:
        """Evicted bytes/s since the previous tick (0 with no feed)."""
        if self.churn_fn is None:
            return 0.0
        try:
            total = float(self.churn_fn())
        except Exception:
            return 0.0   # store mid-shutdown
        prev_t, prev_total = self._churn_mark
        self._churn_mark = (now, total)
        if prev_t is None or now <= prev_t:
            return 0.0
        return max(0.0, (total - prev_total) / (now - prev_t))

    # ----------------------------------------------------------------- tick
    def desired_workers(self) -> int:
        cfg = self.config
        depth = self.broker.queue_depth() + self._backlog()
        n = max(1, self.broker.num_workers())
        desired = self.broker.num_workers()
        if depth / n > cfg.queue_high:
            # enough workers that queued-tasks-per-worker <= queue_high,
            # always at least one more than now
            desired = max(desired, math.ceil(depth / cfg.queue_high), n + 1)
        task_s = self.broker.avg_task_seconds()
        if task_s and depth:
            # workers needed to drain `depth` tasks in target_drain_s
            desired = max(desired, math.ceil(depth * task_s / cfg.target_drain_s))
        return max(cfg.min_workers, min(cfg.max_workers, desired))

    def tick(self, now: Optional[float] = None) -> dict:
        """One control step; returns a summary of what it did."""
        cfg = self.config
        now = time.monotonic() if now is None else now
        n = self.broker.num_workers()
        depth = self.broker.queue_depth() + self._backlog()
        busy = self.broker.inflight()
        churn = self._churn_rate(now)
        action = {"workers": n, "queue": depth, "added": 0, "retired": 0,
                  "reaped": 0, "churn_bps": churn}

        desired = self.desired_workers()
        if churn > cfg.churn_high_bytes_per_s:
            # residency thrash: tenants are evicting warm bytes only to
            # re-stage them — grow the pool instead of grinding the wire
            desired = max(desired, min(cfg.max_workers, n + 1))
        if desired > n:
            for _ in range(desired - n):
                self.broker.add_worker()
                self.scale_ups += 1
                action["added"] += 1
            self._idle_since = None
        elif depth == 0 and busy == 0 and churn == 0.0 \
                and n > cfg.min_workers:
            if self._idle_since is None:
                self._idle_since = now
            elif now - self._idle_since >= cfg.idle_scale_down_s:
                if self.broker.retire_worker():
                    self.scale_downs += 1
                    action["retired"] = 1
                self._idle_since = now   # at most one retire per dwell period
        else:
            self._idle_since = None
        action["reaped"] = self.broker.reap_warm(cfg.warm_ttl_s)
        action["workers"] = self.broker.num_workers()
        self.ticks += 1
        self.last_action = action
        return action

    # ----------------------------------------------------- background drive
    def start(self, interval_s: float = 0.5):
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:
                    pass   # broker mid-shutdown

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fabric-autoscale")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
