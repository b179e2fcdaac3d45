"""Continuous batching for the serving front door.

The serve path's one-task-per-decode regime is exactly the fine-grained
task shape that drowns in per-task scheduling overhead (every decode
pays a full partition/validate/dispatch round trip for microseconds of
compute). A :class:`BatchCoalescer` amortises that: concurrent decode
requests from *many* tenants land in a bucket keyed by (code
fingerprint, shape signature), a short adaptive window collects them,
and the whole bucket dispatches as ONE fused task whose inputs are
stacked along a new leading batch axis — the per-task overhead is paid
once per batch instead of once per request.

Window semantics (the "adaptive" part):

  * a bucket flushes when its window elapses (``window_s`` after the
    first request arrived),
  * early when it reaches ``max_batch`` requests (``"full"``),
  * earlier still when the tightest per-request deadline minus the
    fused-execution EMA says waiting any longer would miss an SLO
    (``"deadline"``) — a near-SLO request forces the flush for the
    whole bucket.

Fair share: the fused task costs what one task costs; each participant
owes 1/k of it. Callers pass a ``charge(cost)`` callback per request
(typically wired to ``FairShare.charge``) and the coalescer invokes it
with ``fused_seconds / k`` after each flush.

Telemetry: with an enabled tracer, every flush records a ``fused_batch``
span, which carries the fused run's trace id when ``fuse_fn`` links it
(:meth:`BatchCoalescer.link_run`), and every request in it two spans
under a trace of its own: ``frontdoor.request``, from its submission to
the moment its row (or error) is handed to its ticket, and its child
``frontdoor.wait``, from its submission to the start of the bucket's
``fuse_fn`` call, carrying the ``fused_batch`` span's id.

Coalescing is only safe for steps that are *batchable*: deterministic,
side-effect-free, same code fingerprint, and row-independent along the
stacked axis (request i's output row must not depend on request j's
input row). The verifier's W070 flags SLOs on steps that cannot meet
this contract.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.core.runtime import Event
from repro_torch.obs.tracing import wall_of


#: flush events a coalescer keeps (the newest)
EVENTS_CAP = 4096


class CoalesceError(RuntimeError):
    """The fused execution failed; every participant sees the error."""


class _Ticket:
    """One request's slot in a pending batch."""

    __slots__ = ("value", "deadline_perf", "charge", "_done", "_result",
                 "_error", "submitted_t")

    def __init__(self, value, deadline_perf, charge):
        self.value = value
        self.deadline_perf = deadline_perf
        self.charge = charge
        self.submitted_t = time.perf_counter()
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("fused batch still executing")
        if self._error is not None:
            raise self._error
        return self._result

    def done(self) -> bool:
        return self._done.is_set()

    def _finish(self, result=None, error=None):
        self._result = result
        self._error = error
        self._done.set()


@dataclass
class _Bucket:
    key: Any
    created_t: float
    tickets: List[_Ticket] = field(default_factory=list)


class BatchCoalescer:
    """Collects per-request decode steps into fused batched dispatches.

    ``fuse_fn(key, stacked, k)`` executes the fused work — typically one
    runtime submission over a batched decode workflow — and returns an
    array (or sequence) whose leading axis is the batch axis; row ``i``
    fans back to request ``i``'s ticket. One daemon thread owns all
    flush timing, so a submitter that never calls ``result()`` cannot
    stall the bucket.
    """

    def __init__(self, fuse_fn: Callable[[Any, np.ndarray, int], Any], *,
                 window_s: float = 0.004, max_batch: int = 32,
                 metrics=None, tracer=None, name: str = "coalescer"):
        self.fuse_fn = fuse_fn
        self.window_s = window_s
        self.max_batch = max_batch
        self.metrics = metrics
        self.tracer = tracer
        self.name = name
        # flush timeline (thread-safe appends; same Event type as runs),
        # a ring: a long-lived front door keeps only the newest flushes
        self.events: Deque[Event] = deque(maxlen=EVENTS_CAP)
        self._request_ids = itertools.count(1)
        self._run_trace: Optional[str] = None   # flush thread only
        self._cond = threading.Condition()
        self._buckets: Dict[Any, _Bucket] = {}
        self._closed = False
        self._exec_ema = 0.0             # fused execution seconds
        self.flushes = 0
        self.coalesced = 0
        self.fused_requests = 0
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"{name}-flush")
        self._thread.start()

    # ------------------------------------------------------------ submission
    def submit(self, key, value, *, deadline_s: Optional[float] = None,
               charge: Optional[Callable[[float], None]] = None) -> _Ticket:
        """Join the bucket for ``key``; returns a ticket whose
        ``result()`` yields this request's row of the fused output.
        ``deadline_s`` (relative) lets this request force an early flush;
        ``charge`` receives this request's 1/k share of the fused cost."""
        deadline_perf = None if deadline_s is None \
            else time.perf_counter() + deadline_s
        t = _Ticket(value, deadline_perf, charge)
        with self._cond:
            if self._closed:
                raise CoalesceError("coalescer is closed")
            b = self._buckets.get(key)
            if b is None:
                b = self._buckets[key] = _Bucket(key, time.perf_counter())
            b.tickets.append(t)
            self.coalesced += 1
            self._cond.notify_all()
        return t

    def link_run(self, trace_id: str):
        """Called by ``fuse_fn`` on the flush thread: the trace id of the
        run it submitted, which this flush's ``fused_batch`` span carries,
        so each request's spans lead to the run's."""
        self._run_trace = trace_id

    # ------------------------------------------------------------- flushing
    def _due_at(self, b: _Bucket) -> float:
        """Absolute perf_counter time this bucket must flush by."""
        if len(b.tickets) >= self.max_batch:
            return 0.0
        due = b.created_t + self.window_s
        deadlines = [t.deadline_perf for t in b.tickets
                     if t.deadline_perf is not None]
        if deadlines:
            # flush early enough that the fused execution (EMA) still
            # lands before the tightest participant deadline
            due = min(due, min(deadlines) - self._exec_ema)
        return due

    def _loop(self):
        while True:
            with self._cond:
                while not self._closed:
                    now = time.perf_counter()
                    due = [b for b in self._buckets.values()
                           if self._due_at(b) <= now]
                    if due:
                        break
                    horizon = min((self._due_at(b)
                                   for b in self._buckets.values()),
                                  default=None)
                    self._cond.wait(None if horizon is None
                                    else max(horizon - now, 0.0))
                if self._closed and not self._buckets:
                    return
                if self._closed:
                    due = list(self._buckets.values())
                for b in due:
                    self._buckets.pop(b.key, None)
            for b in due:
                self._flush(b)

    def _flush(self, b: _Bucket):
        k = len(b.tickets)
        if k == 0:
            return
        reason = "full" if k >= self.max_batch else (
            "deadline" if any(t.deadline_perf is not None
                              for t in b.tickets)
            and time.perf_counter() < b.created_t + self.window_s
            else "window")
        waited = time.perf_counter() - b.created_t
        stacked = np.stack([np.asarray(t.value) for t in b.tickets], axis=0)
        tr = self.tracer if self.tracer is not None \
            and self.tracer.enabled else None
        batch_id = 0
        if tr is not None:
            batch_id = tr.next_id()
            self._run_trace = None
        t0 = time.perf_counter()
        err: Optional[BaseException] = None
        out = None
        try:
            if tr is not None:
                # umbrella span: whatever fuse_fn opens on this thread
                # nests under the batch
                with tr.attach(("-", batch_id)):
                    out = self.fuse_fn(b.key, stacked, k)
            else:
                out = self.fuse_fn(b.key, stacked, k)
        except BaseException as e:
            err = e
        seconds = time.perf_counter() - t0
        if tr is not None:
            attrs = {"error": repr(err)} if err is not None else {}
            tr.add_span(self._run_trace or "-", "fused_batch", wall_of(t0),
                        seconds, span_id=batch_id, cat="serve",
                        track=f"coalescer:{self.name}", key=str(b.key),
                        batch=k, **attrs)
        self._exec_ema = seconds if self._exec_ema == 0.0 \
            else 0.5 * seconds + 0.5 * self._exec_ema
        self.flushes += 1
        self.fused_requests += k
        if self.metrics is not None:
            self.metrics.inc("frontdoor.flushes")
            self.metrics.observe("frontdoor.fused_batch", k)
        now = time.perf_counter()
        self.events.append(Event(
            "flush", "<batch>", "", now,
            {"key": str(b.key), "batch": k, "waited_s": waited,
             "reason": reason, "seconds": seconds}, time.time()))
        share = seconds / k
        handed = [] if tr is not None else None   # when each row went back
        for i, t in enumerate(b.tickets):
            if t.charge is not None:
                try:
                    t.charge(share)      # 1/k of the fused cost
                except Exception:
                    pass                 # accounting must not fail requests
            if err is not None:
                t._finish(error=CoalesceError(
                    f"fused batch over {b.key!r} failed: {err!r}"))
            else:
                try:
                    t._finish(result=out[i])
                except BaseException as e:
                    t._finish(error=CoalesceError(
                        f"fused batch over {b.key!r} returned no row "
                        f"{i} of {k}: {e!r}"))
            if handed is not None:
                handed.append(time.perf_counter())
        if tr is not None:
            track = f"requests:{self.name}"
            for t, t_end in zip(b.tickets, handed):
                trace = f"{self.name}.req{next(self._request_ids)}"
                req = tr.add_span(trace, "frontdoor.request",
                                  wall_of(t.submitted_t),
                                  t_end - t.submitted_t, cat="serve",
                                  track=track, key=str(b.key))
                tr.add_span(trace, "frontdoor.wait", wall_of(t.submitted_t),
                            t0 - t.submitted_t, parent_id=req, cat="serve",
                            track=track, batch_span=batch_id)

    # --------------------------------------------------------- introspection
    def introspect(self) -> dict:
        now = time.perf_counter()
        with self._cond:
            buckets = [{
                "key": str(b.key),
                "pending": len(b.tickets),
                "oldest_wait_s": now - b.created_t,
            } for b in self._buckets.values()]
        return {
            "name": self.name,
            "window_s": self.window_s,
            "max_batch": self.max_batch,
            "flushes": self.flushes,
            "coalesced": self.coalesced,
            "fused_requests": self.fused_requests,
            "avg_batch": (self.fused_requests / self.flushes)
            if self.flushes else 0.0,
            "exec_ema_s": self._exec_ema,
            "buckets": buckets,
        }

    # -------------------------------------------------------------- shutdown
    def close(self):
        """Flush everything still pending, then stop the flush thread."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=30.0)
