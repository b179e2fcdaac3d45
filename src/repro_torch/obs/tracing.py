"""Structured tracing for the Emerald runtime (stdlib-only on purpose).

A :class:`Span` is one timed phase of a run — submit, dispatch, place,
ship, exec, install, complete — identified by ``(trace_id, span_id)``
and parented to the span that was *current on the emitting thread* when
it opened (or to an explicit parent). The runtime assigns one trace per
run (``trace_id == run_id``), so a multi-tenant process interleaves N
traces through one :class:`Tracer` and exports any of them separately.

Two clocks, by design:

  * ``t0_wall`` is a wall-clock epoch timestamp (seconds since the Unix
    epoch) — the only timestamp comparable across *processes*: driver
    and worker both derive it from the system clock, so worker-side
    phases land on the same exported timeline as driver-side spans;
  * ``dur_s`` is a monotonic duration (``perf_counter`` delta) — wall
    clock can step, monotonic deltas cannot.

Cross-process propagation: the driver passes ``ctx()`` — a
``(trace_id, span_id)`` pair — in the task frame header (the broker's
message dict); the worker reports its phase timings back in the reply
and the broker re-materialises them as child spans via
:meth:`Tracer.add_span`. Workers therefore never import this module.

Export is Chrome trace-event JSON (``{"traceEvents": [...]}``) loadable
in Perfetto / ``chrome://tracing``: one *track* (pid, tid) per
lane/worker/tenant, ``X`` (complete) events carrying
``trace_id``/``span_id``/``parent_id`` in ``args`` so parentage survives
even when time-nesting is ambiguous, and ``M`` metadata events naming
every process and track.

The profiler's clock: while a ``torch.profiler`` records, each span
opened with :meth:`Tracer.span` also opens a
``torch.profiler.record_function`` of its name on the same thread, so
the program's phases appear as user annotations in the profiler's own
trace, on the device's timeline. torch is looked up in ``sys.modules``,
never imported; with no profiler recording that costs one lookup and one
attribute read per span.

Overhead: a disabled tracer's ``span()`` returns a shared no-op context
manager — one attribute load and one ``if`` on the hot path. An enabled
tracer appends finished spans to a bounded ring (oldest spans drop
first; ``dropped`` counts them), so a long-lived service never grows an
unbounded trace log.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# Shared wall/monotonic epoch pair: every conversion in this process uses
# the SAME anchor, so two spans' wall timestamps differ by exactly their
# monotonic offset — no per-call clock skew inside a process.
_EPOCH_WALL = time.time()
_EPOCH_PERF = time.perf_counter()

SpanCtx = Tuple[str, int]          # (trace_id, span_id)


def wall_of(perf_t: float) -> float:
    """Wall-clock epoch seconds for a ``perf_counter`` reading."""
    return _EPOCH_WALL + (perf_t - _EPOCH_PERF)


def wall_now() -> float:
    return wall_of(time.perf_counter())


@dataclass
class Span:
    trace_id: str
    span_id: int
    parent_id: int                 # 0 = root (no parent)
    name: str
    cat: str = ""
    track: str = "driver"          # one timeline row per track at export
    t0_wall: float = 0.0           # wall-clock epoch seconds
    dur_s: float = 0.0             # monotonic duration
    pid: int = 0                   # 0 -> this process
    attrs: Dict[str, Any] = field(default_factory=dict)


class _NoopSpan:
    """Context manager returned by a disabled tracer — near-zero cost."""
    __slots__ = ()
    ctx: Optional[SpanCtx] = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def _profiler_annotation(name: str):
    """An open ``record_function(name)`` while a ``torch.profiler``
    records, else None. The profiler's module-wide flag, not
    ``torch.autograd._profiler_enabled()``: that one is per thread, and
    reads False on every thread of a profiler that records them all."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not getattr(prof, "_is_profiler_enabled", False):
        return None
    rf = prof.record_function(name)
    rf.__enter__()
    return rf


class _ActiveSpan:
    """An open span: records on exit, exposes ``ctx`` for propagation."""
    __slots__ = ("tracer", "span", "_t0_perf", "_stack", "_rf")

    def __init__(self, tracer: "Tracer", span: Span, stack: list):
        self.tracer = tracer
        self.span = span
        self._stack = stack
        self._t0_perf = 0.0
        self._rf = None

    @property
    def ctx(self) -> SpanCtx:
        return (self.span.trace_id, self.span.span_id)

    def set(self, **attrs):
        self.span.attrs.update(attrs)

    def __enter__(self):
        self._rf = _profiler_annotation(self.span.name)
        self._t0_perf = time.perf_counter()
        self.span.t0_wall = wall_of(self._t0_perf)
        self._stack.append(self.ctx)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.span.dur_s = time.perf_counter() - self._t0_perf
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            self.span.attrs["error"] = repr(exc)
        stack = self._stack
        if stack and stack[-1] == self.ctx:
            stack.pop()
        self.tracer._record(self.span)
        return False


class _Attach:
    """Push a foreign ctx as the thread's current span (no recording) —
    how a helper thread (speculation twin, prefetch) inherits the
    dispatching span's identity."""
    __slots__ = ("_stack", "_ctx")

    def __init__(self, stack: list, ctx: Optional[SpanCtx]):
        self._stack = stack
        self._ctx = ctx

    def __enter__(self):
        if self._ctx is not None:
            self._stack.append(self._ctx)
        return self

    def __exit__(self, *exc):
        if self._ctx is not None and self._stack \
                and self._stack[-1] == self._ctx:
            self._stack.pop()
        return False


class Tracer:
    """Thread-safe collector of finished spans with TLS parenting."""

    def __init__(self, enabled: bool = True, cap: int = 65536):
        self.enabled = enabled
        self.cap = cap
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=cap)
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self.dropped = 0
        self.pid = os.getpid()

    # ------------------------------------------------------------- recording
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_ctx(self) -> Optional[SpanCtx]:
        """(trace_id, span_id) of this thread's innermost open span."""
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    def next_id(self) -> int:
        return next(self._ids)

    def span(self, name: str, cat: str = "", track: str = "driver",
             trace_id: Optional[str] = None, parent: Optional[SpanCtx] = None,
             **attrs):
        """Open a span as a context manager. Parent defaults to the
        thread's current span; ``trace_id`` defaults to the parent's
        (``"-"`` for an unparented span — e.g. a bare ``manager.execute``
        outside any run)."""
        if not self.enabled:
            return _NOOP
        stack = self._stack()
        if parent is None and stack:
            parent = stack[-1]
        if trace_id is None:
            trace_id = parent[0] if parent is not None else "-"
        sp = Span(trace_id, self.next_id(),
                  parent[1] if parent is not None else 0,
                  name, cat=cat, track=track, pid=self.pid, attrs=attrs)
        return _ActiveSpan(self, sp, stack)

    def attach(self, ctx: Optional[SpanCtx]):
        """Context manager making ``ctx`` this thread's current span."""
        if not self.enabled:
            return _NOOP
        return _Attach(self._stack(), ctx)

    def add_span(self, trace_id: str, name: str, t0_wall: float, dur_s: float,
                 *, parent_id: int = 0, cat: str = "", track: str = "driver",
                 pid: int = 0, span_id: Optional[int] = None,
                 **attrs) -> Optional[int]:
        """Record an externally-measured span (e.g. worker-reported
        timings). ``span_id`` records under a pre-allocated identity
        (how the run root span keeps the id its children parented to).
        Returns the span id (None when disabled)."""
        if not self.enabled:
            return None
        sp = Span(trace_id, span_id if span_id is not None
                  else self.next_id(), parent_id, name, cat=cat,
                  track=track, t0_wall=t0_wall, dur_s=dur_s,
                  pid=pid or self.pid, attrs=attrs)
        self._record(sp)
        return sp.span_id

    def _record(self, sp: Span):
        if not self.enabled:
            return
        with self._lock:
            if len(self._spans) == self.cap:
                self.dropped += 1
            self._spans.append(sp)

    # --------------------------------------------------------------- reading
    def spans(self, trace_id: Optional[str] = None) -> List[Span]:
        with self._lock:
            snap = list(self._spans)
        if trace_id is None:
            return snap
        return [s for s in snap if s.trace_id == trace_id]

    def clear(self):
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    # ---------------------------------------------------------------- export
    def export(self, trace_id: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (a dict; ``json.dump``-able) with one
        track per distinct (pid, track) pair."""
        return chrome_trace(self.spans(trace_id))

    def export_json(self, path: str, trace_id: Optional[str] = None) -> str:
        doc = self.export(trace_id)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def chrome_trace(spans: List[Span]) -> dict:
    """Render ``spans`` as a Chrome trace-event document.

    ``X`` (complete) events carry ``ts``/``dur`` in microseconds;
    ``args`` keeps the explicit span identity (``trace_id``/``span_id``/
    ``parent_id``) plus user attrs, so consumers can rebuild the exact
    parent tree rather than inferring it from time nesting. ``M``
    metadata events name each process and each track.
    """
    own_pid = os.getpid()
    events: List[dict] = []
    tids: Dict[Tuple[int, str], int] = {}
    pids_named: set = set()
    for sp in spans:
        pid = sp.pid or own_pid
        key = (pid, sp.track)
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = len(tids) + 1
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": sp.track}})
        if pid not in pids_named:
            pids_named.add(pid)
            role = "driver" if pid == own_pid else "worker"
            events.append({"ph": "M", "pid": pid, "tid": 0,
                           "name": "process_name",
                           "args": {"name": f"{role} (pid {pid})"}})
        args = {"trace_id": sp.trace_id, "span_id": sp.span_id,
                "parent_id": sp.parent_id}
        for k, v in sp.attrs.items():
            args[k] = v if isinstance(v, (int, float, str, bool,
                                          type(None))) else repr(v)
        events.append({"ph": "X", "pid": pid, "tid": tid, "name": sp.name,
                       "cat": sp.cat or "span",
                       "ts": sp.t0_wall * 1e6, "dur": sp.dur_s * 1e6,
                       "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
