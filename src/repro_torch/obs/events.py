"""Event-schema registry: the contract for ``run.emit(kind, ...)``.

Every event kind the runtime emits is enumerated here with its required
``info`` keys, so event consumers (the trace exporter, emtop, user
post-processing) can rely on a stable schema instead of reverse-
engineering call sites. A lint test (``tests/test_obs.py``) greps the
source tree for ``emit(`` call sites and fails if any kind is missing
from this table — adding a new event kind without documenting it here is
a test failure, not a silent drift.

``required`` keys must be present in the event's ``info`` dict;
``optional`` keys may appear. :func:`validate_event` enforces this for
tests and for strict consumers.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, NamedTuple


class EventSchema(NamedTuple):
    kind: str
    required: FrozenSet[str]
    optional: FrozenSet[str]
    doc: str


def _s(kind: str, required=(), optional=(), doc: str = "") -> EventSchema:
    return EventSchema(kind, frozenset(required), frozenset(optional), doc)


#: kind -> schema, one row per ``emit(`` call-site kind in src/.
EVENT_SCHEMA: Dict[str, EventSchema] = {e.kind: e for e in [
    _s("dispatch",
       required=("lane",),
       doc="Driver granted the step a lane slot — the happens-before "
           "anchor the hazard sanitizer pairs with step_done."),
    _s("place",
       required=("reason",),
       optional=("scores", "stale_bytes"),
       doc="Locality policy chose a tier for a ready step."),
    _s("suspend", doc="Run suspended (admission/residency pressure)."),
    _s("resume", doc="Run resumed after suspension."),
    _s("step_done",
       required=("offloaded",),
       doc="Step result published and committed; DAG successors unblock."),
    _s("local",
       required=("seconds",),
       optional=("memo_hit",),
       doc="Step executed in-process on the local tier."),
    _s("offload",
       required=("seconds",),
       optional=("bytes_in", "bytes_out", "code_only", "attempt", "remote",
                 "worker_pid", "staged_s", "memo_hit"),
       doc="Step executed on the offload fabric (or fell back after "
           "retries; see attempt/remote)."),
    _s("retry",
       required=("attempt",),
       optional=("error",),
       doc="Offload attempt failed; the step is being retried."),
    _s("speculate",
       required=("timeout",),
       doc="Straggler guard launched a local twin of an offloaded step."),
    _s("prefetch",
       optional=("uris", "n"),
       doc="MDSS prefetch of predicted-next inputs kicked off."),
    _s("checkpoint",
       required=("n",),
       doc="Run checkpoint persisted (n = completed steps captured)."),
    _s("scatter",
       required=("shards", "parent"),
       optional=("uris",),
       doc="Fan-out scatter completed: the parent step's inputs were "
           "partitioned into per-shard content-addressed values uri#k."),
    _s("shard_done",
       required=("shard", "parent"),
       doc="One fan-out shard (shard = k, parent = the original step) "
           "finished and published its out#k value."),
    _s("gather",
       required=("shards", "parent"),
       doc="Fan-out gather completed: shard outputs were combined into "
           "the parent step's declared outputs."),
    _s("park",
       required=("reason",),
       optional=("deadline_s", "slo_ms", "depth"),
       doc="Submission could not be admitted immediately and was parked "
           "in the front door's bounded admission queue."),
    _s("admit",
       required=("waited_s",),
       optional=("slack_s", "depth"),
       doc="A parked run was admitted by the drain loop (oldest deadline "
           "first) once residency and lane capacity freed."),
    _s("coalesce",
       required=("key", "pending"),
       optional=("deadline_s",),
       doc="A decode request joined a BatchCoalescer bucket and is "
           "waiting for the flush window."),
    _s("flush",
       required=("key", "batch"),
       optional=("waited_s", "reason", "seconds"),
       doc="A coalescer bucket flushed: k requests were stacked along "
           "the batch axis and dispatched as ONE fused task."),
    _s("preempt",
       required=("victim",),
       optional=("slack_s", "step"),
       doc="An interactive run's SLO was threatened; the longest-running "
           "preemptible batch task was checkpoint-aborted and requeued "
           "attempt-free."),
]}


def validate_event(kind: str, info: dict) -> None:
    """Raise ``ValueError`` if ``kind`` is unregistered or ``info`` is
    missing a required key / carries an undeclared key."""
    schema = EVENT_SCHEMA.get(kind)
    if schema is None:
        raise ValueError(f"unregistered event kind: {kind!r}")
    missing = schema.required - set(info)
    if missing:
        raise ValueError(f"event {kind!r} missing required info keys: "
                         f"{sorted(missing)}")
    unknown = set(info) - schema.required - schema.optional
    if unknown:
        raise ValueError(f"event {kind!r} carries undeclared info keys: "
                         f"{sorted(unknown)}")
