"""Happens-before hazard sanitizer over the runtime's event stream.

The observability layer gives every run an ordered event log and
the MDSS a replica install/eviction log. This module replays those logs
through a vector-clock-lite checker: per step it pairs ``dispatch``
(lane grant) with ``step_done`` (result committed); per ``(uri, tier,
namespace-epoch)`` it demands monotone replica versions and
install-before-evict ordering. Violations are the concurrency bugs the
runtime's guards exist to prevent — a clean production run must produce
zero findings, which is exactly what :func:`record_submissions`
asserts over every runtime submission made inside it.

Hazard classes (catalogue in ``repro_torch.analysis.findings``):

  * H101 duplicate-done    — more completions than dispatches for a step
  * H102 orphan-completion — completion for a never-dispatched step
  * H103 lost-completion   — dispatch without completion in a run that
                             finished successfully
  * H110 install-regression — replica version decreased within one
                             ``(uri, tier, namespace epoch)``
  * H111 evict-install-race — eviction of a replica version never
                             installed on that tier
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis import findings as F
from repro_torch.analysis.findings import Finding, finding


def _field(e, name, default=None):
    if isinstance(e, dict):
        return e.get(name, default)
    return getattr(e, name, default)


def check(events: Iterable, *, completed_run: bool = True
          ) -> List[Finding]:
    """Replay a run's event log; return happens-before violations.

    ``events``: Event objects (or dicts) with ``kind``/``step``/``t``.
    The log may concatenate several sequential runs (the compat shim
    reuses one sink): pairing is by count, so N dispatches matched by N
    completions stay clean regardless of interleaving. Set
    ``completed_run=False`` for failed/cancelled runs, where a dispatch
    legitimately never reports done (H103 is skipped).
    """
    evs = sorted(events, key=lambda e: _field(e, "t", 0.0) or 0.0)
    dispatched: Dict[str, int] = {}     # step -> dispatches seen so far
    pending: Dict[str, int] = {}        # step -> dispatches awaiting done
    out: List[Finding] = []
    for e in evs:
        kind = _field(e, "kind")
        step = _field(e, "step", "")
        if kind == "dispatch":
            dispatched[step] = dispatched.get(step, 0) + 1
            pending[step] = pending.get(step, 0) + 1
        elif kind == "step_done":
            if pending.get(step, 0) > 0:
                pending[step] -= 1
            elif dispatched.get(step, 0) > 0:
                out.append(finding(
                    F.H101,
                    f"step {step} reported done more often than it was "
                    "dispatched (double completion)",
                    steps=(step,)))
            else:
                out.append(finding(
                    F.H102,
                    f"step {step} reported done but was never "
                    "dispatched", steps=(step,)))
    if completed_run:
        for step, n in sorted(pending.items()):
            if n > 0:
                out.append(finding(
                    F.H103,
                    f"step {step} was dispatched but never reported "
                    f"done ({n} completion(s) missing) in a run that "
                    "finished successfully", steps=(step,)))
    return out


def check_store(mdss_or_installs, evictions=None, *,
                complete: bool = True) -> List[Finding]:
    """Replay an MDSS replica log; return version-ordering violations.

    Pass an ``MDSS`` (its ``install_events`` / ``eviction_events`` /
    ``installs_total`` are read), or explicit row lists: installs
    ``(uri, tier, version, epoch, t)`` and evictions ``(uri, tier,
    bytes, version, epoch, t)``. ``complete=False`` (set automatically
    when the store's bounded log has been trimmed) skips H111, which
    needs the full install history to judge an eviction.
    """
    if evictions is None and hasattr(mdss_or_installs, "install_events"):
        m = mdss_or_installs
        installs = list(m.install_events)
        evictions = list(getattr(m, "eviction_events", ()))
        complete = complete and \
            getattr(m, "installs_total", len(installs)) == len(installs)
    else:
        installs = list(mdss_or_installs)
        evictions = list(evictions or ())

    out: List[Finding] = []
    # Merge both logs on t so "prior install" means prior in time.
    rows = [(r[4], 0, r) for r in installs] + \
           [(r[5], 1, r) for r in evictions]
    rows.sort(key=lambda x: (x[0], x[1]))
    high: Dict[Tuple[str, str, int], int] = {}   # (uri,tier,epoch) -> max v
    seen: set = set()                            # installed (uri,tier,v,ep)
    for _, which, r in rows:
        if which == 0:
            uri, tier, version, epoch = r[0], r[1], r[2], r[3]
            key = (uri, tier, epoch)
            prev = high.get(key)
            if prev is not None and version < prev:
                out.append(finding(
                    F.H110,
                    f"{uri} on tier {tier} regressed from version "
                    f"{prev} to {version} within namespace epoch "
                    f"{epoch} — a stale install overwrote a newer "
                    "write", uri=uri))
            if prev is None or version > prev:
                high[key] = version
            seen.add((uri, tier, version, epoch))
        else:
            uri, tier, version, epoch = r[0], r[1], r[3], r[4]
            if complete and (uri, tier, version, epoch) not in seen:
                out.append(finding(
                    F.H111,
                    f"{uri} version {version} was evicted from tier "
                    f"{tier} (epoch {epoch}) but that version was "
                    "never installed there — eviction raced an "
                    "in-flight install", uri=uri))
    return out


def check_runtime(runtime, handles) -> List[Finding]:
    """Convenience: sanitize finished ``handles`` of ``runtime`` plus
    its store's replica log. Failed/cancelled runs are checked too —
    duplicate dones (H101) and orphan completions (H102) are hazards on
    any run; only the lost-completion pairing (H103) is restricted to
    runs that finished successfully, since an aborted run legitimately
    drops dones."""
    out: List[Finding] = []
    for h in handles:
        state = getattr(h, "state", "done")
        out.extend(check(h.events, completed_run=(state == "done")))
    mdss = getattr(runtime, "mdss", None)
    if mdss is not None:
        out.extend(check_store(mdss))
    return out


_SETTLED = ("done", "failed", "cancelled")


@dataclass
class SettledRun:
    """What is kept of one settled submission: its terminal state, its
    event log (copied when the recording ends; runs that shared a log
    share the copy) and the rule ids admission attached to it."""
    state: str
    events: list
    admission_rules: Tuple[str, ...]


@dataclass
class Submissions:
    """The runs and stores :func:`record_submissions` saw, and the
    sanitizer's findings over them (filled in when the block exits)."""
    runs: List[SettledRun] = field(default_factory=list)
    stores: list = field(default_factory=list)
    skipped: int = 0              # submissions still running at exit
    findings: List[Finding] = field(default_factory=list)

    @property
    def events(self) -> int:
        """Events replayed: a log that several runs share counts once per
        run, as each run replays it."""
        return sum(len(r.events) for r in self.runs)

    @property
    def distinct_events(self) -> int:
        logs = {id(r.events): r.events for r in self.runs}
        return sum(len(log) for log in logs.values())

    def install_log(self) -> Tuple[int, int]:
        """(installs logged, installs_total) over the stores: H111 is
        judged only where the two are equal (the log was never trimmed)."""
        return (sum(len(m.install_events) for m in self.stores),
                sum(m.installs_total for m in self.stores))


@contextmanager
def record_submissions():
    """Sanitize every ``EmeraldRuntime.submit`` made inside the block.

    ``submit`` is wrapped for the block's duration. On exit every settled
    run is replayed through :func:`check` (H103 only for runs that ended
    ``done``; still-running handles are skipped, their logs legitimately
    mid-flight) and each distinct store through :func:`check_store`; the
    findings land in the yielded :class:`Submissions`. A handle is held
    only until it settles: then its state is kept and the handle, with
    the results it pins, is let go. Its event log is read on exit, as a
    log that several runs share (an executor's) is complete only then.
    """
    from repro_torch.core.runtime import EmeraldRuntime

    rec = Submissions()
    pending: list = []            # (store, handle) not settled yet
    stores: Dict[int, object] = {}
    lock = threading.Lock()

    def settle():
        still = []
        for mdss, h in pending:
            state = h.state
            if state in _SETTLED:
                rec.runs.append(SettledRun(
                    state, h.events, tuple(f.rule for f in h.findings)))
                stores.setdefault(id(mdss), mdss)
            else:
                still.append((mdss, h))
        pending[:] = still

    orig = EmeraldRuntime.submit

    def spying_submit(self, workflow, *a, **kw):
        h = orig(self, workflow, *a, **kw)
        with lock:
            pending.append((self.mdss, h))
            settle()
        return h

    EmeraldRuntime.submit = spying_submit
    try:
        yield rec
    finally:
        EmeraldRuntime.submit = orig
        with lock:
            settle()
            rec.skipped = len(pending)
            pending.clear()
        rec.stores = list(stores.values())
        copies: Dict[int, list] = {}     # one copy of each shared log
        for r in rec.runs:
            r.events = copies.setdefault(id(r.events), list(r.events))
            rec.findings += check(r.events,
                                  completed_run=(r.state == "done"))
        for mdss in rec.stores:
            rec.findings += check_store(mdss)
