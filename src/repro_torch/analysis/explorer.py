"""emcheck — deterministic schedule-space exploration for Emerald.

The sanitizer judges *one* interleaving: whatever the threads
happened to do in that test run. This module enumerates interleavings.
It builds a model of ``EmeraldRuntime``'s scheduling semantics — lanes,
fair share, namespaced versioned store with budgets/eviction, cross-run
memoization, per-completion checkpoints — on top of the
:mod:`repro_torch.cloud.simfabric` virtual-clock seam, where every
nondeterministic choice the real system resolves with thread timing is
an explicit, replayable *decision*:

  ``dispatch:<run>:<step>``   which ready step takes a free lane slot
  ``complete:<run>:<step>``   which in-flight completion lands first
  ``crash:<run>:<step>``      a worker dies under the task (burns a retry)
  ``timeout:<run>:<step>``    a ship times out and is harvested (no burn)
  ``preempt:<run>:<step>``    spot-style reclaim of the worker (no burn)
  ``install:<run>:<uri>``     a deferred write-back install lands
  ``ghost:<run>:<step>``      a duplicate completion lands (bug-flag only)
  ``drop:<run>``              namespace drop + warm resubmit

A ``Schedule`` is just the list of decisions taken; replaying it through
a fresh :class:`Simulation` reproduces the identical trace, which is
what makes minimized reproducer files deterministic.

Exploration strategies:

  * :func:`explore` — exhaustive DFS for small DAGs, with visited-state
    dedup and a conservative partial-order reduction: when the *only*
    enabled decisions are completions of tasks touching pairwise
    disjoint output URIs (and no shared memo key), all orders commute,
    so a single canonical order is explored.
  * :func:`sample` — seeded random walks for large DAGs, with
    crash/preempt/timeout injection driven by the fault budgets.

Every explored trace replays through the sanitizer (H101–H111)
plus the cross-schedule invariants registered in ``findings.py``:
H120 fence-epoch regression, H121 memo double-execution, H122
fair-share starvation, H123 residency-budget overshoot, H124
checkpoint/resume divergence, H125 parked-run starvation, H126
preemption burning batch progress. A hazard-triggering schedule is
delta-debugged (:func:`minimize`) to a 1-minimal decision list and
serialized (:func:`save_reproducer`) for ``python -m
repro_torch.tools.emcheck --replay``.

Planted bugs: a model built with ``bugs={...}`` re-introduces a known
defect so the explorer can be validated against it (see ``BUGS``); the
flag ``duplicate_done`` is exactly the double-decrement race the
runtime's outstanding-set guard exists to prevent.
"""
from __future__ import annotations

import hashlib
import json
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..core.workflow import Workflow
from ..cloud.simfabric import LOCAL, OFFLOAD, SimClock, SimFabric
from . import sanitizer
from .findings import Finding, finding

EMCHECK_VERSION = 1

#: planted-defect flags a model understands (each maps to the hazard the
#: explorer must find when the flag is set):
#:   duplicate_done — the double-decrement bug: a late/replayed completion is not
#:                    rejected by the outstanding-set guard  -> H101
#:   stale_install  — deferred write-back installs skip the version/
#:                    epoch fence                            -> H110/H120
#:   memo_no_guard  — the in-flight memo entry is not consulted, so a
#:                    concurrent same-key tenant re-executes -> H121
#:   unfair         — dispatch is not restricted to minimal-vtime runs,
#:                    so a schedule can starve a tenant      -> H122
#:   no_evict       — installs never trigger budget eviction -> H123
#:   ckpt_lost_step — the checkpoint freeze captures a step's outputs
#:                    but not its completion bit (the freeze
#:                    race), so resume re-applies it         -> H124
#:   parked_starved — the admission drain runs only at submit time
#:                    and misses the capacity-freed wakeup, so a
#:                    parked run stays eligible forever      -> H125
#:   preempt_lost_step — preemption burns a retry attempt and
#:                    discards the newest checkpointed step  -> H126
BUGS = ("duplicate_done", "stale_install", "memo_no_guard", "unfair",
        "no_evict", "ckpt_lost_step", "parked_starved",
        "preempt_lost_step")

Schedule = List[str]


def _digest(*parts: str) -> str:
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]


# =============================================================== model spec

@dataclass
class Tenant:
    """One simulated run: a real :class:`Workflow` plus submit options."""
    name: str
    wf: Workflow
    weight: float = 1.0
    init: Dict[str, str] = field(default_factory=dict)   # uri -> value token
    budgets: Dict[str, int] = field(default_factory=dict)  # tier -> bytes
    resubmit: bool = False   # after completing, drop namespace + run again
    park: bool = False       # submit into the admission queue (front door)
    deadline: float = 0.0    # admission order key: oldest deadline first


@dataclass
class SimModel:
    """A reconstructible scenario: tenants + knobs + planted bugs.

    ``name``/``params`` identify the builder in :data:`MODELS` so a
    reproducer file can rebuild the exact model; ad-hoc models (e.g.
    workflows collected from a user module by ``repro_torch.tools.emcheck``)
    leave ``name`` empty and are replayable only in-process.
    """
    tenants: List[Tenant]
    offload_slots: int = 2
    local_slots: int = 1
    memoize: bool = False
    max_crashes: int = 0
    max_timeouts: int = 0
    max_preempts: int = 0
    starvation_window: int = 8
    admit_capacity: int = 0   # >0: parked tenants drain through this many
                              # concurrently-live admitted-run slots
    accum_steps: Set[str] = field(default_factory=set)
    bugs: Set[str] = field(default_factory=set)
    name: str = ""
    params: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self):
        unknown = set(self.bugs) - set(BUGS)
        assert not unknown, f"unknown bug flags: {sorted(unknown)}"

    @property
    def fair(self) -> bool:
        return "unfair" not in self.bugs


# ============================================================== simulation

class _SimRun:
    """Per-tenant dataflow state over the real Workflow object."""

    def __init__(self, tenant: Tenant):
        self.tenant = tenant
        self.name = tenant.name
        wf = tenant.wf
        self.steps = dict(wf.steps)
        self.succs = wf.successors()
        self.indeg = dict(wf.in_degrees())
        self.remaining = dict(self.indeg)
        self.completed: Set[str] = set()
        self.ready: List[str] = sorted(
            n for n, d in self.indeg.items() if d == 0)
        self.failed = False
        self.passes = 0           # completed warm-resubmit passes
        self.events: List[dict] = []
        # last consistent checkpoint: (completed frozenset, {uri: digest})
        self.ckpt: Tuple[frozenset, Dict[str, str]] = (frozenset(), {})

    def lane_of(self, step: str) -> str:
        return OFFLOAD if self.steps[step].remotable else LOCAL

    def reset_for_resubmit(self):
        self.remaining = dict(self.indeg)
        self.completed = set()
        self.ready = sorted(n for n, d in self.indeg.items() if d == 0)
        self.ckpt = (frozenset(), {})

    def done(self) -> bool:
        if self.failed:
            return True
        finished = len(self.completed) == len(self.steps)
        if self.tenant.resubmit:
            return finished and self.passes >= 1
        return finished


class SimStore:
    """Namespaced, versioned, budgeted content store (the MDSS model).

    Tracks per-URI versions and content digests, per-(uri, tier)
    replicas, per-namespace epochs, per-(namespace, tier) resident
    bytes with LRU eviction against tenant budgets, and the same
    install/eviction rows the sanitizer's ``check_store`` replays:
    ``(uri, tier, version, epoch, t)`` and
    ``(uri, tier, bytes, version, epoch, t)``.
    """

    def __init__(self, model: SimModel):
        self.model = model
        self.versions: Dict[str, int] = {}
        self.digests: Dict[str, str] = {}
        self.bytes_of: Dict[str, int] = {}
        self.replicas: Dict[Tuple[str, str], Tuple[int, int]] = {}
        self.epochs: Dict[str, int] = {t.name: 0 for t in model.tenants}
        self.lru: Dict[Tuple[str, str], List[str]] = {}   # (ns,tier)->uris
        self.installs: List[tuple] = []
        self.evictions: List[tuple] = []
        self.residency: List[tuple] = []  # (t, ns, tier, bytes)

    @staticmethod
    def ns_of(uri: str) -> str:
        return uri.split("/", 1)[0]

    def resident_bytes(self, ns: str, tier: str) -> int:
        return sum(self.bytes_of.get(u, 0)
                   for u in self.lru.get((ns, tier), ()))

    def _touch(self, uri: str, tier: str):
        ns = self.ns_of(uri)
        row = self.lru.setdefault((ns, tier), [])
        if uri in row:
            row.remove(uri)
        row.append(uri)

    def install(self, uri: str, tier: str, version: int, epoch: int,
                t: float, nbytes: int):
        self.installs.append((uri, tier, version, epoch, t))
        self.replicas[(uri, tier)] = (version, epoch)
        self.bytes_of[uri] = nbytes
        self._touch(uri, tier)

    def put(self, run: "_SimRun", uri: str, digest: str, nbytes: int,
            t: float, tier: str) -> int:
        ns = self.ns_of(uri)
        v = self.versions.get(uri, 0) + 1
        self.versions[uri] = v
        self.digests[uri] = digest
        self.install(uri, tier, v, self.epochs[ns], t, nbytes)
        return v

    def enforce_budget(self, ns: str, tier: str, t: float):
        budget = None
        for ten in self.model.tenants:
            if ten.name == ns:
                budget = ten.budgets.get(tier)
        if budget is None:
            return
        if "no_evict" in self.model.bugs:
            return
        row = self.lru.get((ns, tier), [])
        while row and self.resident_bytes(ns, tier) > budget:
            victim = row.pop(0)
            ver, ep = self.replicas.pop((victim, tier),
                                        (self.versions.get(victim, 1),
                                         self.epochs[ns]))
            self.evictions.append((victim, tier,
                                   self.bytes_of.get(victim, 0),
                                   ver, ep, t))

    def sample_residency(self, t: float):
        for ten in self.model.tenants:
            for tier in ten.budgets:
                self.residency.append(
                    (t, ten.name, tier,
                     self.resident_bytes(ten.name, tier)))

    def drop_namespace(self, ns: str):
        self.epochs[ns] += 1
        prefix = ns + "/"
        for uri in [u for u in self.versions if u.startswith(prefix)]:
            self.versions.pop(uri)
            self.digests.pop(uri, None)
            self.bytes_of.pop(uri, None)
        for key in [k for k in self.replicas if k[0].startswith(prefix)]:
            self.replicas.pop(key)
        for key in list(self.lru):
            if key[0] == ns:
                self.lru[key] = []

    def state_key(self) -> tuple:
        return (tuple(sorted(self.versions.items())),
                tuple(sorted(self.replicas.items())),
                tuple(sorted(self.epochs.items())),
                tuple(sorted((k, tuple(v)) for k, v in self.lru.items())))


class Simulation:
    """One deterministic execution of a :class:`SimModel`.

    Drive it with :meth:`enabled` / :meth:`apply`; the decisions taken
    accumulate in ``self.schedule``. ``preload`` (used by the H124
    resume check) seeds a tenant's completed set and variable digests
    from a checkpoint before the first decision.
    """

    def __init__(self, model: SimModel,
                 preload: Optional[Dict[str, Tuple[frozenset,
                                                   Dict[str, str]]]] = None):
        self.model = model
        self.clock = SimClock()
        self.fabric = SimFabric(
            self.clock, offload_slots=model.offload_slots,
            local_slots=model.local_slots, max_crashes=model.max_crashes,
            max_timeouts=model.max_timeouts,
            max_preempts=model.max_preempts)
        self.store = SimStore(model)
        self.runs: Dict[str, _SimRun] = {}
        self.vtime: Dict[str, float] = {}
        self.exec_nonce = 0
        self.memo_done: Dict[str, str] = {}      # key -> owner "run:step"
        self.memo_inflight: Dict[str, Tuple[str, str]] = {}
        self.executions: List[tuple] = []        # (key, run, step, t)
        self.dispatch_rounds: List[tuple] = []   # (chosen_run, owed tuple)
        self.admission_rounds: List[tuple] = []  # (admitted tuple, eligible)
        self.preempt_log: List[tuple] = []       # (run, step, d_attempts,
                                                 #  ckpt_before, ckpt_after)
        self.pending: List[str] = []             # deferred install/ghost
        self.pending_installs: Dict[str, tuple] = {}  # decision -> payload
        self.schedule: Schedule = []
        self.parked: List[str] = []       # park tenants awaiting admission
        for ten in model.tenants:
            run = _SimRun(ten)
            self.runs[ten.name] = run
            self.vtime[ten.name] = 0.0
            if ten.park and model.admit_capacity:
                self.parked.append(ten.name)
            for uri, token in ten.init.items():
                full = f"{ten.name}/{uri}"
                self.store.put(run, full, _digest("init", token), 1,
                               self.clock.now(), LOCAL)
        # submit-time drain: both the clean model and the parked_starved
        # bug admit whatever fits right now — the bug is that ONLY this
        # drain ever runs (the capacity-freed wakeup is lost)
        self._drain_admission()
        if preload:
            for name, (completed, digests) in preload.items():
                run = self.runs[name]
                run.completed = set(completed)
                for step in completed:
                    for succ in run.succs.get(step, ()):
                        run.remaining[succ] -= 1
                run.ready = sorted(
                    n for n in run.steps
                    if n not in run.completed and run.remaining[n] == 0)
                t = self.clock.now()
                for uri, dig in digests.items():
                    full = f"{name}/{uri}"
                    ns = name
                    v = self.store.versions.get(full, 0) + 1
                    self.store.versions[full] = v
                    self.store.digests[full] = dig
                    self.store.install(full, LOCAL, v,
                                       self.store.epochs[ns], t, 1)

    # ----------------------------------------------------------- enumeration
    def done(self) -> bool:
        return (all(r.done() for r in self.runs.values())
                and self.fabric.idle())

    def _dispatch_candidates(self, lane: str) -> List[Tuple[str, str]]:
        """(run, step) pairs dispatchable on ``lane`` right now."""
        out = []
        for name in sorted(self.runs):
            run = self.runs[name]
            if run.failed or name in self.parked:
                continue
            for step in run.ready:
                if run.lane_of(step) == lane:
                    out.append((name, step))
        return out

    # ------------------------------------------------------------- admission
    def _admission_eligible(self) -> List[str]:
        """Parked runs the front door owes admission right now: free
        admitted-run slots filled oldest-deadline-first (strict
        head-of-queue, like the runtime's drain loop)."""
        if not self.model.admit_capacity or not self.parked:
            return []
        live = sum(1 for n, r in self.runs.items()
                   if r.tenant.park and n not in self.parked
                   and not r.done())
        free = self.model.admit_capacity - live
        if free <= 0:
            return []
        order = sorted(self.parked,
                       key=lambda n: (self.runs[n].tenant.deadline, n))
        return order[:free]

    def _drain_admission(self) -> List[str]:
        admitted: List[str] = []
        while True:
            elig = self._admission_eligible()
            if not elig:
                return admitted
            for n in elig:
                self.parked.remove(n)
                admitted.append(n)

    def _owed(self, cands: Sequence[Tuple[str, str]]) -> List[str]:
        """Runs the fair-share scheduler owes the next slot (minimal
        virtual time among the candidates' runs)."""
        runs = sorted({r for r, _ in cands})
        lo = min(self.vtime[r] for r in runs)
        return [r for r in runs if self.vtime[r] <= lo + 1e-9]

    def enabled(self) -> List[str]:
        """All decisions legal in the current state, in a canonical
        deterministic order."""
        acts: List[str] = []
        for lane in (OFFLOAD, LOCAL):
            if self.fabric.free(lane) <= 0:
                continue
            cands = self._dispatch_candidates(lane)
            if not cands:
                continue
            if self.model.fair:
                owed = set(self._owed(cands))
                cands = [(r, s) for r, s in cands if r in owed]
            acts += [f"dispatch:{r}:{s}" for r, s in cands]
        for task in self.fabric.inflight():
            if (task.wait_key is not None
                    and task.wait_key not in self.memo_done):
                continue   # memo waiter gated on its owner's completion
            acts.append(f"complete:{task.run_id}:{task.step}")
        acts += list(self.pending)
        for task in self.fabric.inflight():
            if self.fabric.crashes_left > 0:
                acts.append(f"crash:{task.run_id}:{task.step}")
            if self.fabric.timeouts_left > 0:
                acts.append(f"timeout:{task.run_id}:{task.step}")
            if self.fabric.preempts_left > 0:
                acts.append(f"preempt:{task.run_id}:{task.step}")
        for name in sorted(self.runs):
            run = self.runs[name]
            if (run.tenant.resubmit and not run.failed and run.passes == 0
                    and len(run.completed) == len(run.steps)
                    and not any(t.run_id == name
                                for t in self.fabric.inflight())):
                acts.append(f"drop:{name}")
        return acts

    # ------------------------------------------------------------- mutation
    def _emit(self, run: "_SimRun", kind: str, step: str, t: float,
              **info):
        run.events.append({"kind": kind, "step": step, "t": t,
                           "info": info})

    def _memo_key(self, run: "_SimRun", step: str) -> Optional[str]:
        s = run.steps[step]
        if not self.model.memoize or s.memoizable is False or not s.outputs:
            return None
        in_digs = [self.store.digests.get(f"{run.name}/{u}", "?")
                   for u in sorted(s.inputs)]
        return _digest("memo", s.name, ",".join(sorted(s.inputs)),
                       ",".join(sorted(s.outputs)), *in_digs)

    def _out_digest(self, run: "_SimRun", step: str, uri: str) -> str:
        s = run.steps[step]
        in_digs = [self.store.digests.get(f"{run.name}/{u}", "?")
                   for u in sorted(s.inputs)]
        prev = ""
        if step in self.model.accum_steps:
            # non-idempotent step: folds its output's current content in
            prev = self.store.digests.get(f"{run.name}/{uri}", "")
        return _digest("out", s.name, uri, prev, *in_digs)

    def apply(self, decision: str):
        self.schedule.append(decision)
        t = self.clock.tick()
        parts = decision.split(":")
        kind = parts[0]
        handler = getattr(self, f"_do_{kind}")
        handler(parts[1:], t)
        if self.model.admit_capacity:
            # admission is deterministic, not a schedulable decision:
            # the runtime's drain loop runs after every driver message,
            # so the model drains eagerly after every decision. Under
            # parked_starved only the submit-time drain ever ran, so
            # capacity freed here is never noticed.
            eligible = tuple(self._admission_eligible())
            if "parked_starved" in self.model.bugs:
                admitted: Tuple[str, ...] = ()
            else:
                admitted = tuple(self._drain_admission())
            self.admission_rounds.append((admitted, eligible))
        self.store.sample_residency(t)

    def _do_dispatch(self, args: List[str], t: float):
        name, step = args
        run = self.runs[name]
        run.ready.remove(step)
        lane = run.lane_of(step)
        task = self.fabric.dispatch(name, step, lane,
                                    retries=run.steps[step].retries)
        # log the fair-share round before charging: owed = runs the
        # scheduler owes THIS slot (min vtime among this lane's
        # candidates, the dispatched step included)
        cands = [(name, step)] + self._dispatch_candidates(lane)
        self.dispatch_rounds.append((name, tuple(self._owed(cands))))
        self.vtime[name] += 1.0 / run.tenant.weight
        self._emit(run, "dispatch", step, t, lane=lane)
        key = self._memo_key(run, step)
        if key is not None:
            if key in self.memo_done:
                task.memo_hit = True
            elif (key in self.memo_inflight
                  and "memo_no_guard" not in self.model.bugs):
                task.wait_key = key
            else:
                self.memo_inflight[key] = (name, step)
        task.memo_keyed = key  # type: ignore[attr-defined]

    def _do_complete(self, args: List[str], t: float):
        name, step = args
        run = self.runs[name]
        task = self.fabric.complete(name, step)
        key = getattr(task, "memo_keyed", None)
        executed = not task.memo_hit and task.wait_key is None
        if executed:
            self.exec_nonce += 1
            if key is not None:
                self.executions.append((key, name, step, t))
                self.memo_done[key] = f"{name}:{step}"
                self.memo_inflight.pop(key, None)
        s = run.steps[step]
        for uri in s.outputs:
            full = f"{run.name}/{uri}"
            dig = self._out_digest(run, step, uri)
            nbytes = max(1, s.bytes_hint // max(1, len(s.outputs))
                         if s.bytes_hint else 1)
            if task.lane == OFFLOAD:
                v = self.store.put(run, full, dig, nbytes, t, "cloud")
                ep = self.store.epochs[run.name]
                d = f"install:{name}:{uri}"
                if d not in self.pending_installs:
                    self.pending.append(d)
                self.pending_installs[d] = (full, v, ep, dig, nbytes)
                self.store.enforce_budget(run.name, "cloud", t)
            else:
                self.store.put(run, full, dig, nbytes, t, LOCAL)
                self.store.enforce_budget(run.name, LOCAL, t)
        run.completed.add(step)
        for succ in run.succs.get(step, ()):
            run.remaining[succ] -= 1
            if run.remaining[succ] == 0 and succ not in run.completed:
                run.ready.append(succ)
        run.ready.sort()
        self._emit(run, "step_done", step, t,
                   offloaded=task.lane == OFFLOAD)
        # checkpoint after every completion, like RunCheckpointer
        digests = dict(run.ckpt[1])
        for uri in s.outputs:
            digests[uri] = self.store.digests[f"{run.name}/{uri}"]
        completed = set(run.completed)
        if "ckpt_lost_step" in self.model.bugs:
            # the freeze race: outputs captured, completion bit lost
            completed.discard(step)
        run.ckpt = (frozenset(completed), digests)
        if "duplicate_done" in self.model.bugs and task.lane == OFFLOAD:
            d = f"ghost:{name}:{step}"
            if d not in self.pending:
                self.pending.append(d)

    def _do_ghost(self, args: List[str], t: float):
        name, step = args
        self.pending.remove(f"ghost:{name}:{step}")
        run = self.runs[name]
        # the double-decrement bug: the outstanding-set guard is gone, so the late
        # duplicate lands as a second step_done
        self._emit(run, "step_done", step, t, offloaded=True)

    def _do_install(self, args: List[str], t: float):
        name, uri = args
        d = f"install:{name}:{uri}"
        self.pending.remove(d)
        full, v, ep, dig, nbytes = self.pending_installs.pop(d)
        stale = (self.store.epochs[name] != ep
                 or self.store.versions.get(full) != v)
        if stale and "stale_install" not in self.model.bugs:
            return   # fenced: the write-back is discarded
        self.store.install(full, LOCAL, v, ep, t, nbytes)
        self.store.enforce_budget(name, LOCAL, t)

    def _do_crash(self, args: List[str], t: float):
        name, step = args
        run = self.runs[name]
        survived = self.fabric.crash(name, step)
        self._emit(run, "retry", step, t,
                   attempt=self.fabric.task(name, step).attempts
                   if survived else run.steps[step].retries + 1)
        if not survived:
            self._fail_run(run)

    def _do_timeout(self, args: List[str], t: float):
        name, step = args
        run = self.runs[name]
        self.fabric.timeout(name, step)
        self._emit(run, "retry", step, t, attempt=0)

    def _do_preempt(self, args: List[str], t: float):
        name, step = args
        run = self.runs[name]
        task = self.fabric.task(name, step)
        before = task.attempts
        ckpt_before = len(run.ckpt[0])
        self.fabric.preempt(name, step)
        if "preempt_lost_step" in self.model.bugs:
            # the checkpoint-abort bug: the requeue path charges the
            # retry budget and the abort tears down the newest
            # checkpointed step along with the in-flight one
            task.attempts += 1
            if run.ckpt[0]:
                completed = set(run.ckpt[0])
                completed.discard(max(completed))
                run.ckpt = (frozenset(completed), dict(run.ckpt[1]))
        self.preempt_log.append((name, step, task.attempts - before,
                                 ckpt_before, len(run.ckpt[0])))
        self._emit(run, "retry", step, t, attempt=0)

    def _do_drop(self, args: List[str], t: float):
        (name,) = args
        run = self.runs[name]
        self.store.drop_namespace(name)
        run.passes += 1
        run.reset_for_resubmit()
        for ten_uri, token in run.tenant.init.items():
            full = f"{name}/{ten_uri}"
            self.store.put(run, full, _digest("init", token), 1, t, LOCAL)

    def _fail_run(self, run: "_SimRun"):
        run.failed = True
        run.ready = []
        for task in self.fabric.drop_run(run.name):
            key = getattr(task, "memo_keyed", None)
            if key is not None and self.memo_inflight.get(key) == task.key:
                self.memo_inflight.pop(key)   # un-poison for waiters
        for k in [p for p in self.pending
                  if p.split(":")[1] == run.name]:
            self.pending.remove(k)
            self.pending_installs.pop(k, None)

    # ------------------------------------------------------------- identity
    def state_key(self) -> tuple:
        runs = tuple(
            (n, frozenset(r.completed), tuple(r.ready), r.failed,
             r.passes)
            for n, r in sorted(self.runs.items()))
        vt = tuple((n, round(v, 6)) for n, v in sorted(self.vtime.items()))
        return (runs, vt, self.fabric.state_key(), self.store.state_key(),
                tuple(self.pending),
                tuple(sorted(self.memo_done)),
                tuple(sorted(self.memo_inflight)),
                tuple(sorted(self.parked)))

    # --------------------------------------------------------------- output
    def run_states(self) -> Dict[str, str]:
        return {n: ("failed" if r.failed else
                    "done" if r.done() else "running")
                for n, r in self.runs.items()}

    def final_digests(self) -> Dict[str, Dict[str, str]]:
        out: Dict[str, Dict[str, str]] = {}
        for name in self.runs:
            prefix = name + "/"
            out[name] = {u[len(prefix):]: d
                         for u, d in sorted(self.store.digests.items())
                         if u.startswith(prefix)}
        return out

    def trace(self) -> dict:
        ten_budgets = {}
        for ten in self.model.tenants:
            for tier, b in ten.budgets.items():
                ten_budgets[f"{ten.name}:{tier}"] = b
        return {
            "events": {n: r.events for n, r in sorted(self.runs.items())},
            "run_states": self.run_states(),
            "installs": list(self.store.installs),
            "evictions": list(self.store.evictions),
            "executions": list(self.executions),
            "dispatch_rounds": list(self.dispatch_rounds),
            "admission_rounds": list(self.admission_rounds),
            "admission_window": self.model.starvation_window,
            "preempt_log": list(self.preempt_log),
            "fair": self.model.fair,
            "starvation_window": self.model.starvation_window,
            "budgets": ten_budgets,
            "residency": list(self.store.residency),
        }


# ========================================================== trace checking

def check_trace(trace: dict) -> List[Finding]:
    """Replay one explored trace through the sanitizer plus the
    cross-schedule invariants H120–H123. Accepts the dict produced by
    :meth:`Simulation.trace`; missing sections are skipped, so defect-
    corpus artifacts can carry only the section a rule needs."""
    out: List[Finding] = []
    states = trace.get("run_states", {})
    for name, events in trace.get("events", {}).items():
        out += sanitizer.check(
            events, completed_run=states.get(name, "done") == "done")
    if "installs" in trace or "evictions" in trace:
        out += sanitizer.check_store(trace.get("installs", ()),
                                     trace.get("evictions", ()))
        out += check_epochs(trace.get("installs", ()))
    if "executions" in trace:
        out += check_memo(trace["executions"])
    if "dispatch_rounds" in trace:
        out += check_starvation(trace["dispatch_rounds"],
                                trace.get("starvation_window", 8))
    if "admission_rounds" in trace:
        out += check_admission(trace["admission_rounds"],
                               trace.get("admission_window", 8))
    if "preempt_log" in trace:
        out += check_preemption(trace["preempt_log"])
    if "residency" in trace:
        out += check_residency(trace.get("budgets", {}),
                               trace["residency"])
    if "base_digests" in trace:
        out += check_resume_digests(trace["base_digests"],
                                    trace.get("resumed", ()))
    return out


def check_epochs(installs: Iterable[tuple]) -> List[Finding]:
    """H120: within one namespace, installs must never carry an epoch
    older than one already observed — a stale pre-drop transfer landing
    in the reused namespace."""
    out: List[Finding] = []
    seen: Dict[str, Tuple[int, str]] = {}   # ns -> (max epoch, uri)
    for uri, tier, version, epoch, t in sorted(installs,
                                               key=lambda r: r[4]):
        ns = uri.split("/", 1)[0]
        hi = seen.get(ns)
        if hi is not None and epoch < hi[0]:
            out.append(finding(
                "H120",
                f"install of {uri} v{version} on {tier} at t={t:g} "
                f"carries epoch {epoch} after namespace {ns!r} reached "
                f"epoch {hi[0]} (via {hi[1]})",
                uri=uri))
        if hi is None or epoch > hi[0]:
            seen[ns] = (epoch, uri)
    return out


def check_memo(executions: Iterable[tuple]) -> List[Finding]:
    """H121: one memo key must execute at most once."""
    out: List[Finding] = []
    first: Dict[str, tuple] = {}
    for key, run, step, t in executions:
        if key in first:
            r0, s0, t0 = first[key]
            out.append(finding(
                "H121",
                f"memo key {key} executed twice: {r0}:{s0} at t={t0:g} "
                f"and {run}:{step} at t={t:g} — the second should have "
                f"joined the in-flight entry as a waiter",
                steps=(s0, step)))
        else:
            first[key] = (run, step, t)
    return out


def check_starvation(dispatch_rounds: Iterable[tuple],
                     window: int) -> List[Finding]:
    """H122: under fair share, a run the scheduler owes the next slot
    (minimal virtual time, ready work) must be dispatched within the
    starvation window of consecutive dispatch rounds."""
    out: List[Finding] = []
    owed_streak: Dict[str, int] = {}
    flagged: Set[str] = set()
    for chosen, owed in dispatch_rounds:
        for run in owed:
            if run == chosen:
                owed_streak[run] = 0
            else:
                owed_streak[run] = owed_streak.get(run, 0) + 1
                if owed_streak[run] >= window and run not in flagged:
                    flagged.add(run)
                    out.append(finding(
                        "H122",
                        f"run {run!r} held the smallest virtual time "
                        f"with ready steps for {owed_streak[run]} "
                        f"consecutive dispatches without being chosen "
                        f"(window={window})"))
        for run in list(owed_streak):
            if run not in owed:
                owed_streak[run] = 0
    return out


def check_admission(admission_rounds: Iterable[tuple],
                    window: int) -> List[Finding]:
    """H125: a parked run the front door owes admission (capacity free,
    within the head of the deadline order) must be admitted within the
    admission window of consecutive drain rounds — a longer streak
    means a capacity-freed wakeup was lost."""
    out: List[Finding] = []
    streak: Dict[str, int] = {}
    flagged: Set[str] = set()
    for admitted, eligible in admission_rounds:
        for run in eligible:
            if run in admitted:
                streak[run] = 0
            else:
                streak[run] = streak.get(run, 0) + 1
                if streak[run] >= window and run not in flagged:
                    flagged.add(run)
                    out.append(finding(
                        "H125",
                        f"parked run {run!r} stayed admissible (free "
                        f"slot, head of the deadline order) for "
                        f"{streak[run]} consecutive drain rounds "
                        f"without being admitted (window={window})"))
        for run in list(streak):
            if run not in eligible:
                streak[run] = 0
    return out


def check_preemption(preempt_log: Iterable[tuple]) -> List[Finding]:
    """H126: preemption must be attempt-free and checkpoint-preserving —
    a preempted batch step may lose only its in-flight work, never
    retry budget or already-checkpointed completions."""
    out: List[Finding] = []
    for run, step, d_attempts, ckpt_before, ckpt_after in preempt_log:
        lost = []
        if d_attempts > 0:
            lost.append(f"burned {d_attempts} retry attempt(s)")
        if ckpt_after < ckpt_before:
            lost.append(f"dropped {ckpt_before - ckpt_after} "
                        "checkpointed completion(s)")
        if lost:
            out.append(finding(
                "H126",
                f"preemption of {run}:{step} {' and '.join(lost)} — "
                "SLO pressure is eating the batch tenant's progress",
                steps=(step,)))
    return out


def check_residency(budgets: Dict[str, int],
                    residency: Iterable[tuple]) -> List[Finding]:
    """H123: a namespace's resident bytes must never exceed its
    configured per-tier budget after any scheduler decision."""
    out: List[Finding] = []
    flagged: Set[str] = set()
    for t, ns, tier, nbytes in residency:
        key = f"{ns}:{tier}"
        budget = budgets.get(key)
        if budget is not None and nbytes > budget and key not in flagged:
            flagged.add(key)
            out.append(finding(
                "H123",
                f"namespace {ns!r} holds {nbytes} bytes on {tier} at "
                f"t={t:g}, over its budget of {budget} — eviction did "
                f"not fire on the crossing install"))
    return out


def check_resume(model: SimModel, schedule: Schedule) -> List[Finding]:
    """H124: resume from every checkpointed prefix of ``schedule`` must
    converge to the same final content digests as the uninterrupted
    run."""
    base = replay(model, schedule)
    run_benign(base)
    base_digs = base.final_digests()
    out: List[Finding] = []
    for cut in range(1, len(schedule)):
        pre = replay(model, schedule[:cut])
        preload = {n: r.ckpt for n, r in pre.runs.items()}
        resumed = Simulation(model, preload=preload)
        run_benign(resumed)
        digs = resumed.final_digests()
        for name, base_map in base_digs.items():
            for uri, dig in base_map.items():
                got = digs.get(name, {}).get(uri)
                if got is not None and got != dig:
                    out.append(finding(
                        "H124",
                        f"resume from prefix {cut} diverged on "
                        f"{name}/{uri}: {got} != {dig} from the "
                        f"uninterrupted run",
                        uri=f"{name}/{uri}"))
                    return out
    return out


def check_resume_digests(base_digests: Dict[str, Dict[str, str]],
                         resumed: Iterable[dict]) -> List[Finding]:
    """Corpus-artifact form of the H124 check: compare recorded resume
    outcomes (``{"prefix": int, "digests": {run: {uri: digest}}}``)
    against the uninterrupted run's digests."""
    out: List[Finding] = []
    for entry in resumed:
        cut = entry.get("prefix", -1)
        digs = entry.get("digests", {})
        for name, base_map in base_digests.items():
            for uri, dig in base_map.items():
                got = digs.get(name, {}).get(uri)
                if got is not None and got != dig:
                    out.append(finding(
                        "H124",
                        f"resume from prefix {cut} diverged on "
                        f"{name}/{uri}: {got} != {dig} from the "
                        f"uninterrupted run",
                        uri=f"{name}/{uri}"))
                    return out
    return out


# ============================================================= exploration

#: decision kinds a benign (default) scheduler takes; fault injection,
#: ghost completions and deferred installs stay schedule-only so a
#: hazard is attributable to the explicit decisions that caused it.
_BENIGN = ("dispatch", "complete", "drop")


def _benign(acts: Sequence[str]) -> List[str]:
    return [a for a in acts if a.split(":", 1)[0] in _BENIGN]


def run_benign(sim: Simulation, max_steps: int = 10000):
    """Finish a simulation with the deterministic default policy (first
    enabled benign decision)."""
    for _ in range(max_steps):
        acts = _benign(sim.enabled())
        if not acts:
            return
        sim.apply(acts[0])
    raise RuntimeError("benign policy did not terminate")


def replay(model: SimModel, schedule: Sequence[str],
           strict: bool = True) -> Simulation:
    """Rebuild the simulation state a schedule prefix leads to. With
    ``strict=False`` (advisory replay, used by the minimizer) decisions
    that are no longer enabled are skipped instead of raising."""
    sim = Simulation(model)
    for d in schedule:
        if d in sim.enabled():
            sim.apply(d)
        elif strict:
            raise ValueError(f"decision {d!r} not enabled at "
                             f"step {len(sim.schedule)}")
    return sim


@dataclass
class ExploreResult:
    schedules: int = 0                 # complete interleavings checked
    decisions: int = 0                 # total decisions executed
    deduped: int = 0                   # prefixes cut by visited-state dedup
    por_pruned: int = 0                # branches collapsed by POR
    truncated: bool = False            # stopped before exhausting the space
    hazard_count: int = 0              # traces with >=1 finding (uncapped)
    coverage: Set[tuple] = field(default_factory=set)  # distinct terminals
    #: first ``keep_hazards`` offending (schedule, findings) pairs
    hazards: List[Tuple[Schedule, List[Finding]]] = field(
        default_factory=list)

    @property
    def exhaustive(self) -> bool:
        return not self.truncated

    def hazard_rules(self) -> List[str]:
        return sorted({f.rule for _, fs in self.hazards for f in fs})


def _commuting_completions(sim: Simulation, acts: Sequence[str]) -> bool:
    """True when every enabled decision is a completion and all pairs
    commute: disjoint output URI sets within each namespace, no shared
    memo key, no memo owner with live waiters, no budget in play for
    the touched namespaces. Then every order reaches the same state and
    the same checker verdicts, so one canonical order suffices."""
    if len(acts) < 2 or any(not a.startswith("complete:") for a in acts):
        return False
    seen_uris: Set[str] = set()
    seen_keys: Set[str] = set()
    for a in acts:
        _, name, step = a.split(":")
        run = sim.runs[name]
        if run.tenant.budgets:
            return False
        task = sim.fabric.task(name, step)
        key = getattr(task, "memo_keyed", None)
        if key is not None:
            if key in seen_keys or key in sim.memo_inflight:
                return False
            seen_keys.add(key)
        for uri in run.steps[step].outputs:
            full = f"{name}/{uri}"
            if full in seen_uris:
                return False
            seen_uris.add(full)
    return True


def explore(model: SimModel, *, max_schedules: int = 20000,
            max_depth: int = 200, por: bool = True, dedup: bool = True,
            resume_check: bool = False, max_hazards: Optional[int] = None,
            keep_hazards: int = 50, metrics=None) -> ExploreResult:
    """Exhaustive DFS over the schedule space of ``model``.

    Visited-state dedup cuts prefixes that reach an already-explored
    state; partial-order reduction collapses commuting-completion
    branch points to one canonical order. Every terminal (and every
    dedup-cut prefix) trace runs through :func:`check_trace`; with
    ``resume_check`` each terminal schedule additionally runs the H124
    prefix-resume convergence check. ``max_hazards`` stops exploration
    early once that many offending traces have been seen (the usual
    bug-hunt mode wants the first one, then minimizes it).
    """
    res = ExploreResult()
    seen: Set[tuple] = set()

    def record(sim: Simulation, terminal: bool) -> bool:
        findings = check_trace(sim.trace())
        if terminal and resume_check:
            findings += check_resume(model, sim.schedule)
        if terminal:
            res.schedules += 1
            res.coverage.add(sim.state_key())
        if findings:
            res.hazard_count += 1
            if len(res.hazards) < keep_hazards:
                res.hazards.append((list(sim.schedule), findings))
            if metrics is not None:
                metrics.inc("emcheck.hazards_found", len(findings))
        return bool(findings)

    def dfs(prefix: Schedule) -> bool:
        """Returns False when a stop condition fired."""
        if res.schedules >= max_schedules or len(prefix) > max_depth:
            res.truncated = True
            return False
        sim = replay(model, prefix)
        res.decisions += len(prefix)
        if dedup:
            key = sim.state_key()
            if key in seen:
                # continuations were explored from the first visit, but
                # this prefix's *history* (event/install logs) is unique
                # to this path — check it before cutting
                res.deduped += 1
                record(sim, terminal=False)
                if (max_hazards is not None
                        and res.hazard_count >= max_hazards):
                    res.truncated = True
                    return False
                return True
            seen.add(key)
        acts = sim.enabled()
        if not acts:
            record(sim, terminal=True)
            if max_hazards is not None and res.hazard_count >= max_hazards:
                res.truncated = True
                return False
            return True
        if por and _commuting_completions(sim, acts):
            res.por_pruned += len(acts) - 1
            acts = acts[:1]
        for a in acts:
            if not dfs(prefix + [a]):
                return False
        return True

    dfs([])
    if metrics is not None:
        metrics.inc("emcheck.schedules_explored", res.schedules)
        metrics.inc("emcheck.states_deduped", res.deduped)
        metrics.inc("emcheck.por_pruned", res.por_pruned)
    return res


def sample(model: SimModel, *, schedules: int = 200, seed: int = 0,
           fault_rate: float = 0.25, max_depth: int = 2000,
           resume_check: bool = False, metrics=None) -> ExploreResult:
    """Seeded random schedule sampling for DAGs too large to exhaust.

    Each episode walks a fresh simulation to termination choosing
    uniformly among enabled decisions, except fault/ghost/install
    decisions which fire with probability ``fault_rate`` (so benign
    progress dominates but injections stay reachable). Identical
    (model, schedules, seed, fault_rate) arguments reproduce identical
    episodes.
    """
    rng = random.Random(seed)
    res = ExploreResult()
    res.truncated = True   # sampling never proves exhaustiveness
    for _ in range(schedules):
        sim = Simulation(model)
        for _ in range(max_depth):
            acts = sim.enabled()
            if not acts:
                break
            benign = _benign(acts)
            optional = [a for a in acts if a not in benign]
            if optional and (not benign or rng.random() < fault_rate):
                sim.apply(rng.choice(optional))
            else:
                sim.apply(rng.choice(benign))
        res.schedules += 1
        res.decisions += len(sim.schedule)
        res.coverage.add(sim.state_key())
        findings = check_trace(sim.trace())
        if resume_check and not findings:
            findings = check_resume(model, sim.schedule)
        if findings:
            res.hazards.append((list(sim.schedule), findings))
    if metrics is not None:
        metrics.inc("emcheck.schedules_explored", res.schedules)
        if res.hazards:
            metrics.inc("emcheck.hazards_found",
                        sum(len(fs) for _, fs in res.hazards))
    return res


# ============================================================ minimization

def _triggers(model: SimModel, schedule: Sequence[str],
              rules: Set[str], resume_check: bool) -> bool:
    sim = replay(model, schedule, strict=False)
    run_benign(sim)
    findings = check_trace(sim.trace())
    if resume_check:
        findings += check_resume(model, list(schedule))
    return bool({f.rule for f in findings} & rules)


def minimize(model: SimModel, schedule: Schedule,
             rules: Optional[Iterable[str]] = None,
             resume_check: bool = False) -> Schedule:
    """Delta-debug a hazard-triggering schedule to a 1-minimal decision
    list: no single decision (and no contiguous chunk, tried first at
    decreasing granularity) can be removed without losing the hazard.

    Replay during minimization is *advisory* — decisions no longer
    enabled after a removal are skipped, and the simulation is finished
    with the benign default policy — so candidate lists never have to
    be exactly feasible.
    """
    if rules is None:
        sim = replay(model, schedule, strict=False)
        run_benign(sim)
        found = check_trace(sim.trace())
        if resume_check:
            found += check_resume(model, list(schedule))
        rules = {f.rule for f in found}
    rules = set(rules)
    assert rules, "schedule does not trigger any hazard"
    cur = list(schedule)
    chunk = max(1, len(cur) // 2)
    while chunk >= 1:
        i = 0
        progressed = False
        while i < len(cur):
            cand = cur[:i] + cur[i + chunk:]
            if _triggers(model, cand, rules, resume_check):
                cur = cand
                progressed = True
            else:
                i += chunk
        if chunk == 1 and not progressed:
            break
        chunk = chunk // 2 if chunk > 1 else (1 if progressed else 0)
    # canonicalize: re-run advisory replay and keep only the decisions
    # that were actually applied, so the reproducer replays strictly
    sim = replay(model, cur, strict=False)
    applied = list(sim.schedule)
    if _triggers(model, applied, rules, resume_check):
        return applied
    return cur


# ========================================================== reproducer IO

def save_reproducer(path: str, model: SimModel, schedule: Schedule,
                    findings: Sequence[Finding], *,
                    minimized: bool = True, seed: Optional[int] = None):
    """Serialize a hazard reproducer. ``sort_keys`` + fixed separators
    keep the bytes identical across runs, so replay can be gated
    byte-for-byte in CI."""
    doc = {
        "emcheck_version": EMCHECK_VERSION,
        "model": {"name": model.name, "params": model.params,
                  "bugs": sorted(model.bugs)},
        "schedule": list(schedule),
        "hazards": sorted({f.rule for f in findings}),
        "minimized": bool(minimized),
    }
    if seed is not None:
        doc["seed"] = seed
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


def load_reproducer(path: str) -> dict:
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("emcheck_version") != EMCHECK_VERSION:
        raise ValueError(f"unsupported reproducer version "
                         f"{doc.get('emcheck_version')!r}")
    return doc


def replay_reproducer(doc: dict,
                      model: Optional[SimModel] = None
                      ) -> Tuple[List[Finding], bool]:
    """Strictly replay a reproducer document. Returns the findings and
    whether the recorded hazard rules were re-triggered."""
    if model is None:
        ref = doc["model"]
        model = build_model(ref["name"], bugs=ref.get("bugs", ()),
                            **ref.get("params", {}))
    sim = replay(model, doc["schedule"], strict=True)
    run_benign(sim)
    findings = check_trace(sim.trace())
    want = set(doc.get("hazards", ()))
    got = {f.rule for f in findings}
    return findings, want <= got and bool(want)


# ============================================================ model library

def _wf_diamond() -> Workflow:
    wf = Workflow("diamond")
    wf.step("src", outputs=["x"], remotable=False)
    for i in range(1, 5):
        wf.step(f"mid{i}", inputs=["x"], outputs=[f"y{i}"], remotable=True)
    wf.step("sink", inputs=[f"y{i}" for i in range(1, 5)],
            outputs=["z"], remotable=False)
    return wf


def _wf_chain(n: int = 3, prefix: str = "s") -> Workflow:
    wf = Workflow(f"chain{n}")
    prev = None
    for i in range(n):
        wf.step(f"{prefix}{i}",
                inputs=[prev] if prev else [],
                outputs=[f"v{i}"], remotable=True)
        prev = f"v{i}"
    return wf


def _wf_wide(n: int = 8) -> Workflow:
    wf = Workflow(f"wide{n}")
    wf.step("fan", outputs=["seed"], remotable=True)
    for i in range(n):
        wf.step(f"w{i}", inputs=["seed"], outputs=[f"o{i}"],
                remotable=True)
    return wf


def model_diamond(*, bugs: Iterable[str] = ()) -> SimModel:
    """The canonical 6-step diamond: src -> mid1..mid4 -> sink, four
    remotable middles contending for two offload slots. Small enough
    to exhaust, rich enough to interleave dispatches and completions."""
    return SimModel([Tenant("A", _wf_diamond())], offload_slots=2,
                    local_slots=1, bugs=set(bugs), name="diamond",
                    params={})


def model_two_tenant(*, weight_a: float = 1.0, weight_b: float = 1.0,
                     width: int = 4,
                     bugs: Iterable[str] = ()) -> SimModel:
    """Two tenants sharing the offload lane — the fair-share /
    starvation scenario (H122 under the ``unfair`` flag)."""
    wa = _wf_wide(width)
    wb = _wf_wide(width)
    return SimModel([Tenant("A", wa, weight=weight_a),
                     Tenant("B", wb, weight=weight_b)],
                    offload_slots=1, local_slots=1,
                    starvation_window=4, bugs=set(bugs),
                    name="two_tenant",
                    params={"weight_a": weight_a, "weight_b": weight_b,
                            "width": width})


def model_memo_pair(*, bugs: Iterable[str] = ()) -> SimModel:
    """Two tenants running identical chains on identical inputs with
    memoization on — exactly one execution per key is legal (H121
    under ``memo_no_guard``)."""
    return SimModel(
        [Tenant("A", _wf_chain(2), init={"seed": "same"}),
         Tenant("B", _wf_chain(2), init={"seed": "same"})],
        offload_slots=2, local_slots=1, memoize=True,
        bugs=set(bugs), name="memo_pair", params={})


def model_budget(*, budget: int = 2,
                 bugs: Iterable[str] = ()) -> SimModel:
    """One tenant whose wide outputs exceed a cloud residency budget —
    eviction must keep residency under the ceiling (H123 under
    ``no_evict``)."""
    return SimModel(
        [Tenant("A", _wf_wide(4), budgets={"cloud": budget})],
        offload_slots=2, local_slots=1, bugs=set(bugs),
        name="budget", params={"budget": budget})


def model_resubmit(*, bugs: Iterable[str] = ()) -> SimModel:
    """A warm-resubmit tenant: the run completes, its namespace drops
    (epoch bump), and it runs again while deferred write-backs from the
    first pass may still be pending (H110/H120 under
    ``stale_install``)."""
    return SimModel([Tenant("A", _wf_chain(2), resubmit=True)],
                    offload_slots=1, local_slots=1, bugs=set(bugs),
                    name="resubmit", params={})


def model_ckpt_chain(*, bugs: Iterable[str] = ()) -> SimModel:
    """A chain with a non-idempotent (accumulating) middle step — the
    checkpoint/resume convergence scenario (H124 under
    ``ckpt_lost_step``)."""
    wf = Workflow("ckpt")
    wf.step("a", outputs=["x"], remotable=True)
    wf.step("acc", inputs=["x"], outputs=["x"], remotable=True)
    wf.step("b", inputs=["x"], outputs=["y"], remotable=True)
    return SimModel([Tenant("A", wf)], offload_slots=1, local_slots=1,
                    accum_steps={"acc"}, bugs=set(bugs),
                    name="ckpt_chain", params={})


def model_frontdoor(*, window: int = 4,
                    bugs: Iterable[str] = ()) -> SimModel:
    """The serving front door: two parked interactive tenants draining
    oldest-deadline-first through one admitted-run slot while a batch
    tenant's chain holds the lanes, with one spot preemption available
    (H125 under ``parked_starved``, H126 under ``preempt_lost_step``)."""
    return SimModel(
        [Tenant("A", _wf_chain(1, prefix="a"), park=True, deadline=1.0),
         Tenant("B", _wf_chain(1, prefix="b"), park=True, deadline=2.0),
         Tenant("C", _wf_chain(3, prefix="bat"))],
        offload_slots=2, local_slots=1, admit_capacity=1,
        max_preempts=1, starvation_window=window, bugs=set(bugs),
        name="frontdoor", params={"window": window})


#: name -> builder; every builder accepts ``bugs=`` plus its own params,
#: and stamps ``name``/``params`` so reproducers can rebuild it.
MODELS: Dict[str, Callable[..., SimModel]] = {
    "diamond": model_diamond,
    "two_tenant": model_two_tenant,
    "memo_pair": model_memo_pair,
    "budget": model_budget,
    "resubmit": model_resubmit,
    "ckpt_chain": model_ckpt_chain,
    "frontdoor": model_frontdoor,
}


def build_model(name: str, *, bugs: Iterable[str] = (),
                **params) -> SimModel:
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r} "
                       f"(have: {', '.join(sorted(MODELS))})")
    return MODELS[name](bugs=bugs, **params)
