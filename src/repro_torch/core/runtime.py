"""EmeraldRuntime — one long-lived scheduler serving many workflows.

The paper's Emerald offloads the steps of *one* workflow at a time; a
service absorbing heavy traffic must amortise the expensive parts — the
worker pool, warm compile caches, cloud-resident data — across
submissions instead of rebuilding them per run. The runtime is that
amortisation layer:

  * **one driver event loop** reacts to submissions and step completions
    for N concurrent workflows (a multi-run dispatcher keyed by run id),
  * **one offload/local lane pair** (thread pools sized once) is shared:
    idle lanes of one run absorb ready work from another, which is where
    the aggregate-throughput win over back-to-back ``run()`` calls comes
    from (inter-workflow parallelism),
  * **one MigrationManager** carries the compile cache and cost-model
    statistics across runs — the second submission of the same step is
    code-only and pre-measured,
  * **one MDSS** holds every run's data under a per-run namespace
    (``run_id/uri``), with shared-read of a common namespace for warm
    cross-run data (``publish``); ``RunHandle.release()`` drops a run's
    namespace at teardown,
  * **cross-run fair share** composes with the per-run critical-path
    priority: each free lane slot goes to the run with the smallest
    deficit-weighted share (``FairShare``), then that run's highest-cpl
    ready step dispatches — one wide workflow cannot starve the rest,
    and ``weight``/``priority`` let an interactive run overtake batch.

API::

    rt = EmeraldRuntime(manager)              # or EmeraldRuntime() to own one
    h1 = rt.submit(wf_a, {"x": xa})           # non-blocking
    h2 = rt.submit(wf_b, {"x": xb}, weight=2.0, priority=1)
    out = h1.result(); h2.cancel(); rt.close()

``EmeraldExecutor`` (core/executor.py) is now a thin compat shim over a
private runtime, so the single-workflow API and its semantics (events,
checkpoints, retries, speculation) are unchanged.

Per-run recovery semantics are inherited wholesale from the event-driven
executor: retry with tier fallback, straggler speculation with
version-fenced losers, incremental per-completion checkpoints, and
failure draining in-flight siblings before the run's handle fails —
without disturbing the other runs.

Placement is **locality-aware** when the run's policy exposes
``place()`` (``policy="locality"``): each ready step is scored per tier
as ``est_exec + est_transfer(bytes not already resident)``, the cheaper
tier picks the lane, and the full rationale (scores, stale bytes,
reason) is emitted as a ``place`` event at dispatch. Fair-share charging
uses the same score, so a run burning transfer budget pays for it.

Checkpoint *writes* run on a dedicated writer lane (one thread), never
on the driver: the driver freezes a consistent (completed, vars)
snapshot, queues the pickle, and coalesces further dirt until the write
lands. A per-run completion fence keeps ``result()`` from resolving
before the run's final checkpoint is durable, and a failed write still
fails that run (durability contract) without stalling other tenants.

Admission control: when the shared store carries a ``capacity_bytes``
ceiling, ``submit`` refuses new runs (:class:`AdmissionRefused`) once
residency crosses ``admission_headroom`` x capacity — backpressure at
the front door instead of an OOM mid-run. Per-run residency budgets
(``submit(residency_budget={...})``) bound a tenant's footprint per tier
with MDSS-side LRU eviction.
"""
from __future__ import annotations

import heapq
import itertools
import os
import pickle
import queue
import threading
import time
import warnings
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch._tree import host_copy
from repro_torch.core.cost_model import CostModel
from repro_torch.core.mdss import MDSS
from repro_torch.core.migration import MigrationManager, StepFailure
from repro_torch.core.partitioner import PartitionedWorkflow, partition
from repro_torch.core.scheduler import (POLICIES, FairShare, critical_path_lengths,
                                  make_policy)
from repro_torch.core.tiers import default_tiers
from repro_torch.core.workflow import Step, Workflow
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import Tracer, wall_now, wall_of


@dataclass
class Event:
    kind: str          # dispatch | suspend | offload | resume | local |
                       # retry | speculate | prefetch | checkpoint |
                       # place | step_done | scatter | shard_done |
                       # gather — schema in repro_torch.obs.events
    step: str
    tier: str = ""
    t: float = 0.0      # perf_counter: monotonic, for intra-process deltas
    info: dict = field(default_factory=dict)
    t_wall: float = 0.0  # wall-clock epoch seconds: cross-process timeline


class WorkflowFailure(RuntimeError):
    pass


class AdmissionRefused(RuntimeError):
    """submit() refused: the shared store is at/near its capacity
    ceiling. Release namespaces, raise ``MDSS.capacity_bytes``, or
    retry after eviction frees residency."""


class RunCancelled(RuntimeError):
    """The run was cancelled before completing."""


class RuntimeClosed(RuntimeError):
    """The runtime shut down before the run completed."""


# --------------------------------------------------------------------------
# checkpointing
# --------------------------------------------------------------------------
class RunCheckpointer:
    """Per-run incremental checkpoint state (cache + pickle snapshots).

    ``EmeraldExecutor`` inherits these methods unchanged; the runtime
    creates one per submission when it owns checkpointing. The cache is
    fed ONLY from init/resume vars and the outputs of harvested
    completions — a checkpoint can never capture the published outputs of
    a step that is still in flight (which resume would then double-apply
    on a non-idempotent step).
    """

    def __init__(self, mdss, wf: Workflow, checkpoint_dir: Optional[str],
                 ckpt_name: Optional[str] = None):
        self.mdss = mdss
        self.wf = wf
        self.checkpoint_dir = checkpoint_dir
        self.ckpt_name = ckpt_name or wf.name
        # uri -> (version, host snapshot)
        self._ckpt_cache: Dict[str, tuple] = {}
        # (completed, vars) frozen by the driver for the async writer —
        # see _freeze
        self._pending: Optional[tuple] = None

    def _emit(self, kind, step, tier="", **info):   # rebound by the runtime
        pass

    def _ckpt_path(self):
        return os.path.join(self.checkpoint_dir, f"{self.ckpt_name}.wfckpt")

    def _cache_var(self, uri: str):
        """Snapshot ``uri``'s freshest value into the checkpoint cache
        (skip if the cached version is already current). Uses a reference
        read (``peek_latest``) — no cross-tier transfer lands on the
        driver thread for checkpointing."""
        val, ver = self.mdss.peek_latest(uri)
        if ver and self._ckpt_cache.get(uri, (0, None))[0] != ver:
            # host tensors, not numpy: numpy has no bfloat16, and a
            # resumed run feeds these values back to torch steps
            self._ckpt_cache[uri] = (ver, host_copy(val))

    def _cache_outputs(self, harvested: Step):
        """Snapshot a harvested step's outputs into the checkpoint cache.

        Must run BEFORE the step's successors dispatch: the outputs are
        final right now (WAW/WAR edges keep any later writer blocked until
        this harvest), so the reference read snapshots exactly what was
        published — no transfer involved. The pickle write itself
        (``_save_checkpoint``) has no ordering constraint and runs after
        dispatch, off the critical path.
        """
        if self.checkpoint_dir:
            for uri in harvested.outputs:
                self._cache_var(uri)

    def _freeze(self, completed):
        """Driver-side: freeze the (completed, vars) pair the NEXT
        ``_save_checkpoint`` will write. The write itself runs on the
        runtime's checkpoint lane, concurrent with the driver caching
        later completions into ``_ckpt_cache`` — without this snapshot
        the pickle could capture an output whose step is absent from
        ``completed``, and resume would double-apply it."""
        self._pending = (sorted(completed),
                         {uri: val
                          for uri, (_, val) in self._ckpt_cache.items()})

    def _save_checkpoint(self, completed):
        if not self.checkpoint_dir:
            return
        pend, self._pending = self._pending, None
        if pend is None:     # direct (synchronous) caller: live cache
            pend = (sorted(completed),
                    {uri: val for uri, (_, val) in self._ckpt_cache.items()})
        names, snapshot = pend
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        tmp = self._ckpt_path() + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"completed": list(names), "vars": snapshot}, f)
        os.replace(tmp, self._ckpt_path())
        self._emit("checkpoint", "<workflow>", n=len(names))

    def _load_checkpoint(self):
        if not self.checkpoint_dir or not os.path.exists(self._ckpt_path()):
            return None
        with open(self._ckpt_path(), "rb") as f:
            return pickle.load(f)


# --------------------------------------------------------------------------
# run handle
# --------------------------------------------------------------------------
class RunHandle:
    """Client-side view of one submitted workflow run."""

    def __init__(self, run_id: str, namespace: str, runtime: "EmeraldRuntime",
                 events: List[Event]):
        self.run_id = run_id
        self.namespace = namespace
        self.events = events
        self.findings = []          # verifier findings (submit(validate=...))
        self._runtime = runtime
        self._done = threading.Event()
        self._result: Optional[dict] = None
        self._error: Optional[BaseException] = None
        # True while the submission sits in the front door's admission
        # queue (submit(park=True) under capacity pressure); cleared by
        # the drain loop when the run is admitted
        self._parked = False
        # set (at most once, BEFORE the run is enqueued) by the runtime:
        # fires on any terminal state — result, failure, cancel
        self._on_done = None
        # a private runtime to close synchronously inside result() (the
        # compat shim's pools-shut-before-run-returns contract); wait()/
        # state users fall back to the _on_done reaper
        self._close_on_result: Optional["EmeraldRuntime"] = None

    # ------------------------------------------------------------ lifecycle
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> dict:
        """Block for the run's re-integrated variables (or its failure)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"run {self.run_id} still executing")
        if self._close_on_result is not None:
            self._close_on_result.close()       # idempotent
        if self._error is not None:
            raise self._error
        return self._result

    def cancel(self):
        """Request cancellation: queued steps are abandoned, in-flight
        steps drain, then ``result`` raises :class:`RunCancelled`."""
        self._runtime._inbox.put(("cancel", self.run_id))

    def release(self):
        """Drop this run's MDSS namespace (teardown of its data).

        Returns ``(entries_dropped, resident_bytes_freed)``; a no-op for
        un-namespaced (compat shim) runs."""
        if not self.namespace:
            return (0, 0)
        out = self._runtime.mdss.drop_namespace(self.namespace)
        # freed residency may admit a parked run right now
        self._runtime._nudge()
        return out

    @property
    def state(self) -> str:
        if not self._done.is_set():
            return "parked" if self._parked else "running"
        if isinstance(self._error, RunCancelled):
            return "cancelled"
        return "failed" if self._error is not None else "done"

    def _finish(self, result=None, error=None):
        self._result = result
        self._error = error
        self._done.set()
        if self._on_done is not None:
            try:
                self._on_done(self)
            except Exception:
                pass   # a teardown hook must never poison the finalizer


# --------------------------------------------------------------------------
# internal per-run state
# --------------------------------------------------------------------------
@dataclass
class _Run:
    run_id: str
    ns: str
    handle: RunHandle
    wf: Workflow
    steps: Dict[str, Step]
    succs: Dict[str, set]
    indeg: Dict[str, int]
    order_idx: Dict[str, int]
    completed: set
    mdss: Any                       # NamespacedMDSS or base MDSS
    policy: Any
    fetch: Any
    checkpointer: Optional[RunCheckpointer]
    weight: float
    priority: int
    speculate_after: Optional[float]
    prefetch: bool
    events: List[Event]
    lock: threading.Lock = field(default_factory=threading.Lock)
    ready: Dict[bool, list] = field(
        default_factory=lambda: {True: [], False: []})   # keyed by offloaded?
    inflight: int = 0
    failures: List[BaseException] = field(default_factory=list)
    cancelled: bool = False
    ckpt_dirty: bool = False
    ckpt_inflight: int = 0          # writes queued on the checkpoint lane
    placements: Dict[str, Any] = field(default_factory=dict)
    placed: Dict[str, str] = field(default_factory=dict)  # step -> tier
    retries: int = 0
    # wall/monotonic epoch pair fixed at submission: every event's
    # t_wall = epoch_wall + (t - epoch_perf), so driver events land on
    # the same epoch timeline as worker-reported phases (satellite: the
    # old perf_counter-only Event was incomparable across processes)
    epoch_wall: float = field(default_factory=time.time)
    epoch_perf: float = field(default_factory=time.perf_counter)
    root_ctx: Any = None            # (trace_id, span_id) of the run span
    # per fan-out parent: the "fanout" span identity allocated when the
    # scatter step dispatches, so every shard/gather dispatch span nests
    # under one umbrella in the trace; recorded (and popped) when the
    # gather completes. fanout_t0 holds the matching wall start.
    fanout_ctx: Dict[str, Any] = field(default_factory=dict)
    fanout_t0: Dict[str, float] = field(default_factory=dict)
    # serving-front-door state: an absolute perf_counter deadline plus a
    # per-run SLO (ms). When the deadline's slack shrinks below the SLO
    # while ready work is still waiting for a lane, the driver preempts
    # the longest-running preemptible batch task (once per run).
    slo_ms: Optional[float] = None
    deadline_perf: Optional[float] = None
    preempt_fired: bool = False
    # seconds this run waited parked; credited as a fair-share deficit at
    # admission so near-SLO latecomers overtake long-resident tenants
    admit_credit: float = 0.0

    def emit(self, kind, step, tier="", **info):
        t = time.perf_counter()
        with self.lock:
            self.events.append(Event(kind, step, tier, t, info,
                                     self.epoch_wall + (t - self.epoch_perf)))


@dataclass
class _Parked:
    """One submission waiting in the front door's admission queue.

    Everything ``_materialize`` needs to turn it into a live ``_Run`` is
    carried here verbatim from ``submit``; validation already ran at park
    time (a rejected workflow is refused immediately, it never parks),
    and NO runtime state — reservations, namespace budgets, init_vars —
    lands until admission, so cancelling or failing a parked entry needs
    no rollback (the symmetric-release contract the admission paths
    share)."""
    handle: RunHandle
    pwf: PartitionedWorkflow
    wf: Workflow
    run_id: str
    ns: str
    mdss: Any
    init_vars: Optional[Dict[str, Any]]
    residency_budget: Optional[Dict[str, int]]
    declared: int
    policy: Optional[str]
    fetch: Any
    resume: bool
    weight: float
    priority: int
    speculate_after: Any
    prefetch: Optional[bool]
    checkpointer: Optional[RunCheckpointer]
    reason: str                     # capacity | budget | run_slots
    seq: int                        # FIFO tiebreak among equal deadlines
    parked_t: float                 # perf_counter at park time
    slo_ms: Optional[float] = None
    deadline_perf: Optional[float] = None
    preempt_fired: bool = False


def _park_order(p: _Parked) -> tuple:
    """Drain order: oldest (smallest) absolute deadline first, then FIFO.
    Strict head-of-queue admission — a later small run never bypasses the
    head (that bypass is exactly the H125 starvation shape)."""
    return (p.deadline_perf if p.deadline_perf is not None else float("inf"),
            p.seq)


_AUTO = object()


# --------------------------------------------------------------------------
# the runtime
# --------------------------------------------------------------------------
class EmeraldRuntime:
    """Long-lived multi-tenant scheduler over one shared fabric + MDSS."""

    def __init__(self, manager: Optional[MigrationManager] = None, *,
                 tiers=None, policy: str = "annotate",
                 cloud_tier: str = "cloud", max_workers: int = 8,
                 local_workers: int = 4,
                 speculate_after: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None, prefetch: bool = True,
                 shared_namespace: str = "shared", name: str = "emerald",
                 admission_headroom: float = 0.9,
                 park_limit: int = 64,
                 max_active_runs: Optional[int] = None,
                 memoize: Optional[bool] = None,
                 telemetry: bool = True,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 dispatch_hook=None):
        if manager is None:
            tiers = tiers or default_tiers()
            cm = CostModel(tiers)
            manager = MigrationManager(tiers, MDSS(tiers, cost_model=cm), cm)
        assert policy in POLICIES
        self.manager = manager
        self.mdss = manager.mdss                 # the shared base store
        # telemetry=False turns tracing AND metrics into no-ops (one
        # boolean check per call site) for minimum-overhead runs; pass a
        # shared Tracer/MetricsRegistry to aggregate across runtimes
        self.telemetry = telemetry
        self.tracer = tracer if tracer is not None else Tracer(
            enabled=telemetry)
        self.metrics = metrics if metrics is not None else MetricsRegistry(
            enabled=telemetry)
        manager.tracer = self.tracer
        self.mdss.tracer = self.tracer
        manager.register_metrics(self.metrics)
        self.mdss.register_metrics(self.metrics)
        self.default_policy = policy
        self.cloud_tier = cloud_tier
        self.max_workers = max_workers
        self.local_workers = local_workers
        self.speculate_after = speculate_after
        self.checkpoint_dir = checkpoint_dir
        self.prefetch = prefetch
        self.shared_namespace = shared_namespace
        self.name = name
        self.admission_headroom = admission_headroom
        # serving front door: the bounded admission (parking) queue.
        # submit(park=True) parks instead of raising AdmissionRefused
        # when capacity is tight; the driver drains it oldest-deadline-
        # first as capacity frees. queue_full is the only hard refusal.
        self.park_limit = park_limit
        # optional cap on concurrently admitted runs (the "lane
        # capacity" admission signal — None = unbounded, the pre-front-
        # door behaviour); counted by _live under _runs_lock
        self.max_active_runs = max_active_runs
        self._parked: List[_Parked] = []         # guarded by _runs_lock
        self._park_seq = itertools.count(1)
        self._live = 0                           # admitted, unfinalized runs
        self.parked_total = 0
        self.admitted_total = 0
        self._coalescers: List[Any] = []         # introspection attach point
        if memoize is not None:
            # cross-run step memoization (manager-wide): two tenants
            # submitting identical step code over content-identical
            # inputs share one execution. Only for deterministic steps —
            # see MigrationManager; Step.memoizable overrides per step.
            self.manager.memoize = memoize

        # schedule-exploration seam (emcheck): when set, the hook is
        # offered every dispatch choice — hook(lane, sorted run_ids) ->
        # chosen run_id or None to defer to fair share. Runs on the
        # driver thread; production leaves it None.
        self.dispatch_hook = dispatch_hook
        self._fair = FairShare()
        self._inbox: "queue.SimpleQueue" = queue.SimpleQueue()
        self._runs: Dict[str, _Run] = {}
        self._runs_lock = threading.Lock()       # _runs snapshot for stats
        # run_id -> (namespace, declared residency budget): admitted-but-
        # unfilled budgets count against remaining capacity at the front
        # door, so admission is budget-aware, not just occupancy-aware
        self._reserved: Dict[str, tuple] = {}
        self._busy = {True: 0, False: 0}         # keyed by offloaded?
        # (run_id, step) pairs granted a lane and not yet harvested — the
        # guard that makes a duplicate/late "done" (e.g. a speculation
        # loser surfacing after the winner) a no-op instead of a
        # double-decrement of lane slots and successor in-degrees
        self._outstanding: set = set()
        self._slots = {True: max_workers, False: local_workers}
        self._counter = itertools.count(1)
        self._closed = False
        self._close_lock = threading.Lock()
        self._close_done = threading.Event()
        self._draining = False
        self.runs_completed = 0
        self._fabric = None

        m = self.metrics
        m.gauge("runtime.active_runs", self.active_runs)
        m.gauge("runtime.offload_backlog", self.offload_backlog)
        m.gauge("runtime.lane_busy.offload", lambda: self._busy[True])
        m.gauge("runtime.lane_busy.local", lambda: self._busy[False])
        m.gauge("runtime.runs_completed", lambda: self.runs_completed)
        m.gauge("scheduler.fair_share", self._fair.shares)
        m.gauge("frontdoor.parked_depth", lambda: len(self._parked))
        m.gauge("frontdoor.parked_total", lambda: self.parked_total)
        m.gauge("frontdoor.admitted_total", lambda: self.admitted_total)

        self._offload_pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix=f"{name}-offload")
        self._local_pool = ThreadPoolExecutor(
            max_workers=local_workers, thread_name_prefix=f"{name}-local")
        # re-integration fetches run here so a slow cloud->local sync
        # never stalls the driver (and with it every other run's dispatch)
        self._misc_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix=f"{name}-finalize")
        # dedicated checkpoint writer lane: pickle writes must never
        # serialise the driver loop (one slow-disk tenant would stall
        # every other run's dispatch); one thread keeps per-run write
        # order trivially FIFO
        self._ckpt_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"{name}-ckpt")
        self._driver = threading.Thread(target=self._drive, daemon=True,
                                        name=f"{name}-driver")
        self._driver.start()

    # ------------------------------------------------------------------ api
    def submit(self, workflow, init_vars: Optional[Dict[str, Any]] = None, *,
               policy: Optional[str] = None, fetch=None, resume: bool = False,
               weight: float = 1.0, priority: int = 0,
               namespace: Optional[str] = None,
               residency_budget: Optional[Dict[str, int]] = None,
               speculate_after=_AUTO, prefetch: Optional[bool] = None,
               checkpointer: Optional[RunCheckpointer] = None,
               events: Optional[List[Event]] = None,
               on_done=None, validate: str = "error",
               park: bool = False, deadline_s: Optional[float] = None,
               slo_ms: Optional[float] = None) -> RunHandle:
        """Enqueue a workflow for concurrent execution (non-blocking).

        ``workflow`` may be a :class:`Workflow` (partitioned here) or an
        already-partitioned :class:`PartitionedWorkflow`. ``namespace``
        defaults to a fresh ``runN`` namespace (pass an explicit one to
        resubmit into warm per-run data, or ``""`` to address the base
        store un-namespaced — the compat shim's mode). ``weight`` is the
        fair-share knob (2.0 = twice the lane share under contention);
        ``priority`` is the fabric dispatch class (higher overtakes lower
        in the broker queue). ``residency_budget`` maps tier name ->
        max resident bytes for this run's namespace (MDSS evicts LRU
        entries back to local past the budget). Raises
        :class:`AdmissionRefused` when the shared store is within
        ``admission_headroom`` of its ``capacity_bytes`` ceiling, OR when
        the submission's declared ``residency_budget`` does not fit the
        *remaining* capacity — current residency plus the still-unfilled
        declared budgets of every admitted run — so a burst of small-now
        grow-later tenants is refused up front instead of thrashing the
        evictor mid-run. Returns a :class:`RunHandle`.

        ``validate`` runs the static verifier (``repro_torch.analysis``) at
        admission: ``"error"`` (default) raises
        :class:`~repro_torch.analysis.WorkflowRejected` on error-severity
        findings before any state is touched, ``"warn"`` admits and
        records every finding on ``handle.findings`` (plus a
        ``UserWarning`` when errors were found), ``"off"`` skips the
        pass. Warnings/infos never block in any mode.

        ``park=True`` turns every capacity refusal into a *parked*
        submission instead: the handle returns immediately in state
        ``"parked"`` and the driver's drain loop admits it (oldest
        ``deadline_s`` first, FIFO within equal deadlines) once
        residency reservations and run slots free up. A full parking
        queue (``park_limit``) is then the only hard refusal. ``slo_ms``
        arms SLO protection: when a parked (or admitted, lane-starved)
        interactive run's deadline slack shrinks below its SLO, the
        driver checkpoint-aborts the longest-running preemptible batch
        task so the decode path holds its p99.
        """
        if self._closed:
            raise RuntimeClosed("runtime is closed")
        park_reason = None
        if self.mdss.over_capacity(self.admission_headroom):
            if not park:
                raise AdmissionRefused(
                    f"shared store holds {self.mdss.resident_bytes()} of "
                    f"{self.mdss.capacity_bytes} capacity bytes (headroom "
                    f"{self.admission_headroom:.0%}): submission refused")
            park_reason = "capacity"
        if resume and namespace is None:
            # a fresh auto namespace has no prior state OR checkpoint to
            # resume from — silently re-running the whole DAG (including
            # non-idempotent completed steps) is the failure checkpoints
            # exist to prevent, so demand the original namespace
            raise ValueError(
                "resume=True needs the namespace of the run being resumed "
                "(auto namespaces are fresh per submission)")
        pwf = workflow if isinstance(workflow, PartitionedWorkflow) \
            else partition(workflow)
        wf = pwf.workflow
        n = next(self._counter)
        run_id = f"{wf.name}#{n}"
        ns = f"run{n}" if namespace is None else namespace
        mdss = self.mdss if ns == "" else self.mdss.namespaced(
            ns, shared=self.shared_namespace)
        if residency_budget and not ns:
            raise ValueError(
                "residency_budget needs a namespaced run (an "
                "un-namespaced submission shares the base store)")
        declared = sum(residency_budget.values()) if residency_budget else 0
        deadline_perf = None if deadline_s is None \
            else time.perf_counter() + deadline_s
        limit = self.admission_headroom * self.mdss.capacity_bytes \
            if declared and self.mdss.capacity_bytes else None
        with self._runs_lock:
            if self.max_active_runs is not None \
                    and self._live >= self.max_active_runs:
                if not park:
                    raise AdmissionRefused(
                        f"{self._live} of {self.max_active_runs} run slots "
                        "busy: submission refused")
                park_reason = park_reason or "run_slots"
            if limit is not None and park_reason is None:
                # check + reserve atomically: two concurrent submits that
                # each fit alone but not together must not both pass. An
                # admitted run's unfilled declared budget is capacity it
                # may still legitimately consume.
                reserved = sum(
                    max(0, decl - self.mdss.namespace_resident_bytes(rns))
                    for rns, decl in self._reserved.values())
                committed = self.mdss.resident_bytes() + reserved
                if committed + declared > limit:
                    if not park:
                        raise AdmissionRefused(
                            f"declared residency budget {declared} does not "
                            f"fit remaining capacity ({committed} of "
                            f"{limit:.0f} already committed by residency + "
                            "admitted budgets)")
                    park_reason = "budget"
            if park_reason is None:
                if limit is not None:
                    self._reserved[run_id] = (ns, declared)
                self._live += 1
        if park_reason is not None:
            return self._park(
                pwf, wf, run_id, ns, mdss, init_vars, residency_budget,
                declared, policy, fetch, resume, weight, priority,
                speculate_after, prefetch, checkpointer, events, on_done,
                validate, park_reason, deadline_s, deadline_perf, slo_ms)
        try:
            return self._submit_admitted(
                pwf, wf, run_id, ns, mdss, init_vars, residency_budget,
                policy, fetch, resume, weight, priority, speculate_after,
                prefetch, checkpointer, events, on_done, validate,
                slo_ms=slo_ms, deadline_perf=deadline_perf)
        except BaseException:
            # anything that fails between admission and the driver taking
            # ownership must release the reservation — a leak here would
            # shrink admission capacity forever. The run-slot count
            # releases symmetrically (same lock, same path) so a rejected
            # submission can never wedge the front door shut.
            with self._runs_lock:
                self._reserved.pop(run_id, None)
                self._live -= 1
            raise

    def _park(self, pwf, wf, run_id, ns, mdss, init_vars, residency_budget,
              declared, policy, fetch, resume, weight, priority,
              speculate_after, prefetch, checkpointer, events, on_done,
              validate, reason, deadline_s, deadline_perf, slo_ms
              ) -> RunHandle:
        """Park a submission the capacity checks refused. Validation runs
        FIRST — before the entry lands anywhere — so a rejected workflow
        is refused outright and a parked entry needs no rollback ever:
        no reservation, namespace budget, or init_vars put exists until
        the drain loop admits it."""
        findings = self._validate_submission(
            wf, mdss, init_vars, residency_budget, resume, validate)
        sink = events if events is not None else []
        handle = RunHandle(run_id, ns, self, sink)
        handle.findings = findings
        handle._on_done = on_done
        handle.trace_id = run_id
        handle._parked = True
        entry = _Parked(
            handle=handle, pwf=pwf, wf=wf, run_id=run_id, ns=ns, mdss=mdss,
            init_vars=init_vars, residency_budget=residency_budget,
            declared=declared, policy=policy, fetch=fetch, resume=resume,
            weight=weight, priority=priority, speculate_after=speculate_after,
            prefetch=prefetch, checkpointer=checkpointer, reason=reason,
            seq=next(self._park_seq), parked_t=time.perf_counter(),
            slo_ms=slo_ms, deadline_perf=deadline_perf)
        with self._runs_lock:
            if len(self._parked) >= self.park_limit:
                self.metrics.inc("frontdoor.queue_full")
                raise AdmissionRefused(
                    f"queue_full: admission queue holds {len(self._parked)} "
                    f"of {self.park_limit} parked submissions")
            self._parked.append(entry)
            depth = len(self._parked)
            self.parked_total += 1
        info = {"reason": reason, "depth": depth}
        if deadline_s is not None:
            info["deadline_s"] = deadline_s
        if slo_ms is not None:
            info["slo_ms"] = slo_ms
        t = time.perf_counter()
        sink.append(Event("park", "<workflow>", "", t, info, time.time()))
        # wake the driver for an immediate drain attempt (capacity may
        # already suffice — e.g. park under run-slot pressure that a
        # finalize just relieved)
        self._nudge()
        if self._closed and not self._driver.is_alive():
            # close() fully raced this park: nobody will ever drain it
            self._fail_parked(RuntimeClosed("runtime closed"))
        return handle

    def _submit_admitted(self, pwf, wf, run_id, ns, mdss, init_vars,
                         residency_budget, policy, fetch, resume, weight,
                         priority, speculate_after, prefetch, checkpointer,
                         events, on_done, validate="error", slo_ms=None,
                         deadline_perf=None) -> RunHandle:
        if residency_budget:
            for tier_name, max_bytes in residency_budget.items():
                self.mdss.set_namespace_budget(ns, tier_name, max_bytes)
        try:
            findings = self._validate_submission(
                wf, mdss, init_vars, residency_budget, resume, validate)
        except BaseException:
            # a rejected submission must leave no trace: clear the
            # budgets this call just configured (nothing else landed yet
            # — validation runs before the init_vars puts)
            for tier_name in (residency_budget or ()):
                self.mdss.set_namespace_budget(ns, tier_name, None)
            raise
        sink = events if events is not None else []
        handle = RunHandle(run_id, ns, self, sink)
        handle.findings = findings
        # installed before the run can possibly finalize — no TOCTOU
        handle._on_done = on_done
        handle.trace_id = run_id
        self._materialize(pwf, wf, run_id, ns, mdss, init_vars, resume,
                          policy, fetch, weight, priority, speculate_after,
                          prefetch, checkpointer, handle, sink, slo_ms,
                          deadline_perf)
        return handle

    def _materialize(self, pwf, wf, run_id, ns, mdss, init_vars, resume,
                     policy, fetch, weight, priority, speculate_after,
                     prefetch, checkpointer, handle, sink, slo_ms,
                     deadline_perf) -> "_Run":
        completed: set = set()
        # one trace per run: the root "run" span's identity is allocated
        # now (so every child can parent to it) and recorded at finalize;
        # the run's clock starts here, so it spans the "submit" phase:
        # the input and resumed variables' puts (MDSS hashes each)
        t_submit = time.perf_counter()
        root_ctx = (run_id, self.tracer.next_id()) \
            if self.tracer.enabled else None
        with self.tracer.span("submit", cat="data", parent=root_ctx):
            for uri, val in (init_vars or {}).items():
                if uri not in wf.variables:
                    wf.var(uri)
                mdss.put(uri, val, tier="local")
            if checkpointer is None and self.checkpoint_dir:
                checkpointer = RunCheckpointer(
                    mdss, wf, self.checkpoint_dir,
                    ckpt_name=f"{ns}.{wf.name}" if ns else wf.name)
            if resume and checkpointer is not None:
                state = checkpointer._load_checkpoint()
                if state is not None:
                    completed = set(state["completed"])
                    for uri, val in state["vars"].items():
                        mdss.put(uri, val, tier="local")
        if checkpointer is not None and checkpointer.checkpoint_dir:
            # seed from EVERY resident variable (init/resume vars and state
            # carried over from previous runs in this namespace): nothing
            # is in flight yet, so everything resident is completed work.
            # Variables currently resolving to the SHARED namespace are
            # not this run's state and are skipped — checkpointing them
            # would make resume write private (stale, re-staged) copies
            # of data meant to be stored once and read live.
            for uri in wf.variables:
                if not mdss.version(uri):
                    continue
                if getattr(mdss, "resolves_shared", None) is not None \
                        and mdss.resolves_shared(uri):
                    continue
                checkpointer._cache_var(uri)

        steps = {s.name: s for s in wf.toplevel()}
        completed &= set(steps)
        deps = wf.dependencies()
        succs = wf.successors(deps=deps)
        indeg = wf.in_degrees(completed, deps=deps)
        order_idx = {nm: i for i, nm in enumerate(wf.order)}
        run_policy = make_policy(policy or self.default_policy,
                                 self.manager.cost_model, mdss,
                                 self.cloud_tier)
        if hasattr(run_policy, "set_priorities"):
            run_policy.set_priorities(critical_path_lengths(
                wf, self.manager.cost_model, self.cloud_tier, succ=succs))

        run = _Run(run_id=run_id, ns=ns, handle=handle, wf=wf, steps=steps,
                   succs=succs, indeg=indeg, order_idx=order_idx,
                   completed=completed, mdss=mdss, policy=run_policy,
                   fetch=fetch, checkpointer=checkpointer, weight=weight,
                   priority=priority,
                   speculate_after=self.speculate_after
                   if speculate_after is _AUTO else speculate_after,
                   prefetch=self.prefetch if prefetch is None else prefetch,
                   events=sink, root_ctx=root_ctx, slo_ms=slo_ms,
                   deadline_perf=deadline_perf, epoch_perf=t_submit,
                   epoch_wall=wall_of(t_submit))
        handle.epoch_wall = run.epoch_wall
        if checkpointer is not None:
            checkpointer._emit = run.emit
        self._inbox.put(("submit", run))
        # close() may have fully raced this submit (entry check passed,
        # driver already exited): nobody will consume the message, so
        # flush it ourselves — the handle resolves instead of hanging
        if self._closed and not self._driver.is_alive():
            self._flush_orphaned_inbox()
        return run

    def _validate_submission(self, wf, mdss, init_vars, residency_budget,
                             resume, validate):
        """Admission-time static verification (repro_torch.analysis). Runs
        before ANY submission state lands (budgets, init_vars puts), so
        a rejection leaves the runtime and store untouched."""
        if validate not in ("error", "warn", "off"):
            raise ValueError(
                f"validate must be 'error', 'warn' or 'off', "
                f"not {validate!r}")
        if validate == "off":
            return []
        from repro_torch.analysis.verifier import WorkflowRejected, verify
        provided = None
        if not resume:
            # the bound set: explicit init vars plus whatever is already
            # resident for this run's namespace (warm resubmission /
            # shared-namespace fall-through)
            provided = set(init_vars or ())
            provided |= {u for u in wf.variables
                         if u not in provided and mdss.version(u)}
        findings = verify(wf, provided=provided,
                          residency_budget=residency_budget,
                          tiers=self.manager.tiers,
                          capacity_bytes=self.mdss.capacity_bytes)
        errors = [f for f in findings if f.severity == "error"]
        if errors:
            if validate == "error":
                self.metrics.inc("runtime.submissions_rejected")
                raise WorkflowRejected(wf.name, findings)
            warnings.warn(
                f"emerald verifier: workflow {wf.name!r} admitted with "
                f"{len(errors)} error-severity finding(s) "
                f"(validate='warn'): "
                + "; ".join(f"{f.rule} {f.message}" for f in errors),
                stacklevel=3)
        return findings

    # ------------------------------------------------------ admission queue
    def _nudge(self):
        """Wake the driver for a drain attempt (freed residency or a
        released namespace can admit parked runs). Safe from any thread;
        a dead driver ignores it via the orphan flush."""
        if not self._closed and self._driver.is_alive():
            self._inbox.put(("nudge",))

    def _fits_locked(self, declared: int) -> bool:
        """Would a submission with ``declared`` budget bytes be admitted
        right now? Caller holds ``_runs_lock`` (same atomic
        check-then-reserve discipline as ``submit``)."""
        if self.max_active_runs is not None \
                and self._live >= self.max_active_runs:
            return False
        if self.mdss.over_capacity(self.admission_headroom):
            return False
        if declared and self.mdss.capacity_bytes:
            limit = self.admission_headroom * self.mdss.capacity_bytes
            reserved = sum(
                max(0, decl - self.mdss.namespace_resident_bytes(rns))
                for rns, decl in self._reserved.values())
            if self.mdss.resident_bytes() + reserved + declared > limit:
                return False
        return True

    def _drain_parked(self):
        """Driver-side: admit parked submissions oldest-deadline-first
        while the head fits. Strictly head-of-queue — when the head does
        not fit, nothing behind it is considered (a smaller latecomer
        bypassing the head is the H125 starvation hazard)."""
        if self._draining:
            return
        while True:
            with self._runs_lock:
                if not self._parked:
                    return
                p = min(self._parked, key=_park_order)
                if not self._fits_locked(p.declared):
                    return
                self._parked.remove(p)
                if p.declared and self.mdss.capacity_bytes:
                    self._reserved[p.run_id] = (p.ns, p.declared)
                self._live += 1
                depth = len(self._parked)
            try:
                self._admit_parked(p, depth)
            except BaseException as e:
                # symmetric release: an admission that fails mid-flight
                # must return its reservation + run slot, exactly like
                # the direct-submit reject path
                with self._runs_lock:
                    self._reserved.pop(p.run_id, None)
                    self._live -= 1
                p.handle._parked = False
                p.handle._finish(error=e)

    def _admit_parked(self, p: _Parked, depth: int):
        """Turn one parked entry into a live run (driver thread)."""
        if p.residency_budget:
            for tier_name, max_bytes in p.residency_budget.items():
                self.mdss.set_namespace_budget(p.ns, tier_name, max_bytes)
        waited = time.perf_counter() - p.parked_t
        try:
            run = self._materialize(
                p.pwf, p.wf, p.run_id, p.ns, p.mdss, p.init_vars, p.resume,
                p.policy, p.fetch, p.weight, p.priority, p.speculate_after,
                p.prefetch, p.checkpointer, p.handle, p.handle.events,
                p.slo_ms, p.deadline_perf)
        except BaseException:
            for tier_name in (p.residency_budget or ()):
                self.mdss.set_namespace_budget(p.ns, tier_name, None)
            raise
        run.preempt_fired = p.preempt_fired
        # waited seconds become a fair-share deficit credit when the
        # driver processes the submit message — a near-SLO latecomer
        # overtakes tenants that were running while it was parked
        run.admit_credit = waited
        p.handle._parked = False
        self.admitted_total += 1
        self.metrics.inc("frontdoor.admitted_total")
        self.metrics.observe("frontdoor.park_wait_s", waited)
        info = {"waited_s": waited, "depth": depth}
        if p.deadline_perf is not None:
            info["slack_s"] = p.deadline_perf - time.perf_counter()
        run.emit("admit", "<workflow>", **info)

    def _fail_parked(self, err: BaseException):
        """Fail every parked entry (shutdown paths). Idempotent and
        thread-safe; parked entries hold no runtime state to roll back."""
        with self._runs_lock:
            doomed, self._parked = self._parked, []
        for p in doomed:
            p.handle._parked = False
            p.handle._finish(error=err)

    def _check_slo(self):
        """Driver-side SLO guard: when an interactive run's deadline
        slack shrinks below its SLO while it is still parked — or
        admitted but lane-starved — checkpoint-abort the longest-running
        preemptible batch task on the fabric (requeued attempt-free) so
        a worker frees up. At most one preemption per run."""
        if self._draining:
            return
        broker = getattr(self._fabric, "broker", None)
        if broker is None or not hasattr(broker, "preempt_longest"):
            return
        now = time.perf_counter()
        threatened: List[Any] = []
        with self._runs_lock:
            for p in self._parked:
                if p.deadline_perf is None or p.preempt_fired:
                    continue
                if p.deadline_perf - now <= (p.slo_ms or 0.0) / 1000.0:
                    p.preempt_fired = True
                    threatened.append((p.handle.events, p.deadline_perf))
        for run in self._runs.values():
            if run.deadline_perf is None or run.preempt_fired:
                continue
            if not run.ready[True] and not run.ready[False]:
                continue        # nothing waiting on a lane
            if run.deadline_perf - now <= (run.slo_ms or 0.0) / 1000.0:
                run.preempt_fired = True
                threatened.append((run.events, run.deadline_perf))
        for sink, deadline in threatened:
            task = broker.preempt_longest()
            if task is None:
                return          # nothing preemptible in flight
            self.metrics.inc("frontdoor.preemptions")
            t = time.perf_counter()
            sink.append(Event(
                "preempt", "<workflow>", "", t,
                {"victim": f"task{task.task_id}", "step": task.step or "",
                 "slack_s": deadline - now}, time.time()))

    def publish(self, uri: str, value, tier: str = "local") -> int:
        """Write warm cross-run data into the shared namespace: every
        run's reads of ``uri`` fall through to this copy (until the run
        writes its own), so it is stored — and stays cloud-resident —
        exactly once across all tenants."""
        return self.mdss.put(f"{self.shared_namespace}/{uri}", value,
                             tier=tier)

    def warm(self, uris, tier: Optional[str] = None) -> int:
        """Pre-position shared-namespace ``uris`` on ``tier`` (default:
        the cloud tier); returns bytes moved."""
        tier = tier or self.cloud_tier
        return self.mdss.ensure(
            [f"{self.shared_namespace}/{u}" for u in uris], tier)

    def attach_fabric(self, fabric, tier_names=("cloud",)):
        """Back ``tier_names`` with an offload fabric, swap the MDSS
        transport for its RPCTransport, and point the fabric autoscaler
        (when present) at this runtime's aggregate ready backlog AND the
        store's eviction churn — residency thrash grows the pool instead
        of grinding the same bytes back and forth."""
        from repro_torch.cloud import attach
        transport = attach(self.manager.tiers, fabric, tier_names,
                           mdss=self.mdss,
                           cost_model=self.manager.cost_model)
        if getattr(fabric, "autoscaler", None) is not None:
            fabric.autoscaler.backlog_fn = self.offload_backlog
            fabric.autoscaler.churn_fn = lambda: self.mdss.eviction_bytes
        # wire the fabric into this runtime's telemetry: the broker gets
        # the tracer (worker-reported phases re-materialise as spans) and
        # every fabric component registers its counters/gauges
        self._fabric = fabric
        broker = getattr(fabric, "broker", None)
        if broker is not None:
            broker.tracer = self.tracer
            if hasattr(broker, "register_metrics"):
                broker.register_metrics(self.metrics)
        pool = getattr(fabric, "pool", None)
        if pool is not None and hasattr(pool, "register_metrics"):
            pool.register_metrics(self.metrics)
        scaler = getattr(fabric, "autoscaler", None)
        if scaler is not None and hasattr(scaler, "register_metrics"):
            scaler.register_metrics(self.metrics)
        return transport

    # ---------------------------------------------------------------- stats
    def active_runs(self) -> int:
        with self._runs_lock:
            return len(self._runs)

    def offload_backlog(self) -> int:
        """Cross-run count of ready offload steps not yet granted a lane
        — the autoscaler's aggregate-pressure signal. Capped at the
        offload lane width: the broker can never be fed more concurrent
        tasks than the runtime has lanes, so reporting the raw heap depth
        would scale up workers the runtime cannot keep busy."""
        with self._runs_lock:
            # same eligibility filter as _dispatch_all: a failing run's
            # heap is draining dead weight, not future broker load
            ready = sum(len(r.ready[True]) for r in self._runs.values()
                        if not r.failures and not r.cancelled)
        return min(ready, self.max_workers)

    # --------------------------------------------------------- introspection
    def introspect(self, timeout: float = 10.0) -> dict:
        """Structured snapshot of the whole runtime: runs (per-step
        states, placements, retries), lane occupancy, per-(namespace,
        tier) residency vs. budget, memo table, workers, and a metrics
        snapshot.

        The snapshot is built ON the driver thread, serialised with
        every state mutation — a step can never appear simultaneously
        in-flight and completed, across any number of tenants. Falls
        back to a direct (best-effort) read when the driver is gone
        (closed runtime) or does not answer within ``timeout``.
        """
        if self._driver.is_alive() and not self._closed:
            box: dict = {}
            done = threading.Event()
            self._inbox.put(("introspect", box, done))
            if done.wait(timeout) and "snapshot" in box:
                return box["snapshot"]
        # driver gone or unresponsive: read directly. Post-close nothing
        # mutates, so this is exact; on a wedged driver it is best-effort.
        return self._introspect_unsafe()

    def attach_coalescer(self, coalescer) -> None:
        """Register a :class:`~repro_torch.core.batching.BatchCoalescer` so its
        live bucket occupancy shows up under ``introspect()['frontdoor']``
        (and in emtop's FRONTDOOR panel)."""
        self._coalescers.append(coalescer)

    def _introspect_unsafe(self) -> dict:
        now = time.perf_counter()
        with self._runs_lock:
            runs = list(self._runs.values())
            parked_rows = [{
                "run_id": p.run_id,
                "reason": p.reason,
                "waited_s": now - p.parked_t,
                "slack_s": (p.deadline_perf - now)
                if p.deadline_perf is not None else None,
                "slo_ms": p.slo_ms,
            } for p in sorted(self._parked, key=_park_order)]
        run_rows = []
        for run in runs:
            states = {nm: "pending" for nm in run.steps}
            for h in run.ready.values():
                for _, _, nm in h:
                    states[nm] = "ready"
            # inflight/completed written LAST: _complete() moves a step
            # from _outstanding into run.completed on this same driver
            # thread, so the two sets are disjoint here by construction
            for rid, nm in list(self._outstanding):
                if rid == run.run_id and nm in states:
                    states[nm] = "inflight"
            for nm in run.completed:
                if nm in states:
                    states[nm] = "completed"
            n_ready = sum(1 for st in states.values() if st == "ready")
            run_rows.append({
                "run_id": run.run_id,
                "ns": run.ns,
                "state": ("cancelled" if run.cancelled
                          else "failing" if run.failures else "running"),
                "completed": len(run.completed),
                "inflight": run.inflight,
                "ready": n_ready,
                "pending": sum(1 for st in states.values()
                               if st == "pending"),
                "retries": run.retries,
                "weight": run.weight,
                "priority": run.priority,
                "steps": states,
                "placements": dict(run.placed),
                "fair_share_vtime": self._fair.share_of(run.run_id),
            })
        snap = {
            "runtime": {
                "pid": os.getpid(), "name": self.name,
                "telemetry": self.telemetry, "closed": self._closed,
                "draining": self._draining,
                "runs_completed": self.runs_completed,
                "trace_spans": len(self.tracer.spans())
                if self.tracer.enabled else 0,
                "trace_dropped": self.tracer.dropped,
            },
            "lanes": {
                "offload": {"busy": self._busy[True],
                            "slots": self._slots[True]},
                "local": {"busy": self._busy[False],
                          "slots": self._slots[False]},
            },
            "runs": run_rows,
            "frontdoor": {
                "depth": len(parked_rows),
                "queue_limit": self.park_limit,
                "parked": parked_rows,
                "oldest_wait_s": max(
                    (r["waited_s"] for r in parked_rows), default=0.0),
                "parked_total": self.parked_total,
                "admitted_total": self.admitted_total,
                "coalescers": [c.introspect() for c in self._coalescers],
            },
            "fair_share": self._fair.shares(),
            "mdss": self.mdss.introspect(),
            "memo": self.manager.memo_stats(),
            "workers": self._fabric_info(),
            "metrics": self.metrics.snapshot(),
        }
        return snap

    def _fabric_info(self) -> dict:
        broker = getattr(self._fabric, "broker", None)
        if broker is None:
            return {}
        try:
            return {
                "num_workers": broker.num_workers(),
                "warm": (broker.num_workers(include_warm=True)
                         - broker.num_workers()),
                "idle": broker.idle_workers(),
                "queue_depth": broker.queue_depth(),
                "inflight": broker.inflight(),
                "pids": broker.worker_pids(),
            }
        except Exception:
            return {}

    def export_trace(self, path: str, run_id: Optional[str] = None) -> str:
        """Write the Chrome trace-event JSON for ``run_id`` (or every
        recorded span) to ``path``; open it in Perfetto or
        ``chrome://tracing``."""
        return self.tracer.export_json(path, trace_id=run_id)

    # ------------------------------------------------------------- shutdown
    def close(self, timeout: Optional[float] = 60.0):
        """Drain in-flight steps, fail still-pending runs with
        :class:`RuntimeClosed`, and join the lanes + driver."""
        with self._close_lock:
            first = not self._closed
            self._closed = True
        if not first:
            # another thread (e.g. the shim's reaper) owns the teardown:
            # block until it finishes so close() always means closed
            self._close_done.wait(timeout)
            return
        self._inbox.put(("stop",))
        self._driver.join(timeout=timeout)
        self._flush_orphaned_inbox()
        # entries parked after the driver processed "stop" (or left
        # behind by a timed-out join) must still resolve
        self._fail_parked(RuntimeClosed("runtime closed"))
        self._offload_pool.shutdown(wait=True)
        self._local_pool.shutdown(wait=True)
        self._misc_pool.shutdown(wait=True)
        self._ckpt_pool.shutdown(wait=True)
        self._close_done.set()

    def _flush_orphaned_inbox(self):
        """Fail submissions enqueued after the driver exited (SimpleQueue
        is thread-safe; concurrent flushers each drain distinct items).

        Strictly a dead-driver path: while the driver lives (e.g. a close
        whose join timed out on a long in-flight step) the inbox belongs
        to it — stealing a "done"/"cancel" message here would wedge the
        drain forever."""
        if self._driver.is_alive():
            return
        while True:
            try:
                msg = self._inbox.get_nowait()
            except queue.Empty:
                return
            if msg[0] == "submit":
                with self._runs_lock:
                    self._reserved.pop(getattr(msg[1], "run_id", None), None)
                    self._live -= 1
                msg[1].handle._finish(error=RuntimeClosed("runtime closed"))
            elif msg[0] == "introspect":
                # answer directly so a caller racing close() never hangs
                msg[1]["snapshot"] = self._introspect_unsafe()
                msg[2].set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ----------------------------------------------------------- driver loop
    def _drive(self):
        while True:
            msg = self._inbox.get()
            try:
                if self._drive_one(msg):
                    return
            except BaseException as e:
                # a driver-side fault (not a step failure — those ride the
                # done queue) must never silently hang every handle: fail
                # the active runs with it and keep serving
                for run in list(self._runs.values()):
                    self._finalize(run, e)
                if self._draining and not self._runs:
                    return

    def _drive_one(self, msg) -> bool:
        kind = msg[0]
        touched: List[_Run] = []
        if kind == "stop":
            self._draining = True
            self._fail_parked(RuntimeClosed("runtime closed"))
            for run in list(self._runs.values()):
                run.ready = {True: [], False: []}
                touched.append(run)
        elif kind == "submit":
            run = msg[1]
            if self._draining:
                with self._runs_lock:
                    self._reserved.pop(run.run_id, None)
                    self._live -= 1
                run.handle._finish(error=RuntimeClosed("runtime closed"))
                return False
            with self._runs_lock:
                self._runs[run.run_id] = run
            self._fair.add(run.run_id, run.weight)
            if run.admit_credit:
                # the park wait becomes deficit: vtime drops below the
                # field, so the admitted run is picked first until the
                # credit is consumed
                self._fair.charge(run.run_id, -run.admit_credit)
            for nm, d in run.indeg.items():
                if d == 0:
                    self._push_ready(run, nm)
            touched.append(run)
        elif kind == "done":
            run = self._complete(*msg[1:])
            if run is not None:
                touched.append(run)
        elif kind == "ckpt_done":
            run = self._runs.get(msg[1])
            if run is not None:
                run.ckpt_inflight -= 1
                if msg[2] is not None:
                    # durability is the contract: an unwritable checkpoint
                    # fails THIS run, not the whole driver
                    run.failures.append(msg[2])
                touched.append(run)
        elif kind == "cancel":
            run = self._runs.get(msg[1])
            if run is not None and not run.cancelled:
                run.cancelled = True
                run.ready = {True: [], False: []}
                touched.append(run)
            elif run is None:
                # a parked submission cancels cleanly: it holds no
                # reservation or namespace state, so removal IS the
                # whole rollback
                with self._runs_lock:
                    p = next((q for q in self._parked
                              if q.run_id == msg[1]), None)
                    if p is not None:
                        self._parked.remove(p)
                if p is not None:
                    p.handle._parked = False
                    p.handle._finish(error=RunCancelled(
                        f"run {p.run_id} cancelled"))
        elif kind == "introspect":
            # built here, between mutations — serially consistent
            msg[1]["snapshot"] = self._introspect_unsafe()
            msg[2].set()
        self._dispatch_all()
        for run in touched:
            if run.run_id in self._runs:
                self._reap(run)
        # every message is a drain opportunity — AFTER the reap, which
        # is where finalizes free run slots and reservations (nudges
        # from release()/park() land here too); admissions re-enter the
        # loop as "submit" messages, then the SLO guard runs
        self._drain_parked()
        self._check_slo()
        return self._draining and not self._runs

    def _push_ready(self, run: _Run, name: str):
        s = run.steps[name]
        prio = 0.0
        if hasattr(run.policy, "dispatch_priority"):
            prio = run.policy.dispatch_priority(s)
        place = getattr(run.policy, "place", None)
        if place is not None:
            # locality-aware lane choice, decided when the step becomes
            # ready — its inputs are final here (every producer
            # completed), so the residency map it scores is the one its
            # staging will actually see
            with self.tracer.span("place", cat="sched", track="driver",
                                  parent=run.root_ctx, step=name) as sp:
                decision = place(s)
                if sp.ctx is not None:
                    sp.set(tier=decision.tier, reason=decision.reason)
            run.placements[name] = decision
            lane = decision.offload
        else:
            lane = run.policy.should_offload(s)
        run.placed[name] = decision.tier if place is not None \
            else (self.cloud_tier if lane else "local")
        heapq.heappush(run.ready[lane], (-prio, run.order_idx[name], name))

    def _dispatch_all(self):
        """Grant free lane slots: fair share picks the run, the run's
        critical-path heap picks the step — (deficit share, -cpl)."""
        if self._draining:
            return
        for lane, pool in ((True, self._offload_pool),
                           (False, self._local_pool)):
            while self._busy[lane] < self._slots[lane]:
                cands = {r.run_id: r for r in self._runs.values()
                         if r.ready[lane] and not r.failures
                         and not r.cancelled}
                if not cands:
                    break
                chosen = None
                if self.dispatch_hook is not None:
                    chosen = self.dispatch_hook(
                        "offload" if lane else "local",
                        sorted(cands))
                if chosen is None:
                    chosen = self._fair.pick(cands)
                run = cands[chosen]
                _, _, name = heapq.heappop(run.ready[lane])
                s = run.steps[name]
                decision = run.placements.pop(name, None)
                self._fair.charge(run.run_id, self._est_cost(s, decision))
                if decision is not None:
                    run.emit("place", s.name, decision.tier,
                             reason=decision.reason, scores=decision.scores,
                             stale_bytes=decision.stale_bytes)
                self._prefetch_successors(run, s)
                if s.fanout_role == "scatter":
                    # umbrella span for the whole fan-out: allocated now
                    # so shard/gather dispatch spans can parent to it,
                    # recorded when the gather completes (_complete)
                    run.fanout_t0[s.fanout_parent] = wall_now()
                    if run.root_ctx is not None:
                        run.fanout_ctx[s.fanout_parent] = (
                            run.run_id, self.tracer.next_id())
                elif s.fanout_role == "shard":
                    self.metrics.inc("fanout.shards_dispatched")
                run.emit("dispatch", s.name, run.placed.get(name, ""),
                         lane="offload" if lane else "local")
                if lane:
                    run.emit("suspend", s.name)
                run.inflight += 1
                self._busy[lane] += 1
                self._outstanding.add((run.run_id, name))
                self.metrics.inc("runtime.steps_dispatched")
                pool.submit(self._lane, run, s, lane)

    def _est_cost(self, s: Step, decision=None) -> float:
        # fair-share charge: with a locality decision the chosen tier's
        # exec+transfer score is the run's real cost; otherwise the
        # worst-tier exec estimate (the pre-locality behaviour)
        if decision is not None:
            est = decision.scores.get(decision.tier, 0.0)
            if est > 0:
                return est
        cm = self.manager.cost_model
        est = cm.exec_time(s, "local")
        if self.cloud_tier in cm.tiers:
            est = max(est, cm.exec_time(s, self.cloud_tier))
        return est if est > 0 else 1.0

    def _complete(self, run_id: str, name: str, err, offloaded: bool
                  ) -> Optional[_Run]:
        key = (run_id, name)
        if key not in self._outstanding:
            # duplicate/late harvest — a speculation loser (or replayed
            # done message) surfacing after the winner already completed
            # the step. Decrementing again would free a lane slot that
            # was never re-taken and, worse, double-decrement successor
            # in-degrees: a successor still waiting on another input
            # would dispatch early and read a hole. Drop it.
            return None
        self._outstanding.discard(key)
        self._busy[offloaded] -= 1
        run = self._runs.get(run_id)
        if run is None:
            return None
        run.inflight -= 1
        if err is not None:
            run.failures.append(err)     # keep draining siblings
            return run
        if run.cancelled:
            return run
        if offloaded:
            run.emit("resume", name)
        run.completed.add(name)
        run.emit("step_done", name, offloaded=offloaded)
        self.metrics.inc("runtime.steps_completed")
        st = run.steps[name]
        if st.fanout_role == "scatter":
            run.emit("scatter", name, shards=st.fanout_shards,
                     parent=st.fanout_parent, uris=list(st.outputs))
            self.metrics.inc("fanout.scatters")
        elif st.fanout_role == "shard":
            run.emit("shard_done", name, shard=st.shard_index,
                     parent=st.fanout_parent)
            self.metrics.inc("fanout.shards_completed")
        elif st.fanout_role == "gather":
            run.emit("gather", name, shards=st.fanout_shards,
                     parent=st.fanout_parent)
            self.metrics.inc("fanout.gathers")
            ctx = run.fanout_ctx.pop(st.fanout_parent, None)
            t0 = run.fanout_t0.pop(st.fanout_parent, None)
            if ctx is not None and t0 is not None:
                # the umbrella span every shard dispatch parented to
                self.tracer.add_span(
                    run.run_id, f"fanout:{st.fanout_parent}", t0,
                    wall_now() - t0, span_id=ctx[1],
                    parent_id=run.root_ctx[1], cat="sched", track="driver",
                    shards=st.fanout_shards)
        if run.root_ctx is not None:
            self.tracer.add_span(run.run_id, "complete", wall_now(), 0.0,
                                 parent_id=run.root_ctx[1], cat="sched",
                                 track="driver", step=name,
                                 offloaded=offloaded)
        # outputs cached BEFORE successors dispatch (see RunCheckpointer)
        if run.checkpointer is not None:
            run.checkpointer._cache_outputs(run.steps[name])
        if not self._draining:
            # close() drains IN-FLIGHT work only: a completion during
            # shutdown must not unlock (and run) the rest of the DAG
            for m in run.succs.get(name, ()):
                if m in run.indeg and m not in run.completed:
                    run.indeg[m] -= 1
                    if run.indeg[m] == 0:
                        self._push_ready(run, m)
        run.ckpt_dirty = True
        return run

    def _reap(self, run: _Run):
        """Finalize ``run`` if it reached a terminal state. Called on the
        driver after dispatch, so a ready-but-unlaned step (heap nonempty)
        is never mistaken for a stall."""
        # durable per completion, not per wave. The pickle runs on the
        # dedicated checkpoint lane (never the driver): the driver
        # freezes a consistent (completed, vars) snapshot, queues the
        # write, and coalesces further dirt until the ckpt_done message
        # returns — at most one write in flight per run.
        if run.checkpointer is None:
            run.ckpt_dirty = False
        elif run.ckpt_dirty and run.ckpt_inflight == 0:
            run.ckpt_dirty = False
            completed = set(run.completed)
            run.checkpointer._freeze(completed)

            def write(run=run, completed=completed):
                try:
                    run.checkpointer._save_checkpoint(completed)
                    err = None
                except BaseException as e:
                    err = e
                self._inbox.put(("ckpt_done", run.run_id, err))

            try:
                run.ckpt_inflight += 1
                self._ckpt_pool.submit(write)
            except BaseException as e:
                # lane already shut (straggler completion after close's
                # join timeout): durability is the contract — fail the run
                run.ckpt_inflight -= 1
                run.failures.append(e)
        if run.ckpt_inflight > 0:
            # per-run completion fence: the handle must not resolve (nor
            # the run finalize in any direction) before its checkpoint is
            # durable — the ckpt_done message re-enters this reap
            return
        if len(run.completed) == len(run.steps) and not run.failures:
            self._finalize(run, None)
        elif run.inflight == 0:
            if run.cancelled:
                self._finalize(run, RunCancelled(
                    f"run {run.run_id} cancelled"))
            elif run.failures:
                self._finalize(run, run.failures[0])
            elif self._draining:
                self._finalize(run, RuntimeClosed("runtime closed"))
            elif not run.ready[True] and not run.ready[False]:
                self._finalize(run, WorkflowFailure(
                    "dependency cycle or failed step"))

    def _finalize(self, run: _Run, error: Optional[BaseException]):
        with self._runs_lock:
            del self._runs[run.run_id]
            self._reserved.pop(run.run_id, None)
            self._live -= 1
        self._fair.remove(run.run_id)
        self.runs_completed += 1
        if run.root_ctx is not None:
            # the run's root span, with the identity every child used
            self.tracer.add_span(
                run.run_id, "run", run.epoch_wall,
                time.perf_counter() - run.epoch_perf,
                span_id=run.root_ctx[1], cat="run",
                track=f"run:{run.run_id}", namespace=run.ns,
                steps=len(run.steps),
                outcome="error" if error is not None else "ok")
        if run.checkpointer is not None:
            run.checkpointer._ckpt_cache.clear()   # release pinned copies
        if error is not None:
            run.handle._finish(error=error)
            return

        def reintegrate():
            try:
                uris = run.fetch if run.fetch is not None else [
                    u for u in run.wf.variables if run.mdss.version(u)]
                run.handle._finish(result={
                    uri: run.mdss.get(uri, "local") for uri in uris
                    if run.mdss.version(uri)})
            except BaseException as e:
                run.handle._finish(error=e)

        try:
            self._misc_pool.submit(reintegrate)
        except BaseException as e:
            # pool already shut (e.g. a straggler finishing after close()'s
            # join timeout): the handle must still resolve, never hang
            run.handle._finish(error=e)

    # ----------------------------------------------------------- lane bodies
    def _lane(self, run: _Run, s: Step, offloaded: bool):
        try:
            # the dispatch span: everything below — staging, ship, remote
            # exec, install — nests under it via the lane thread's TLS,
            # and its ctx rides the wire so worker-side phases do too
            parent_ctx = run.root_ctx
            if s.fanout_role:
                # shard/gather (and scatter) spans nest under the fan-out
                # umbrella span allocated at scatter dispatch
                parent_ctx = run.fanout_ctx.get(s.fanout_parent, run.root_ctx)
            with self.tracer.span(
                    "dispatch", cat="sched",
                    track=f"lane:{'offload' if offloaded else 'local'}",
                    trace_id=run.run_id, parent=parent_ctx,
                    step=s.name, run=run.run_id):
                if offloaded:
                    self._offload_with_recovery(run, s)
                else:
                    self._run_local(run, s)
            err = None
        except BaseException as e:           # harvested by the driver
            err = e
        self._inbox.put(("done", run.run_id, s.name, err, offloaded))

    def _run_local(self, run: _Run, s: Step):
        rep = self.manager.execute(s, "local", mdss=run.mdss,
                                   priority=run.priority)
        run.emit("local", s.name, "local", seconds=rep.seconds,
                 memo_hit=rep.memo_hit)

    def _offload_with_recovery(self, run: _Run, s: Step):
        tiers_to_try = [self.cloud_tier] * max(1, s.retries) + ["local"]
        last_err = None
        for attempt, tier in enumerate(tiers_to_try):
            try:
                rep = self._execute_maybe_speculative(run, s, tier)
                run.emit("offload", s.name, rep.tier,
                         seconds=rep.seconds, bytes_in=rep.bytes_in,
                         bytes_out=rep.bytes_out, code_only=rep.code_only,
                         attempt=attempt, remote=rep.remote,
                         worker_pid=rep.worker_pid, staged_s=rep.staged_s,
                         memo_hit=rep.memo_hit)
                return rep
            except StepFailure as e:      # node failure -> retry / fallback
                last_err = e
                run.retries += 1
                self.metrics.inc("runtime.step_retries")
                run.emit("retry", s.name, tier, attempt=attempt,
                         error=str(e))
        raise WorkflowFailure(f"step {s.name} failed on all tiers: {last_err}")

    def _execute_maybe_speculative(self, run: _Run, s: Step, tier: str):
        alt = self._alternate_tier(s, tier)
        est = self.manager.cost_model.stats_for(s.name).measured_s.get(tier)
        if run.speculate_after is None or alt is None or est is None:
            return self.manager.execute(s, tier, mdss=run.mdss,
                                        priority=run.priority)
        timeout = est * run.speculate_after
        # no context manager: pool shutdown must NOT join the straggler
        spool = ThreadPoolExecutor(max_workers=2)
        # speculation twins run on fresh threads: re-attach the lane
        # thread's dispatch span so their ship/exec spans stay parented
        ctx = self.tracer.current_ctx()

        def execute(t, memo=None):
            with self.tracer.attach(ctx):
                return self.manager.execute(s, t, mdss=run.mdss,
                                            priority=run.priority,
                                            memoize=memo)
        try:
            primary = spool.submit(execute, tier)
            done, _ = wait([primary], timeout=timeout)
            if done:
                return primary.result()
            run.emit("speculate", s.name, alt, timeout=timeout)
            # the backup bypasses memoization: under memoize=True it
            # would otherwise become a WAITER on the primary's own
            # in-flight memo entry — a "race" that can never overtake
            backup = spool.submit(execute, alt, False)
            # first *successful* finisher wins: a primary that fails fast
            # right after the backup launches must not fail the step
            pending = {primary, backup}
            last_err, fenced_rep = None, None
            while pending:
                done, pending = wait(pending, return_when=FIRST_COMPLETED)
                for f in done:
                    try:
                        rep = f.result()
                    except StepFailure as e:
                        last_err = e
                        continue
                    if rep.fenced:
                        # the loser's report (its publish was refused) —
                        # keep only as a fallback so the recorded offload
                        # event reflects the twin that actually published
                        fenced_rep = rep
                        continue
                    return rep
            if fenced_rep is not None:
                return fenced_rep
            raise last_err                   # both twins failed
        finally:
            spool.shutdown(wait=False)

    def _alternate_tier(self, s: Step, tier: str) -> Optional[str]:
        """Best backup tier for speculation: the candidate with the lowest
        modeled/measured execution time, NOT whatever dict order yields —
        deterministic, and targeted at the fastest recovery. Unknown
        estimates (0.0) tie and fall back to declaration order."""
        cm = self.manager.cost_model
        order = {nm: i for i, nm in enumerate(self.manager.tiers)}
        cands = [nm for nm in self.manager.tiers if nm not in (tier, "local")]
        if not cands:
            return None
        return min(cands, key=lambda nm: (cm.exec_time(s, nm), order[nm]))

    def _prefetch_successors(self, run: _Run, s: Step):
        """Warm the cloud tier with a dispatched step's successors' inputs.

        Only inputs that already exist and are stale on the cloud tier
        move; outputs of still-running steps are skipped (MDSS.prefetch is
        best-effort and version-hazard-checked), so the transfer safely
        overlaps this step's compute.
        """
        if not run.prefetch or self.cloud_tier not in self.manager.tiers:
            return
        for m in run.succs.get(s.name, ()):
            succ = run.wf.steps[m]
            if not run.policy.should_offload(succ):
                continue
            # skip vars s itself is about to rewrite: their current
            # version is guaranteed dead by the time the successor reads
            uris = [u for u in succ.inputs
                    if u not in s.outputs
                    and run.mdss.version(u)
                    and not run.mdss.has_latest(u, self.cloud_tier)]
            if uris and run.mdss.prefetch(uris, self.cloud_tier) is not None:
                # emitted only for ADMITTED requests (None = shed at the
                # MDSS concurrency cap), so the event log matches reality
                run.emit("prefetch", succ.name, self.cloud_tier, uris=uris)
