"""Migration manager (paper §3.3): offload / execute / re-integrate.

Life-cycle for a remotable step *i* (paper's wording in quotes):

  1. the migration point "suspends the execution of the workflow" and hands
     *i* to this manager,
  2. MDSS makes *i*'s input URIs current on the target tier — if the tier
     already holds the latest versions the offload is **code-only**
     (paper §3.4), and "code" is a per-(step, tier) cache entry holding
     the step's function, so repeat offloads move nothing at all,
  3. *i* executes on the tier's device, and the manager waits for the
     device to finish before the step counts as done — or, on a
     fabric-backed tier, a registry or host step runs in a worker process,
  4. outputs are ``put`` on the executing tier and lazily synced — a
     downstream offloaded step reads them in place, the paper's key saving,
  5. the workflow resumes ("re-integration").

Execution statistics (wall time) feed the cost model for the beyond-paper
scheduling policy. Steps run eagerly: there is no compile step, and no
FLOP count is captured (the ``annotate`` policy does not read one).

Multi-tenancy: one manager serves every run of a shared runtime. The
compile cache is keyed by (step name, tier, *code fingerprint*) so the
second submission of the same workflow — same step code, typically a new
``Workflow`` object — reuses the cached executable (code-only repeat
offloads) while two tenants that happen to share a step *name* with
different code never collide. Cost-model stats stay keyed by step name
(the paper's granularity) and likewise survive across runs, so a repeat
submission is pre-measured from the first one. ``execute`` accepts a
per-run ``mdss`` view (namespace isolation) and a ``priority`` class that
rides down to the fabric broker.

Cross-run step memoization (opt-in: ``memoize=True`` on the manager /
runtime, or ``memoizable=True`` per step): an execution is keyed by
``(step code fingerprint, input content digests, output names)``. Two
tenants submitting the identical step over content-identical inputs
share ONE execution — the second publishes the first's host-snapshot
outputs into its own namespace (a fenced put, zero staging, zero wire
bytes) instead of re-running; a tenant arriving while the first is
still executing waits on it rather than racing. Only safe for
deterministic, side-effect-free steps — a memoized result is reused
whenever code and input *content* match, regardless of namespace, run,
or wall-clock; steps that read clocks, RNGs, or external state must
leave memoization off (``memoizable=False`` overrides a manager-wide
``memoize=True``).
"""
from __future__ import annotations

import pickle
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch._tree import host_copy
from repro_torch.core.cost_model import CostModel
from repro_torch.core.mdss import MDSS, nbytes_of
from repro_torch.core.tiers import Tier
from repro_torch.core.workflow import Step
from repro_torch.obs.tracing import Tracer


class StepFailure(RuntimeError):
    pass


def step_code_key(step: Step):
    """Stable identity of a step's *code* (not its enclosing workflow).

    Registry steps are identified by registry name; closure/default-free
    plain fns by (code object, globals identity) — CPython compares code
    objects by VALUE (bytecode, consts, names, location), so rebuilding
    an identical workflow in the same module for a second submission
    still hits the compile cache, while a same-named tenant step with
    different code (even two ``exec``'d bodies sharing ``<string>:1``)
    gets its own entry. Globals identity matters because equal code can
    read *different* module globals (``return x * SCALE`` under two
    modules); identical-looking fns from different global environments
    are therefore a safe miss, never a shared hit. Functions that carry
    per-object state (closures, bound methods, default args, non-plain
    callables) key by object identity outright."""
    if step.remote_impl:
        return ("registry", step.remote_impl)
    fn = step.fn
    code = getattr(fn, "__code__", None)
    stateless = (code is not None
                 and getattr(fn, "__closure__", None) is None
                 and getattr(fn, "__self__", None) is None
                 and not getattr(fn, "__defaults__", None)
                 and not getattr(fn, "__kwdefaults__", None))
    if stateless:
        return ("code", code, id(getattr(fn, "__globals__", None)))
    return ("id", id(fn))


_IMMUTABLE_CAPTURE = (int, float, complex, bool, str, bytes, frozenset,
                      tuple, type(None))


def fabric_runnable_reason(step: Step) -> Optional[str]:
    """``None`` if ``step`` could execute in a fabric worker, else a
    one-line reason. Mirrors ``Fabric.can_run`` without needing a live
    fabric, so the static verifier shares the dispatcher's judgement."""
    if getattr(step, "remote_impl", None):
        return None
    if step.fn is None:
        return "no fn and no remote_impl"
    if getattr(step, "device_step", True):
        return "device step (runs in-process on the tier's device by design)"
    try:
        pickle.dumps(step.fn)
        return None
    except Exception as exc:
        return f"fn is not picklable ({type(exc).__name__}: {exc})"


def memo_unsafe_reasons(step: Step) -> list:
    """Why memoizing ``step`` could serve stale results: state the step's
    fn reads that the memo key ``(code fingerprint, input digests,
    outputs)`` cannot see. Immutable scalar captures are fine — a closure
    keys by object identity, which pins them — but a *mutable* capture
    (list/dict/array/object) can change between calls under one key."""
    fn = step.fn
    if fn is None:
        return []
    reasons = []
    cells = getattr(fn, "__closure__", None)
    if cells:
        names = getattr(getattr(fn, "__code__", None), "co_freevars", ())
        for name, cell in zip(names, cells):
            try:
                v = cell.cell_contents
            except ValueError:      # unfilled cell
                reasons.append(f"closes over unfilled cell {name!r}")
                continue
            if not isinstance(v, _IMMUTABLE_CAPTURE):
                reasons.append(
                    f"closes over mutable {type(v).__name__} {name!r}")
    for v in (getattr(fn, "__defaults__", None) or ()):
        if not isinstance(v, _IMMUTABLE_CAPTURE):
            reasons.append(f"mutable default of type {type(v).__name__}")
    for v in (getattr(fn, "__kwdefaults__", None) or {}).values():
        if not isinstance(v, _IMMUTABLE_CAPTURE):
            reasons.append(f"mutable kw default of type {type(v).__name__}")
    if getattr(fn, "__self__", None) is not None:
        reasons.append("bound method: instance state is outside the key")
    return reasons


@dataclass
class OffloadReport:
    step: str
    tier: str
    seconds: float
    bytes_in: int
    bytes_out: int
    code_only: bool
    remote: bool = False            # executed in a fabric worker process
    worker_pid: int = 0             # pid of that worker (0 = in-process)
    fenced: bool = False            # write-back refused: a newer version
                                    # landed while this execution ran
                                    # (speculation loser / stale straggler)
    staged_s: float = 0.0           # wall time spent staging inputs — the
                                    # observed counterpart of the locality
                                    # scheduler's modeled transfer score
    memo_hit: bool = False          # reused a memoized execution: the step
                                    # fn never ran and nothing was staged


class _MemoEntry:
    """One memoized execution: in-flight until ``event`` fires, then
    either ``outputs`` (host snapshots) or ``error``. ``pin`` holds a
    strong reference to the step's fn for id-keyed code keys — without
    it a GC'd closure's recycled object id could collide a LATER,
    different function into this entry's key (the compile cache pins its
    fn the same way, implicitly, by caching it)."""
    __slots__ = ("event", "outputs", "error", "nbytes", "pin")

    def __init__(self, pin=None):
        self.event = threading.Event()
        self.outputs: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None
        self.nbytes = 0
        self.pin = pin


class MigrationManager:
    def __init__(self, tiers: Dict[str, Tier], mdss: MDSS,
                 cost_model: Optional[CostModel] = None,
                 remote_timeout_s: float = 120.0, memoize: bool = False):
        self.tiers = tiers
        self.mdss = mdss
        self.cost_model = cost_model or CostModel(tiers)
        self.remote_timeout_s = remote_timeout_s
        # cross-run memoization (see module docstring): default-off
        # manager-wide, overridable per step via Step.memoizable
        self.memoize = memoize
        self.memo_cap = 128                  # entries
        self.memo_cap_bytes = 256 << 20      # pinned host snapshots
        self._memo: "OrderedDict[Tuple, _MemoEntry]" = OrderedDict()
        self._memo_bytes = 0
        self._memo_lock = threading.Lock()
        self.memo_hits = 0
        self.memo_waits = 0
        # LRU-bounded: a long-lived runtime sees unboundedly many step
        # objects (fresh closures per tenant submission key by id), and a
        # cache entry pins its fn plus captured state — cap, don't grow
        self._compile_cache: Dict[Tuple, Any] = {}
        self._cache_lock = threading.Lock()
        self.compile_cache_cap = 1024
        self.compile_cache_hits = 0
        # bounded like the compile cache: one manager serves a long-lived
        # runtime, and an unbounded per-step report log would grow forever
        self.reports_cap = 4096
        self.reports: list[OffloadReport] = []
        # disabled by default; an owning runtime swaps in its live tracer
        # so stage/exec/install phases record under the dispatch span
        self.tracer = Tracer(enabled=False)

    def register_metrics(self, registry):
        """Expose the manager's cross-run caches in a metrics registry."""
        registry.gauge("memo.entries", lambda: len(self._memo))
        registry.gauge("memo.bytes", lambda: self._memo_bytes)
        registry.gauge("memo.hits", lambda: self.memo_hits)
        registry.gauge("memo.waits", lambda: self.memo_waits)
        registry.gauge("compile_cache.entries",
                       lambda: len(self._compile_cache))
        registry.gauge("compile_cache.hits",
                       lambda: self.compile_cache_hits)

    def memo_stats(self) -> dict:
        return {"entries": len(self._memo), "bytes": self._memo_bytes,
                "hits": self.memo_hits, "waits": self.memo_waits,
                "compile_cache_hits": self.compile_cache_hits}

    # ----------------------------------------------------------- executable
    def _executable(self, step: Step, tier_name: str):
        key = (step.name, tier_name, step_code_key(step))
        with self._cache_lock:
            cached = self._compile_cache.pop(key, None)
            if cached is not None:
                self._compile_cache[key] = cached    # LRU refresh
                self.compile_cache_hits += 1
                return cached
        fn = step.fn
        if fn is None and step.remote_impl:
            # registry-only step: resolve the same fn the workers run so
            # the local tier remains a valid fallback
            from repro_torch.cloud import tasklib
            fn = tasklib.resolve(step.remote_impl)
        if fn is None:
            raise StepFailure(f"step {step.name} has no fn or remote_impl")
        # eager execution: the cached executable is the function itself
        with self._cache_lock:
            self._compile_cache[key] = fn
            while len(self._compile_cache) > self.compile_cache_cap:
                self._compile_cache.pop(next(iter(self._compile_cache)))
        return fn

    # -------------------------------------------------------------- execute
    def execute(self, step: Step, tier_name: str, *, mdss=None,
                priority: int = 0,
                memoize: Optional[bool] = None) -> OffloadReport:
        """Run ``step`` on ``tier_name``; inputs/outputs through MDSS.

        When the tier is fabric-backed (``tier.worker_pool``) and the step
        is fabric-runnable (registry name or picklable host fn), execution
        happens in a worker OS process and the report carries the real
        bytes that crossed the wire; otherwise it runs in-process on the
        tier's device (device steps always do — their point is the card,
        not process separation).

        ``mdss`` selects the data view — a run's :class:`NamespacedMDSS`
        under the multi-tenant runtime, the shared base store otherwise.
        ``priority`` is the fabric dispatch class: the broker serves
        higher classes first, so an interactive run's tasks overtake a
        batch run's queued work.

        When the step is memoizable (manager ``memoize`` / step
        ``memoizable``) the execution is shared across runs by content
        key: a hit publishes the memoized host snapshots into THIS run's
        namespace (fenced, zero staging) and reports ``memo_hit=True``.
        ``memoize=False`` forces this one execution uncached — how a
        speculation backup races its twin for real instead of becoming a
        waiter on the twin's own in-flight memo entry.
        """
        mdss = self.mdss if mdss is None else mdss
        key = self._memo_key(step, mdss, memoize)
        if key is None:
            return self._execute_now(step, tier_name, mdss, priority)[0]
        return self._execute_memoized(step, tier_name, mdss, priority, key)

    # ---------------------------------------------------------- memoization
    def _memo_key(self, step: Step, mdss, override: Optional[bool] = None):
        on = override
        if on is None:
            on = step.memoizable if step.memoizable is not None \
                else self.memoize
        if not on or not step.outputs:
            return None
        digest = getattr(mdss, "content_digest", None)
        if digest is None:
            return None
        try:
            in_digests = tuple((u, digest(u)) for u in step.inputs)
        except KeyError:
            return None      # an input is absent: not memoizable this run
        return (step_code_key(step), in_digests, tuple(step.outputs))

    def _execute_memoized(self, step: Step, tier_name: str, mdss,
                          priority: int, key) -> "OffloadReport":
        while True:
            with self._memo_lock:
                ent = self._memo.get(key)
                owner = ent is None
                if owner:
                    ent = _MemoEntry(pin=step.fn)
                    self._memo[key] = ent
                    self._trim_memo()
            if owner:
                try:
                    rep, out = self._execute_now(step, tier_name, mdss,
                                                 priority)
                except BaseException as e:
                    with self._memo_lock:
                        if self._memo.get(key) is ent:
                            del self._memo[key]
                    ent.error = e
                    ent.event.set()
                    raise
                # host COPIES, never views: the owner's run published
                # these same arrays into its namespace and hands them to
                # its caller — a tenant mutating its fetched result must
                # not corrupt the cache (a fenced publish still computed
                # content valid for this input key, so it is kept)
                ent.outputs = {k: host_copy(v) for k, v in out.items()}
                ent.nbytes = sum(nbytes_of(v) for v in ent.outputs.values())
                with self._memo_lock:
                    if self._memo.get(key) is ent:
                        self._memo_bytes += ent.nbytes
                        self._trim_memo()
                ent.event.set()
                return rep
            # an identical execution is in flight (or done) on another
            # run: share it instead of re-running the step
            self.memo_waits += 1
            if not ent.event.wait(self.remote_timeout_s):
                # owner wedged (or a speculation twin racing itself):
                # degrade to an uncached execution, never deadlock
                return self._execute_now(step, tier_name, mdss, priority)[0]
            if ent.error is not None:
                continue     # owner failed and removed the entry: take over
            return self._publish_memoized(step, tier_name, mdss, ent)

    def _publish_memoized(self, step: Step, tier_name: str, mdss,
                          ent: _MemoEntry) -> "OffloadReport":
        fence = getattr(mdss, "fence_tokens", None)
        out_versions = fence(step.outputs) if fence is not None else \
            {k: mdss.version(k) for k in step.outputs}
        # each hit gets its own copies: N tenants sharing one execution
        # must not alias one mutable array across their namespaces
        published = mdss.put_many(
            {k: host_copy(ent.outputs[k]) for k in step.outputs},
            tier="local",
            expect_versions=out_versions)
        rep = OffloadReport(step.name, tier_name, 0.0, 0, 0,
                            code_only=True, fenced=published is None,
                            memo_hit=True)
        with self._memo_lock:
            self.memo_hits += 1
        self.reports.append(rep)
        if len(self.reports) > self.reports_cap:
            del self.reports[:len(self.reports) - self.reports_cap]
        return rep

    def _trim_memo(self):
        """Memo-lock held: drop oldest COMPLETED entries past the entry
        OR byte cap — host snapshots pin real driver memory, so the
        bound must be bytes, not just count. In-flight entries have
        waiters and are never evicted."""
        while len(self._memo) > self.memo_cap \
                or self._memo_bytes > self.memo_cap_bytes:
            for k, v in self._memo.items():
                if v.event.is_set():
                    self._memo_bytes -= v.nbytes
                    del self._memo[k]
                    break
            else:
                return

    def _execute_now(self, step: Step, tier_name: str, mdss,
                     priority: int = 0):
        tier = self.tiers[tier_name]
        uris = list(step.inputs)
        stale = mdss.stale_bytes(uris, tier_name)
        # snapshot output versions: the write-back below is fenced on them,
        # so a slow duplicate (speculation loser) can't clobber data a
        # faster twin or a downstream step has already published. A
        # namespaced view supplies (resolved key, version) tokens — a bare
        # number is ambiguous across its shared/private read boundary
        fence = getattr(mdss, "fence_tokens", None)
        out_versions = fence(step.outputs) if fence is not None else \
            {k: mdss.version(k) for k in step.outputs}
        t_stage = time.perf_counter()
        with self.tracer.span("ship", cat="data", step=step.name,
                              tier=tier_name) as shsp:
            bytes_in, kwargs = self._stage_inputs(step, tier_name, uris,
                                                  mdss)
            if shsp.ctx is not None:
                shsp.set(bytes=bytes_in)
        staged_s = time.perf_counter() - t_stage
        fabric = getattr(tier, "worker_pool", None)
        if fabric is not None and fabric.can_run(step):
            with self.tracer.span("exec", cat="exec", step=step.name,
                                  tier=tier_name, remote=True):
                out, dt, wire_in, wire_out, pid = self._execute_remote(
                    step, fabric, kwargs, priority)
            # report the worker's actual wire ingress; the MDSS staging
            # bytes remain visible in mdss.bytes_moved
            bytes_in = wire_in
            remote, worker_pid, wire_bytes_out = True, pid, wire_out
        else:
            fn = self._executable(step, tier_name)
            t0 = time.perf_counter()
            with self.tracer.span("exec", cat="exec", step=step.name,
                                  tier=tier_name, remote=False):
                out = fn(**kwargs)
                if step.device_step:
                    # kernels are queued asynchronously: wait for the
                    # device so the cost model and the exec span time the
                    # work itself
                    tier.synchronize()
            dt = time.perf_counter() - t0
            remote, worker_pid, wire_bytes_out = False, 0, 0
        if not isinstance(out, dict):
            if len(step.outputs) != 1:
                raise StepFailure(
                    f"step {step.name} returned non-dict for multiple outputs")
            out = {(step.out_names or step.outputs)[0]: out}
        if step.out_names:
            # shard steps: the fn returns its original output names;
            # publish them under this shard's uri#k outputs
            out = {u: out[n] for u, n in zip(step.outputs, step.out_names)
                   if n in out}
        missing = set(step.outputs) - set(out)
        if missing:
            raise StepFailure(f"step {step.name} missing outputs {missing}")
        # all-or-nothing fenced publish: twins can never interleave a
        # mixed set of one step's outputs
        with self.tracer.span("install", cat="data", step=step.name,
                              tier=tier_name) as insp:
            published = mdss.put_many(
                {k: out[k] for k in step.outputs}, tier=tier_name,
                expect_versions=out_versions)
            fenced = published is None
            if insp.ctx is not None:
                insp.set(fenced=fenced)
        bytes_out = 0 if fenced else sum(nbytes_of(out[k])
                                         for k in step.outputs)
        if remote and not fenced:   # a refused publish moved no output bytes
            bytes_out = wire_bytes_out
        if not fenced:
            # a fenced run is a stale straggler — its wall time must not
            # pollute the runtime EMA the speculation trigger feeds on
            self.cost_model.stats_for(step.name).observe(tier_name, dt)
        rep = OffloadReport(step.name, tier_name, dt, bytes_in, bytes_out,
                            code_only=(stale == 0 and bool(uris)),
                            remote=remote, worker_pid=worker_pid,
                            fenced=fenced, staged_s=staged_s)
        self.reports.append(rep)
        if len(self.reports) > self.reports_cap:
            del self.reports[:len(self.reports) - self.reports_cap]
        return rep, out

    def _stage_inputs(self, step: Step, tier_name: str, uris, mdss):
        """MDSS ensure + get with fabric faults (a worker dying while the
        transport ships a stale input), stuck in-flight transfers
        (``MDSSTransferError``) and vanished entries (``KeyError`` from a
        namespace dropped mid-run) mapped to StepFailure, so staging
        errors go through the executor's retry path like execution
        errors."""
        from concurrent.futures import TimeoutError as _FutTimeout
        names = step.arg_names or tuple(uris)
        if len(names) != len(uris):
            raise StepFailure(
                f"step {step.name}: arg_names has {len(names)} entries for "
                f"{len(uris)} inputs — they must be parallel")
        try:
            bytes_in = mdss.ensure(uris, tier_name)
            return bytes_in, {n: mdss.get(u, tier_name)
                              for n, u in zip(names, uris)}
        except StepFailure:
            raise
        except (RuntimeError, LookupError, _FutTimeout, TimeoutError) as e:
            raise StepFailure(
                f"step {step.name}: staging inputs on {tier_name} failed: "
                f"{e!r}") from e

    def _execute_remote(self, step: Step, fabric, kwargs, priority: int = 0):
        """Dispatch through the fabric broker; fabric faults surface as
        StepFailure so the executor's retry / tier-fallback logic applies."""
        from concurrent.futures import TimeoutError as _FutTimeout
        from repro_torch.cloud.broker import FabricError
        try:
            # the current (exec) span's identity rides the task frame
            # header to the worker — its recv/exec/send phases come back
            # in the reply and nest under this driver-side span
            task = fabric.submit_step(step, kwargs, priority=priority,
                                      trace_ctx=self.tracer.current_ctx())
            out = task.result(self.remote_timeout_s)
        except FabricError as e:
            raise StepFailure(f"fabric: {e}") from e
        except (TimeoutError, _FutTimeout) as e:
            raise StepFailure(
                f"step {step.name} timed out after {self.remote_timeout_s}s "
                "on the fabric") from e
        return (out, task.seconds, task.bytes_sent, task.bytes_received,
                task.worker_pid)
