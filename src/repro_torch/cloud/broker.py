"""Task broker: queues offloads, dispatches to workers, survives crashes.

The broker is the cloud-side "service" of the paper's Emerald: it owns a
priority task queue (higher ``priority`` classes dispatch first, FIFO
within a class — an interactive run's tasks overtake a batch run's), a
dispatcher thread that pairs queued tasks with idle workers the moment
either appears (condition-variable driven, no polling), one reader
thread per worker socket, and a monitor thread that watches heartbeats /
process liveness. Failure semantics:

  * a worker that dies (socket EOF, process exit, stale heartbeat) has
    its in-flight task **requeued at the front** with the dead worker
    excluded, up to ``max_attempts`` total placements — after that the
    task's future gets ``WorkerLostError``;
  * a clean remote exception comes back as ``RemoteStepError`` (the
    worker survives and returns to the idle set);
  * dead workers are replaced by default so capacity holds steady; the
    autoscaler owns deliberate scale-up/down on top of that.

Byte accounting: every framed message in either direction is counted,
and ``ship`` round-trips (pure data movement, no compute) produce
bandwidth samples — the observed-wire-bandwidth feed for the cost model.
"""
from __future__ import annotations

import pickle
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

from concurrent.futures import Future

from repro_torch.cloud.pool import WorkerHandle, WorkerPool
from repro_torch.cloud.wire import (ChannelStore, WireError, plan_msg,
                                    recv_msg, send_msg)
from repro_torch.obs.tracing import Tracer, wall_now


class FabricError(RuntimeError):
    """Base class for fabric-side task failures."""


class RemoteStepError(FabricError):
    """The step fn raised inside the worker (worker survived)."""


class WorkerLostError(FabricError):
    """The task's worker died and the requeue budget is exhausted."""


class ShipTimeout(FabricError):
    """``ship`` did not complete within its timeout. ``task`` carries the
    handle the old API swallowed: when the ship was still queued it has
    been cancelled (removed from the queue, future failed with
    ``FabricError``); when already in flight the worker will still reply,
    and ``task.result()`` / ``task.done()`` harvest it — the result no
    longer lands in a dead inbox."""

    def __init__(self, msg: str, task: "Task"):
        super().__init__(msg)
        self.task = task


@dataclass
class Task:
    task_id: int
    kind: str                       # "task" | "ship"
    step: Optional[str] = None      # registry name
    fn_bytes: Optional[bytes] = None
    kwargs: Optional[dict] = None
    value: Any = None               # ship payload
    priority: int = 0               # dispatch class; higher preempts queue
    trace_ctx: Any = None           # (trace_id, span_id) to propagate over
                                    # the wire; worker phases parent to it
    max_attempts: int = 3
    attempts: int = 0               # placements so far
    # the serving front door may checkpoint-abort this task in flight
    # (worker killed, task requeued attempt-free) to protect an
    # interactive tenant's SLO; only long batch steps should opt in
    preemptible: bool = False
    preempted: int = 0              # times aborted-and-requeued for SLO
    exclude: Set[str] = field(default_factory=set)
    future: Future = field(default_factory=Future)
    # filled in by dispatch/completion
    bytes_sent: int = 0
    bytes_received: int = 0
    seconds: float = 0.0
    worker_pid: int = 0
    # per-direction split of ``seconds`` (worker-reported request receive
    # time vs the remainder after compute) — feeds asymmetric-link
    # bandwidth observation; 0.0 when the worker predates the field
    up_s: float = 0.0
    down_s: float = 0.0
    _send_t: float = 0.0

    def result(self, timeout: Optional[float] = None):
        return self.future.result(timeout)

    # non-blocking harvest for completion-queue consumers (benchmark
    # drivers, autoscaler probes, bulk submitters): poll or subscribe
    # instead of parking a thread per task. The executor's offload lanes
    # deliberately stay blocking — each lane owns one step's retry /
    # speculation lifecycle end to end.
    def done(self) -> bool:
        return self.future.done()

    def add_done_callback(self, fn):
        """``fn(task)`` runs as soon as the task resolves (result OR
        error), on the broker's reader thread — keep it short."""
        self.future.add_done_callback(lambda _f: fn(self))


class Broker:
    #: failsafe re-check interval for the dispatch loop's condition
    #: wait — bounds how long a lost wakeup can delay noticing
    #: ``_closed`` (teardown), without putting a polling floor under
    #: normal dispatch latency (every real state change still notifies)
    _FAILSAFE_WAKEUP_S = 1.0

    def __init__(self, pool: WorkerPool, *, max_attempts: int = 3,
                 heartbeat_timeout_s: float = 5.0, replace_dead: bool = True,
                 dedup: bool = True):
        self.pool = pool
        self.max_attempts = max_attempts
        # content-addressed dedup on every worker socket: repeated chunks
        # (warm params staged again, echoed ship payloads) cross as digest
        # references. Must match the pool's worker-side setting.
        self.dedup = dedup
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.replace_dead = replace_dead
        self._cond = threading.Condition()
        self._queue: List[Task] = []
        self._workers: Dict[str, WorkerHandle] = {}
        self._inflight: Dict[str, Task] = {}
        self._task_counter = 0
        self._closed = False
        # counters (all mutated under self._cond)
        self.tasks_done = 0
        self.tasks_requeued = 0
        self.tasks_cancelled = 0
        self.tasks_preempted = 0
        self.workers_lost = 0
        self.warm_hits = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self._bw_ema: Optional[float] = None       # bytes/s from ship ops
        self._task_s_ema: Optional[float] = None   # seconds per task
        # disabled by default; a runtime's attach_fabric swaps in its
        # live tracer so worker-reported phases become spans
        self.tracer = Tracer(enabled=False)
        self._threads: List[threading.Thread] = []
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True, name="fabric-dispatch")
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="fabric-monitor")
        self._dispatcher.start()
        self._monitor.start()

    # ----------------------------------------------------------- submission
    def submit(self, *, step: Optional[str] = None,
               fn_bytes: Optional[bytes] = None, kwargs: Optional[dict] = None,
               value: Any = None, kind: str = "task",
               max_attempts: Optional[int] = None, priority: int = 0,
               trace_ctx=None, preemptible: bool = False) -> Task:
        if kind == "task" and not step and fn_bytes is None:
            raise FabricError("task needs a registry step name or fn_bytes")
        with self._cond:
            if self._closed:   # checked under the lock: a task enqueued
                raise FabricError("broker is shut down")   # mid-shutdown
            self._task_counter += 1
            t = Task(self._task_counter, kind, step=step, fn_bytes=fn_bytes,
                     kwargs=kwargs, value=value, priority=priority,
                     trace_ctx=trace_ctx, preemptible=preemptible,
                     max_attempts=max_attempts or self.max_attempts)
            self._queue.append(t)
            self._cond.notify_all()
        return t

    def ship(self, value, timeout: Optional[float] = 60.0) -> Task:
        """Round-trip ``value`` through a worker; returns the completed
        task (``.value`` result, ``.bytes_sent/received``, ``.seconds``).

        On timeout the task is handled explicitly instead of silently
        swallowed: a still-queued ship is **cancelled** (no worker ever
        wastes a slot on it), an in-flight ship stays harvestable via the
        :class:`ShipTimeout` exception's ``task`` — either way no orphan
        result can land in a dead inbox.
        """
        from concurrent.futures import TimeoutError as _FutTimeout
        t = self.submit(kind="ship", value=value)
        try:
            t.value = t.result(timeout)
        except (_FutTimeout, TimeoutError):
            if self.cancel(t):
                raise ShipTimeout(
                    f"ship {t.task_id} timed out after {timeout}s while "
                    "queued; cancelled", t) from None
            raise ShipTimeout(
                f"ship {t.task_id} timed out after {timeout}s in flight; "
                "harvest .task.result() when the worker replies", t) \
                from None
        return t

    def cancel(self, task: Task) -> bool:
        """Withdraw a still-queued task (its future fails with
        ``FabricError``). Returns False when the task already dispatched
        to a worker (or finished) — in-flight work is not interrupted."""
        with self._cond:
            if task not in self._queue:
                return False
            self._queue.remove(task)
            self.tasks_cancelled += 1
        task.future.set_exception(
            FabricError(f"task {task.task_id} cancelled"))
        return True

    def preempt_longest(self) -> Optional[Task]:
        """Checkpoint-abort the longest-running preemptible in-flight
        task: its worker is killed (the spot-reclaim shape the requeue
        machinery already survives) and the task returns to the **front**
        of the queue with its placement attempt refunded — preemption is
        an SLO decision, not a task failure, so it must never consume the
        retry budget (H126). Returns the preempted task, or None when
        nothing in flight is preemptible."""
        with self._cond:
            victims = [(wid, t) for wid, t in self._inflight.items()
                       if t.preemptible and t.kind == "task"]
            if not victims:
                return None
            wid, task = min(victims, key=lambda wt: wt[1]._send_t)
            h = self._workers.get(wid)
            if h is None:
                return None
            # take the worker out of the tables here so the reader
            # thread's exit path (_on_worker_death) early-returns instead
            # of double-requeueing the task or burning its attempt
            h.state = "dead"
            del self._workers[wid]
            del self._inflight[wid]
            task.attempts -= 1          # refund the dispatch-time burn
            task.preempted += 1
            task.exclude.discard(wid)
            self.tasks_preempted += 1
            self.tasks_requeued += 1
            self._queue.insert(0, task)
            replace = self.replace_dead and not self._closed
            self._cond.notify_all()
        self.pool.kill(h)
        if replace:
            try:
                self.add_worker()
            except Exception:
                pass   # pool closed mid-shutdown
        return task

    # -------------------------------------------------------------- workers
    def add_worker(self) -> str:
        """Revive a warm worker if one exists, else spawn a fresh process."""
        with self._cond:
            warm = [h for h in self._workers.values() if h.state == "warm"]
            if warm:
                h = min(warm, key=lambda w: w.warm_since)
                h.state = "idle"
                self.warm_hits += 1
                self._cond.notify_all()
                return h.worker_id
        h = self.pool.spawn()
        h.store = ChannelStore() if self.dedup else None
        h.reader = threading.Thread(target=self._reader_loop, args=(h,),
                                    daemon=True, name=f"fabric-read-{h.worker_id}")
        with self._cond:
            self._workers[h.worker_id] = h
            self._cond.notify_all()
        h.reader.start()
        return h.worker_id

    def start_workers(self, n: int):
        """Bring up ``n`` workers; cold-starts run concurrently."""
        if n <= 0:
            return
        if n == 1:
            self.add_worker()
            return
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=n) as tp:
            list(tp.map(lambda _: self.add_worker(), range(n)))

    def retire_worker(self) -> Optional[str]:
        """Park one idle worker as warm (not dispatched to, process kept
        alive for cheap revival). Returns its id, or None if none idle."""
        with self._cond:
            for h in self._workers.values():
                if h.state == "idle":
                    h.state = "warm"
                    h.warm_since = time.monotonic()
                    return h.worker_id
        return None

    def reap_warm(self, ttl_s: float) -> int:
        """Kill warm workers parked longer than ``ttl_s``; returns count."""
        now = time.monotonic()
        with self._cond:
            doomed = [h for h in self._workers.values()
                      if h.state == "warm" and now - h.warm_since >= ttl_s]
            for h in doomed:
                h.state = "dead"
                del self._workers[h.worker_id]
        for h in doomed:
            self.pool.kill(h)
        return len(doomed)

    # ---------------------------------------------------------------- stats
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def num_workers(self, include_warm: bool = False) -> int:
        with self._cond:
            return sum(1 for h in self._workers.values()
                       if h.state in ("idle", "busy")
                       or (include_warm and h.state == "warm"))

    def idle_workers(self) -> int:
        with self._cond:
            return sum(1 for h in self._workers.values() if h.state == "idle")

    def inflight(self) -> int:
        with self._cond:
            return len(self._inflight)

    def worker_pids(self) -> List[int]:
        with self._cond:
            return [h.pid for h in self._workers.values()
                    if h.state != "dead"]

    def harvest(self, tasks) -> tuple:
        """Non-blocking completion sweep: partition ``tasks`` into
        (finished, pending) without waiting on any of them."""
        finished, pending = [], []
        for t in tasks:
            (finished if t.done() else pending).append(t)
        return finished, pending

    def dedup_stats(self) -> dict:
        """Aggregate chunk-dedup effectiveness across live worker
        channels (dead workers' per-connection stores are gone with
        their sockets)."""
        agg = {"dedup_chunks": 0, "saved_bytes": 0, "sent_bytes_held": 0,
               "received_bytes_held": 0, "evicted": 0}
        with self._cond:
            stores = [h.store for h in self._workers.values()
                      if h.store is not None]
        for st in stores:
            s = st.stats()
            for k in agg:
                agg[k] += s[k]
        return agg

    def register_metrics(self, registry):
        """Expose every broker counter — including the previously
        orphaned ``tasks_cancelled`` — plus live queue/worker gauges and
        wire dedup effectiveness in a metrics registry."""
        registry.gauge("broker.queue_depth", self.queue_depth)
        registry.gauge("broker.inflight", self.inflight)
        registry.gauge("broker.num_workers", self.num_workers)
        registry.gauge("broker.num_workers_with_warm",
                       lambda: self.num_workers(include_warm=True))
        registry.gauge("broker.idle_workers", self.idle_workers)
        registry.gauge("broker.tasks_done", lambda: self.tasks_done)
        registry.gauge("broker.tasks_requeued", lambda: self.tasks_requeued)
        registry.gauge("broker.tasks_cancelled",
                       lambda: self.tasks_cancelled)
        registry.gauge("broker.tasks_preempted",
                       lambda: self.tasks_preempted)
        registry.gauge("broker.workers_lost", lambda: self.workers_lost)
        registry.gauge("broker.warm_hits", lambda: self.warm_hits)
        registry.gauge("wire.bytes_sent", lambda: self.bytes_sent)
        registry.gauge("wire.bytes_received", lambda: self.bytes_received)
        registry.gauge("wire.dedup_saved_bytes",
                       lambda: self.dedup_stats()["saved_bytes"])
        registry.gauge("wire.dedup_chunks",
                       lambda: self.dedup_stats()["dedup_chunks"])
        registry.gauge("wire.dedup_hit_rate", self._dedup_hit_rate)

    def _dedup_hit_rate(self) -> Optional[float]:
        """Fraction of logical payload bytes dedup kept off the wire."""
        saved = self.dedup_stats()["saved_bytes"]
        with self._cond:
            sent = self.bytes_sent
        total = sent + saved
        return (saved / total) if total else None

    def observed_bandwidth(self) -> Optional[float]:
        """EMA bytes/sec from ship round-trips; None before any sample."""
        return self._bw_ema

    def avg_task_seconds(self) -> Optional[float]:
        return self._task_s_ema

    # ------------------------------------------------------------- dispatch
    def _dispatch_loop(self):
        while True:
            with self._cond:
                task = worker = None
                while not self._closed:
                    idle = [h for h in self._workers.values()
                            if h.state == "idle"]
                    if self._queue and idle:
                        # highest priority class first, FIFO within a
                        # class (requeued tasks sit at the queue front of
                        # their class); skip tasks whose only candidates
                        # are excluded (dead-worker history). The scan
                        # stops at the first placeable task of the top
                        # class present, so a deep single-class queue
                        # dispatches in O(1) candidate checks, not O(n).
                        best = None
                        top = max(t.priority for t in self._queue)
                        for i, t in enumerate(self._queue):
                            cands = [h for h in idle
                                     if h.worker_id not in t.exclude]
                            if cands and (best is None
                                          or t.priority > best[1].priority):
                                best = (i, t, cands[0])
                                if t.priority >= top:
                                    break
                        if best is not None:
                            task, worker = best[1], best[2]
                            del self._queue[best[0]]
                    if task is not None:
                        break
                    # every state change that could make work
                    # dispatchable (submit, worker idle/added, death,
                    # shutdown) notify_alls this condition, so the
                    # timeout is a shutdown failsafe only: if a wakeup
                    # is ever lost, the predicate is re-checked at 1 Hz
                    # instead of wedging close() forever — dispatch
                    # latency still has no polling floor
                    self._cond.wait(timeout=self._FAILSAFE_WAKEUP_S)
                if self._closed:
                    return
                worker.state = "busy"
                worker.current = task
                self._inflight[worker.worker_id] = task
                task.attempts += 1
            msg = {"op": task.kind, "task_id": task.task_id}
            if task.trace_ctx is not None and self.tracer.enabled:
                # span context rides the task frame header — the worker
                # echoes it back with its phase timings
                msg["trace"] = tuple(task.trace_ctx)
            if task.kind == "ship":
                msg["value"] = task.value
            else:
                msg["step"] = task.step
                msg["fn"] = task.fn_bytes
                msg["kwargs"] = task.kwargs
            plan = plan_msg(msg, worker.store)
            # stamp BEFORE sending: a fast loopback reply may reach the
            # reader thread while sendall is still returning. plan_msg has
            # already marked its chunks in the worker's store, so a failed
            # send MUST kill the worker (mirrored stores would desync).
            with self._cond:
                task.bytes_sent = plan.nbytes
                self.bytes_sent += plan.nbytes
            task._send_t = time.perf_counter()
            try:
                plan.send(worker.sock)
            except OSError:
                self._on_worker_death(worker)

    # --------------------------------------------------------------- reader
    def _reader_loop(self, h: WorkerHandle):
        while True:
            try:
                msg, n = recv_msg(h.sock, h.store)
            except (EOFError, OSError, WireError):
                # WireError = corrupted frame or desynced dedup stores:
                # the stream is unrecoverable, treat it as a dead worker
                # (in-flight task requeues elsewhere)
                break
            op = msg.get("op")
            if op == "heartbeat":
                h.last_heartbeat = time.monotonic()
                continue
            if op not in ("result", "error"):
                continue
            h.last_heartbeat = time.monotonic()
            with self._cond:
                task = self._inflight.pop(h.worker_id, None)
                h.current = None
                if h.state == "busy":
                    h.state = "idle"
                self.bytes_received += n
                if task is not None:
                    task.bytes_received = n
                    task.seconds = time.perf_counter() - task._send_t
                    task.worker_pid = h.pid
                    # per-direction attribution: the worker measured how
                    # long the request took to arrive and how long it
                    # computed; the remainder is the reply's transfer
                    task.up_s = float(msg.get("req_recv_s") or 0.0)
                    work_s = float(msg.get("work_s") or 0.0)
                    task.down_s = max(task.seconds - task.up_s - work_s, 0.0)
                    if op == "result":
                        self.tasks_done += 1
                        if task.kind == "ship" and task.seconds > 0:
                            bw = ((task.bytes_sent + n) / task.seconds)
                            self._bw_ema = bw if self._bw_ema is None else \
                                0.5 * bw + 0.5 * self._bw_ema
                        elif task.kind == "task":
                            s = task.seconds
                            self._task_s_ema = s if self._task_s_ema is None \
                                else 0.5 * s + 0.5 * self._task_s_ema
                self._cond.notify_all()
            if task is not None:
                self._materialize_worker_spans(task, msg, h)
                if op == "result":
                    task.future.set_result(msg.get("value"))
                else:
                    task.future.set_exception(RemoteStepError(
                        msg.get("traceback") or msg.get("error", "remote error")))
        if not self._closed:
            self._on_worker_death(h)

    def _materialize_worker_spans(self, task: Task, msg: dict,
                                  h: WorkerHandle):
        """Turn the worker's reported phase timings into spans parented
        under the driver-side span whose ctx rode the request frame,
        plus a synthesized ``send`` span for the reply transfer (measured
        driver-side as ``down_s``). Worker wall clocks place the phases
        on the shared epoch timeline; their durations are monotonic."""
        if task.trace_ctx is None or not self.tracer.enabled:
            return
        trace_id, parent_id = task.trace_ctx
        track = f"worker:{h.pid}"
        for ph in msg.get("spans") or ():
            try:
                self.tracer.add_span(
                    trace_id, str(ph["name"]), float(ph["t0"]),
                    float(ph["dur"]), parent_id=parent_id, cat="worker",
                    track=track, pid=h.pid, task_id=task.task_id,
                    step=task.step or "")
            except (KeyError, TypeError, ValueError):
                continue    # malformed phase from an old/foreign worker
        if task.down_s > 0:
            self.tracer.add_span(
                trace_id, "send", wall_now() - task.down_s, task.down_s,
                parent_id=parent_id, cat="worker", track=track, pid=h.pid,
                task_id=task.task_id)

    # ---------------------------------------------------------------- death
    def _on_worker_death(self, h: WorkerHandle):
        with self._cond:
            if h.state == "dead" or h.worker_id not in self._workers:
                return
            h.state = "dead"
            del self._workers[h.worker_id]
            self.workers_lost += 1
            task = self._inflight.pop(h.worker_id, None)
            failed = None
            if task is not None:
                task.exclude.add(h.worker_id)
                if task.attempts >= task.max_attempts:
                    failed = task
                else:
                    self.tasks_requeued += 1
                    self._queue.insert(0, task)
            replace = self.replace_dead and not self._closed
            self._cond.notify_all()
        self.pool.kill(h)
        if failed is not None:
            failed.future.set_exception(WorkerLostError(
                f"worker pid={h.pid} died running task {failed.task_id} "
                f"(attempt {failed.attempts}/{failed.max_attempts})"))
        if replace:
            try:
                self.add_worker()
            except Exception:
                pass   # pool closed mid-shutdown

    # -------------------------------------------------------------- monitor
    def _monitor_loop(self):
        while not self._closed:
            time.sleep(min(0.25, self.heartbeat_timeout_s / 4))
            now = time.monotonic()
            with self._cond:
                handles = list(self._workers.values())
            for h in handles:
                if h.state == "dead":
                    continue
                if h.proc.poll() is not None or \
                        now - h.last_heartbeat > self.heartbeat_timeout_s:
                    self._on_worker_death(h)

    # ------------------------------------------------------------- shutdown
    def shutdown(self):
        with self._cond:
            if self._closed:
                return
            self._closed = True
            pending = list(self._queue) + list(self._inflight.values())
            self._queue.clear()
            self._inflight.clear()
            handles = list(self._workers.values())
            self._workers.clear()
            self._cond.notify_all()
        for t in pending:
            if not t.future.done():
                t.future.set_exception(FabricError("broker shut down"))
        for h in handles:
            try:
                send_msg(h.sock, {"op": "shutdown"})
            except OSError:
                pass
            self.pool.kill(h)
        self.pool.close()
