"""SimFabric — a deterministic, virtual-clock stand-in for the fabric.

The real fabric (broker + worker pool) resolves its nondeterminism with
wall-clock threads: whichever worker's reply frame hits its reader
thread first completes first, crashes land whenever the OS kills a
process, and ship timeouts fire on real seconds. ``emcheck``'s
schedule-space explorer (``repro_torch.analysis.explorer``) needs those same
decision points made *explicit and replayable* instead: every "which
in-flight completion lands first / which worker crashes / which ship
times out" choice is a value an explorer picks, not an accident of
thread timing.

``SimFabric`` is that seam. It models exactly the fabric state the
runtime's scheduler can observe — lane slot occupancy, the in-flight
task set, per-task attempt counts, bounded fault budgets — on a virtual
clock that advances one tick per decision. It executes nothing: the
explorer owns step semantics (stores, memo, events) and calls
``dispatch`` / ``complete`` / ``crash`` / ``timeout`` / ``preempt`` in
whatever order its schedule dictates. Identical decision sequences
therefore produce identical states, which is what makes a recorded
``Schedule`` a deterministic reproducer.

Fault semantics mirror the broker's: a ``crash`` burns one of the
task's retry attempts (the broker requeues in-flight work on worker
death and the runtime's lane retries internally, so no new ``dispatch``
event is observed); a ``timeout``/``preempt`` requeues without burning
an attempt (the ``ShipTimeout``-harvest / spot-reclaim shape). A task
whose attempts exceed its budget is the fabric's ``WorkerLostError``:
the step fails.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

OFFLOAD = "offload"
LOCAL = "local"


class SimClock:
    """Virtual time: one tick per scheduler decision. Monotonic and
    identical across replays of the same decision sequence."""

    def __init__(self):
        self.t = 0.0

    def tick(self) -> float:
        self.t += 1.0
        return self.t

    def now(self) -> float:
        return self.t


@dataclass
class SimTask:
    """One in-flight (run, step) occupying a lane slot."""
    run_id: str
    step: str
    lane: str                        # OFFLOAD | LOCAL
    retries: int                     # crash budget before the step fails
    attempts: int = 0                # crashes absorbed so far
    dispatched_t: float = 0.0
    # memoization linkage (maintained by the explorer): a waiter's
    # completion is gated on its owner's completion
    wait_key: Optional[str] = None
    memo_hit: bool = False

    @property
    def key(self) -> Tuple[str, str]:
        return (self.run_id, self.step)


class SimFabric:
    """Deterministic lane + in-flight bookkeeping for the explorer.

    ``offload_slots``/``local_slots`` mirror the runtime's two lane
    pools. ``max_crashes``/``max_timeouts``/``max_preempts`` bound the
    fault-injection decision space (0 = that fault kind is never an
    enabled decision), keeping exhaustive exploration finite.
    """

    def __init__(self, clock: SimClock, *, offload_slots: int = 2,
                 local_slots: int = 1, max_crashes: int = 0,
                 max_timeouts: int = 0, max_preempts: int = 0):
        self.clock = clock
        self.slots = {OFFLOAD: offload_slots, LOCAL: local_slots}
        self.busy = {OFFLOAD: 0, LOCAL: 0}
        self.crashes_left = max_crashes
        self.timeouts_left = max_timeouts
        self.preempts_left = max_preempts
        # dispatch order == completion-decision enumeration order; a
        # dict keyed by (run, step) keeps lookups O(1) and iteration
        # deterministic (insertion order)
        self._inflight: Dict[Tuple[str, str], SimTask] = {}

    # ------------------------------------------------------------- queries
    def free(self, lane: str) -> int:
        return self.slots[lane] - self.busy[lane]

    def inflight(self) -> List[SimTask]:
        return list(self._inflight.values())

    def task(self, run_id: str, step: str) -> Optional[SimTask]:
        return self._inflight.get((run_id, step))

    def idle(self) -> bool:
        return not self._inflight

    # ------------------------------------------------------------ mutation
    def dispatch(self, run_id: str, step: str, lane: str,
                 retries: int = 2) -> SimTask:
        assert self.free(lane) > 0, f"no free {lane} slot"
        t = SimTask(run_id, step, lane, retries,
                    dispatched_t=self.clock.now())
        self._inflight[t.key] = t
        self.busy[lane] += 1
        return t

    def complete(self, run_id: str, step: str) -> SimTask:
        t = self._inflight.pop((run_id, step))
        self.busy[t.lane] -= 1
        return t

    def crash(self, run_id: str, step: str) -> bool:
        """Worker death under the task. Returns True when the broker's
        requeue absorbs it (attempt burned, task still in flight) and
        False when the attempt budget is exhausted (the step fails and
        leaves the fabric)."""
        assert self.crashes_left > 0
        self.crashes_left -= 1
        t = self._inflight[(run_id, step)]
        t.attempts += 1
        if t.attempts <= t.retries:
            return True
        self._inflight.pop(t.key)
        self.busy[t.lane] -= 1
        return False

    def timeout(self, run_id: str, step: str) -> None:
        """Ship timeout: the task is harvested and retried in place —
        no attempt burned (the broker cancelled a queued ship or kept
        the in-flight one harvestable)."""
        assert self.timeouts_left > 0
        self.timeouts_left -= 1

    def preempt(self, run_id: str, step: str) -> None:
        """Spot-style reclaim of the worker under the task; the lease
        revocation requeues the step without burning an attempt."""
        assert self.preempts_left > 0
        self.preempts_left -= 1

    def drop_run(self, run_id: str) -> List[SimTask]:
        """A failing run drains: its in-flight tasks leave the fabric
        without completing (their dones are legitimately lost)."""
        dropped = [t for t in self._inflight.values()
                   if t.run_id == run_id]
        for t in dropped:
            self._inflight.pop(t.key)
            self.busy[t.lane] -= 1
        return dropped

    # ----------------------------------------------------------- identity
    def state_key(self) -> tuple:
        """Canonical hashable fabric state (time-independent) for the
        explorer's visited-state dedup."""
        return (tuple(sorted(
                    (k, t.attempts, t.wait_key, t.memo_hit)
                    for k, t in self._inflight.items())),
                self.busy[OFFLOAD], self.busy[LOCAL],
                self.crashes_left, self.timeouts_left, self.preempts_left)
