"""Offload scheduling policies.

The paper's Emerald offloads every annotated step ("annotate"); its future
work calls for smarter decisions. The executor delegates the per-step
choice to a policy object so new strategies slot in without touching the
runtime:

  * ``AnnotatePolicy``   — paper-faithful: remotable => offload.
  * ``NeverPolicy``      — the paper's baseline arm (offloading disabled).
  * ``CostModelPolicy``  — beyond-paper: offload iff the roofline cost
    model predicts net benefit, accounting for MDSS-stale input bytes
    (so a step whose data is already cloud-resident offloads more eagerly
    — the scheduler and MDSS reinforce each other).
  * ``LocalityPolicy``   — beyond-paper: data-locality-aware placement.
    Every candidate tier is scored ``est_exec(tier) + est_transfer(bytes
    not already resident on tier)`` (``MDSS.staleness`` supplies the
    per-input source tier and size) and the cheapest tier wins — a step
    whose inputs are warm on the cloud offloads even when raw compute
    favours local, and a step whose inputs live locally stays home even
    when the cloud is the faster chip. Unlike ``CostModelPolicy`` the
    local side is charged for staging too: residency-blind comparison
    treats locally-stale cloud-warm data as free to read, which is
    exactly the placement mistake Juve et al. measured on EC2.
    ``place()`` returns the full :class:`PlacementDecision` (scores,
    stale bytes, reason) that the runtime exposes in step events.

Transfer-time estimates use *observed* wire bandwidth when the offload
fabric is attached: every RPCTransport ship feeds
``CostModel.observe_bandwidth`` and ``CostModel.transfer_time`` prefers
that EMA over the static ``DCN_BW`` link constant, so offload decisions
track what the wire actually delivers.

Policies also carry a **dispatch-priority hook** for the event-driven
executor: when more steps are ready than workers, higher-priority steps
dispatch first. The default ordering is critical-path-length-first
(``critical_path_lengths``): the long pole of a wide heterogeneous DAG
starts as early as possible, which is what bounds makespan.

The multi-tenant runtime composes a **cross-run fair-share layer** on
top: when several workflows contend for the same worker lanes, each free
slot goes to the run with the smallest deficit-weighted share
(``FairShare``, stride-scheduling style), and *within* that run the
critical-path priority picks the step. Dispatch order is therefore
(deficit-weighted run share, -cpl) — one wide workflow cannot starve the
rest, and a heavier ``weight`` buys a run proportionally more slots.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Protocol

from repro_torch.core.cost_model import CostModel
from repro_torch.core.mdss import MDSS
from repro_torch.core.workflow import Step, Workflow


def critical_path_lengths(wf: Workflow, cost_model: Optional[CostModel] = None,
                          cloud_tier: str = "cloud",
                          default_cost: float = 1.0,
                          succ: Optional[Dict[str, set]] = None
                          ) -> Dict[str, float]:
    """Longest path (in estimated seconds) from each step to any sink.

    Step weight prefers the cost model's estimate (measured EMA or
    developer hints); with no estimate every step weighs
    ``default_cost`` and the priority degrades to DAG depth. Workflow
    declaration order is a topological order (all dataflow edges point
    forward), so one reverse sweep suffices. Pass a precomputed ``succ``
    (from :meth:`Workflow.successors`) to avoid rebuilding the edge map.
    """
    succ = wf.successors() if succ is None else succ
    cpl: Dict[str, float] = {}
    for s in reversed(wf.toplevel()):
        w = default_cost
        if cost_model is not None:
            est = cost_model.exec_time(s, "local")
            if cloud_tier in cost_model.tiers:
                est = max(est, cost_model.exec_time(s, cloud_tier))
            if est > 0:
                w = est
        cpl[s.name] = w + max((cpl[m] for m in succ[s.name]), default=0.0)
    return cpl


class FairShare:
    """Deficit-weighted cross-run scheduling (stride scheduling).

    Each run carries a virtual time that advances by ``cost / weight``
    whenever one of its steps is dispatched; every free worker slot goes
    to the eligible run with the smallest virtual time. A run that just
    burned many slots (a wide workflow flooding the ready set) accrues
    virtual time fast and yields to the others; a run with weight *w*
    receives ~*w*x the slots of a weight-1 run under contention.

    Not thread-safe by itself — the runtime mutates it only from its
    driver thread.
    """

    def __init__(self):
        self._vtime: Dict[str, float] = {}
        self._weight: Dict[str, float] = {}

    def add(self, run_id: str, weight: float = 1.0):
        # a newcomer starts at the current minimum, not at zero: joining
        # late must not grant a catch-up monopoly over long-running peers
        base = min(self._vtime.values(), default=0.0)
        self._weight[run_id] = max(float(weight), 1e-9)
        self._vtime[run_id] = base

    def remove(self, run_id: str):
        self._vtime.pop(run_id, None)
        self._weight.pop(run_id, None)

    def charge(self, run_id: str, cost: float = 1.0):
        """Account one dispatched step of estimated ``cost`` seconds."""
        if run_id in self._vtime:
            self._vtime[run_id] += max(cost, 1e-9) / self._weight[run_id]

    def pick(self, run_ids: Iterable[str]) -> Optional[str]:
        """The eligible run owed the next slot (smallest virtual time;
        ties break deterministically by run id)."""
        best = None
        for rid in run_ids:
            key = (self._vtime.get(rid, 0.0), rid)
            if best is None or key < best[0]:
                best = (key, rid)
        return None if best is None else best[1]

    def share_of(self, run_id: str) -> float:
        return self._vtime.get(run_id, 0.0)

    def shares(self) -> Dict[str, dict]:
        """Snapshot of every run's virtual time, weight and deficit
        (vtime - min vtime: how far ahead of its fair share the run is;
        0 means it is owed the next slot). For introspection/metrics."""
        base = min(self._vtime.values(), default=0.0)
        return {rid: {"vtime": vt, "weight": self._weight.get(rid, 1.0),
                      "deficit": vt - base}
                for rid, vt in self._vtime.items()}


class OffloadPolicy(Protocol):
    def should_offload(self, step: Step) -> bool: ...

    def dispatch_priority(self, step: Step) -> float: ...


class DispatchPriorityMixin:
    """Critical-path-first dispatch ordering, shared by all policies.

    The executor seeds ``set_priorities`` with ``critical_path_lengths``;
    until then every step ties at 0.0 and dispatch falls back to workflow
    declaration order.
    """
    _priorities: Optional[Dict[str, float]] = None

    def set_priorities(self, priorities: Dict[str, float]):
        self._priorities = dict(priorities)

    def dispatch_priority(self, step: Step) -> float:
        if not self._priorities:
            return 0.0
        return self._priorities.get(step.name, 0.0)


@dataclass
class AnnotatePolicy(DispatchPriorityMixin):
    def should_offload(self, step: Step) -> bool:
        return step.remotable


@dataclass
class NeverPolicy(DispatchPriorityMixin):
    def should_offload(self, step: Step) -> bool:
        return False


@dataclass
class PlacementDecision:
    """Why a step was placed on ``tier`` — attached to dispatch events."""
    tier: str
    offload: bool
    scores: Dict[str, float]        # tier -> est_exec + est_transfer (s)
    stale_bytes: Dict[str, int]     # tier -> input bytes not resident there
    reason: str


@dataclass
class LocalityPolicy(DispatchPriorityMixin):
    """Place each step on the tier where (exec + staging) is cheapest."""
    cost_model: CostModel
    mdss: MDSS
    cloud_tier: str = "cloud"

    def _score(self, step: Step, tier: str):
        staleness = self.mdss.staleness(step.inputs, tier)
        return (self.cost_model.placement_cost(step, tier, staleness),
                sum(n for _, _, n in staleness))

    def place(self, step: Step) -> PlacementDecision:
        local_s, local_b = self._score(step, "local")
        scores = {"local": local_s}
        stale = {"local": local_b}
        if step.fanout_role in ("scatter", "gather"):
            # host-side closures over partition_fn/combine_fn: they slice
            # and reassemble on the driver's tier; the shards between
            # them are what the fabric parallelises
            return PlacementDecision("local", False, scores, stale,
                                     "fan-out scatter/gather runs local")
        if not step.remotable or self.cloud_tier not in self.cost_model.tiers:
            return PlacementDecision("local", False, scores, stale,
                                     "not remotable")
        cloud_s, cloud_b = self._score(step, self.cloud_tier)
        scores[self.cloud_tier] = cloud_s
        stale[self.cloud_tier] = cloud_b
        if cloud_s != local_s:
            offload = cloud_s < local_s
            reason = "exec+transfer score"
        elif cloud_b != local_b:
            # equal modeled seconds (often both unknown-exec): prefer the
            # tier already holding more of the data
            offload = cloud_b < local_b
            reason = "resident-bytes tie-break"
        else:
            # no signal either way: the paper's annotate default
            offload = True
            reason = "no estimates: annotate default"
        tier = self.cloud_tier if offload else "local"
        return PlacementDecision(tier, offload, scores, stale, reason)

    def should_offload(self, step: Step) -> bool:
        return self.place(step).offload


@dataclass
class CostModelPolicy(DispatchPriorityMixin):
    cost_model: CostModel
    mdss: MDSS
    cloud_tier: str = "cloud"

    def should_offload(self, step: Step) -> bool:
        if not step.remotable:
            return False
        return self.explain(step)["benefit_s"] > 0.0

    def explain(self, step: Step) -> dict:
        """Decision breakdown — which bandwidth the model used and why."""
        stale = self.mdss.stale_bytes(step.inputs, self.cloud_tier)
        benefit = self.cost_model.offload_benefit(
            step, stale_in_bytes=stale, result_bytes=step.bytes_hint or 0,
            src="local", dst=self.cloud_tier)
        return {
            "stale_in_bytes": stale,
            "benefit_s": benefit,
            "bw_bytes_per_s": self.cost_model.measured_bw.get(
                ("local", self.cloud_tier)),
            "bw_source": "observed" if ("local", self.cloud_tier)
                         in self.cost_model.measured_bw else "static",
        }


POLICIES = ("annotate", "cost_model", "never", "locality")


def make_policy(name: str, cost_model: CostModel, mdss: MDSS,
                cloud_tier: str = "cloud") -> OffloadPolicy:
    if name == "annotate":
        return AnnotatePolicy()
    if name == "never":
        return NeverPolicy()
    if name == "cost_model":
        return CostModelPolicy(cost_model, mdss, cloud_tier)
    if name == "locality":
        return LocalityPolicy(cost_model, mdss, cloud_tier)
    raise ValueError(name)
