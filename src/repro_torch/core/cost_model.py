"""Roofline cost model for offload decisions (beyond-paper feature).

The paper decides offloading purely by developer annotation and lists
"offloading decisions" as an open issue. This model estimates, per step and
tier:

    t_exec(step, tier)  = max(flops / peak_flops, bytes / hbm_bw)
    t_move(n, src, dst) = latency + n / bw(src, dst)

and recommends offloading a remotable step iff

    t_exec(local) > t_move(stale_in) + t_exec(cloud) + t_move(results_back)

where ``stale_in`` counts ONLY input bytes whose latest version is not
already resident on the target tier — exactly the saving MDSS exists to
create (paper §3.4: task-code-only transfer when data is fresh).

Step FLOP/byte statistics come from two sources, best-first:
  1. measured EMA of past executions on a tier (runtime feedback),
  2. developer hints on the Step (``flops_hint`` / ``bytes_hint``).
(The reference also reads XLA's cost analysis; steps here run eagerly and
nothing fills ``StepStats.flops`` but the hints.)

Link bandwidth likewise prefers measurement over constants: the offload
fabric's RPCTransport reports every real transfer via
``observe_bandwidth`` and ``transfer_time`` uses that EMA when present,
falling back to the tier's static link table otherwise. Samples are
keyed **per direction** — large fabric ships report the request and
reply legs separately (worker-measured receive time vs the remainder),
so an asymmetric up/down WAN link shows up as different
``measured_bw[(local, cloud)]`` and ``measured_bw[(cloud, local)]``
entries and ``placement_cost`` charges each stale input at the
bandwidth of the link it would actually cross, in the direction it
would cross it.

Staleness is content-aware: ``MDSS.staleness`` counts only chunks not
already resident at the destination tier (dedup by digest), so
``placement_cost`` charges only *non-resident, non-duplicate* bytes —
staging a value whose content another namespace already holds there is
modeled (and shipped) as free.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.tiers import Tier


@dataclass
class StepStats:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    measured_s: Dict[str, float] = field(default_factory=dict)  # tier -> EMA

    def observe(self, tier: str, seconds: float, alpha: float = 0.5):
        prev = self.measured_s.get(tier)
        self.measured_s[tier] = seconds if prev is None else (
            alpha * seconds + (1 - alpha) * prev)


class CostModel:
    def __init__(self, tiers: Dict[str, Tier]):
        self.tiers = tiers
        self.stats: Dict[str, StepStats] = {}
        # observed wire bandwidth per (src, dst), EMA bytes/s — fed by the
        # fabric's RPCTransport; overrides the static link constants
        self.measured_bw: Dict[Tuple[str, str], float] = {}

    def stats_for(self, step_name: str) -> StepStats:
        return self.stats.setdefault(step_name, StepStats())

    def observe_bandwidth(self, src: str, dst: str, nbytes: float,
                          seconds: float, alpha: float = 0.5):
        """Record a real transfer (``nbytes`` moved in ``seconds``)."""
        if seconds <= 0 or nbytes <= 0:
            return
        bw = nbytes / seconds
        prev = self.measured_bw.get((src, dst))
        self.measured_bw[(src, dst)] = bw if prev is None else (
            alpha * bw + (1 - alpha) * prev)

    # ------------------------------------------------------------- estimates
    def exec_time(self, step, tier_name: str) -> float:
        tier = self.tiers[tier_name]
        st = self.stats_for(step.name)
        if tier_name in st.measured_s:
            return st.measured_s[tier_name]
        flops = st.flops or step.flops_hint
        byts = st.bytes_accessed or step.bytes_hint
        if not flops and not byts:
            # unmeasured fan-out shard: 1/N of whatever the un-expanded
            # parent step has measured or estimated (a prior non-fanned
            # run, or per-shard stats of a different width) — keeps cpl
            # priorities and fair-share charges meaningful on the first
            # sharded run
            if getattr(step, "fanout_role", "") == "shard" \
                    and step.fanout_parent and step.fanout_shards > 0:
                pst = self.stats.get(step.fanout_parent)
                if pst is not None:
                    parent_est = pst.measured_s.get(tier_name) or max(
                        pst.flops / tier.peak_flops,
                        pst.bytes_accessed / tier.hbm_bw)
                    if parent_est > 0:
                        return parent_est / step.fanout_shards
            return 0.0  # unknown -> neutral
        return max(flops / tier.peak_flops, byts / tier.hbm_bw)

    def transfer_time(self, nbytes: float, src: str, dst: str) -> float:
        if src == dst or nbytes == 0:
            return 0.0
        tier = self.tiers[src]
        bw = self.measured_bw.get((src, dst)) or tier.bw_to(dst)
        return tier.link_latency_s + nbytes / bw

    def placement_cost(self, step, tier_name: str, staleness=()) -> float:
        """Locality-aware per-tier score: ``est_exec(tier)`` plus the
        modeled transfer of every input byte NOT already resident there.
        ``staleness`` is ``MDSS.staleness`` output — ``(uri, src_tier,
        nbytes)`` triples — so each stale input is charged at the
        bandwidth of the link it would actually cross."""
        t = self.exec_time(step, tier_name)
        for _, src, n in staleness:
            if src != tier_name:
                t += self.transfer_time(n, src, tier_name)
        return t

    def offload_benefit(self, step, *, stale_in_bytes: float,
                        result_bytes: float, src: str = "local",
                        dst: str = "cloud") -> float:
        """Seconds saved by offloading (negative -> keep local)."""
        t_local = self.exec_time(step, src)
        t_remote = (self.transfer_time(stale_in_bytes, src, dst)
                    + self.exec_time(step, dst)
                    + self.transfer_time(result_bytes, dst, src))
        return t_local - t_remote

    def should_offload(self, step, **kw) -> bool:
        return self.offload_benefit(step, **kw) > 0.0
