"""Finding model + rule catalogue for Emerald's correctness tooling.

Every check in this package — static verifier rules (``W``), dynamic
sanitizer hazards (``H``) and source self-lint rules (``L``) — is
registered here with a stable id, default severity, one-line title and a
fix hint. A check reports a :class:`Finding` referencing its rule id, so
consumers (``submit(validate=...)``, ``scripts/emlint.py``, the defect
corpus under ``tests/defects/``) can match on ids instead of message
text.

Severities:

  * ``error``   — the workflow/run is broken; ``submit(validate="error")``
                  rejects it at admission.
  * ``warning`` — almost certainly a bug (race, stale-memo risk) but the
                  run can proceed; surfaced, never blocking by default.
  * ``info``    — worth knowing (e.g. a remotable step that will fall
                  back in-process); never blocking.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITIES = (ERROR, WARNING, INFO)


@dataclass(frozen=True)
class RuleInfo:
    rule: str        # stable id, e.g. "W001"
    severity: str    # default severity of findings from this rule
    title: str       # short kebab-ish name, e.g. "cycle"
    hint: str        # generic fix hint shown in the catalogue


@dataclass(frozen=True)
class Finding:
    rule: str                      # RuleInfo.rule
    severity: str                  # error | warning | info
    message: str                   # concrete, names the offending objects
    steps: Tuple[str, ...] = ()    # step names involved (order meaningful)
    uri: str = ""                  # offending variable/MDSS URI, if any
    hint: str = ""                 # fix hint (defaults to the rule's)
    where: str = ""                # file:line / source location, if known

    def __str__(self):
        loc = f" [{self.where}]" if self.where else ""
        steps = f" steps={','.join(self.steps)}" if self.steps else ""
        return (f"{self.rule} {self.severity}: {self.message}"
                f"{steps}{loc}" + (f"\n      hint: {self.hint}"
                                   if self.hint else ""))


#: rule id -> RuleInfo; populated by the ``_rule`` calls below.
RULES: Dict[str, RuleInfo] = {}


def _rule(rule: str, severity: str, title: str, hint: str) -> str:
    assert severity in _SEVERITIES and rule not in RULES
    RULES[rule] = RuleInfo(rule, severity, title, hint)
    return rule


def finding(rule: str, message: str, steps=(), uri: str = "",
            hint: str = "", where: str = "",
            severity: str = "") -> Finding:
    """Build a Finding for a registered rule (severity defaults to the
    rule's; hint defaults to the rule's catalogue hint)."""
    info = RULES[rule]
    return Finding(rule, severity or info.severity, message,
                   tuple(steps), uri, hint or info.hint, where)


# ----------------------------------------------------------------- verifier
W001 = _rule("W001", ERROR, "cycle",
             "break the dependency cycle: some step must consume an "
             "initial value (provide the variable at submit) instead of "
             "a later step's output")
W002 = _rule("W002", ERROR, "unbound-input",
             "pass the variable in init_vars, publish() it into the "
             "shared namespace, or add a step that writes it first")
W003 = _rule("W003", ERROR, "no-impl",
             "give the step a fn= callable or a remote_impl= registry "
             "name")
W004 = _rule("W004", WARNING, "unknown-remote-impl",
             "register the name with the fabric's step registry "
             "(or list its module in Fabric(init_modules=...))")
W005 = _rule("W005", ERROR, "signature-mismatch",
             "make the fn's parameters match the step's declared inputs "
             "(staging calls fn(**{input: value}))")
W010 = _rule("W010", WARNING, "ww-hazard",
             "make the second writer read the first version (true "
             "dataflow), or drop one of the writes — the final version "
             "is otherwise ordered only by declaration-order fencing")
W011 = _rule("W011", WARNING, "rw-hazard",
             "make the overwriter consume the reader's output so the "
             "read-before-overwrite ordering is real dataflow, not just "
             "a scheduler fence")
W012 = _rule("W012", WARNING, "dead-write",
             "no step reads this version before it is overwritten — "
             "drop the write or route a reader to it")
W020 = _rule("W020", INFO, "not-fabric-runnable",
             "the step will fall back in-process on fabric-backed "
             "tiers; register a remote_impl or use a module-level "
             "picklable fn to ship it to workers")
W021 = _rule("W021", WARNING, "device-capture",
             "the fn closes over a device array; pass it as a declared "
             "input instead so staging manages placement and the "
             "closure stays shippable")
W030 = _rule("W030", WARNING, "memo-unsafe",
             "a memoizable step must read only its declared inputs; "
             "move captured state into inputs or set memoizable=False")
W031 = _rule("W031", WARNING, "memo-no-output",
             "memoization keys on output names — a step with no outputs "
             "is never memoized; declare outputs or drop memoizable")
W040 = _rule("W040", WARNING, "budget-infeasible",
             "declared residency_budget is smaller than the bytes the "
             "workflow declares it will materialise on that tier — the "
             "run will thrash the evictor; raise the budget or shrink "
             "bytes_hint")
W041 = _rule("W041", WARNING, "budget-unknown-tier",
             "residency_budget names a tier the runtime does not have; "
             "the budget will never be enforced")
W050 = _rule("W050", INFO, "dead-step",
             "no final output is reachable from this step's outputs — "
             "it burns a lane slot for nothing; drop it or consume its "
             "outputs")
W060 = _rule("W060", ERROR, "fanout-spec",
             "fix the Fanout annotation: shards must be >= 1 and every "
             "scatter= name must be one of the step's declared inputs "
             "(a step with no inputs has nothing to scatter)")
W061 = _rule("W061", WARNING, "fanout-unpicklable-fn",
             "partition_fn/combine_fn is a closure or lambda the fabric "
             "and checkpoints cannot carry; use a module-level function")
W062 = _rule("W062", ERROR, "fanout-gather-missing-shard",
             "the gather step must read every sibling shard's output "
             "URI (out#0..out#N-1) — a dropped shard would silently "
             "vanish from the combined result")
W063 = _rule("W063", ERROR, "fanout-sibling-ww",
             "sibling shards of one fan-out must write disjoint shard "
             "URIs; two shards writing the same uri#k race on the final "
             "version")
W070 = _rule("W070", WARNING, "slo-unbatchable",
             "slo_ms only steers the serving front door for remotable, "
             "memoizable (deterministic, declared-inputs-only) steps the "
             "coalescer can key by code fingerprint; drop the SLO or "
             "make the step batchable")
W071 = _rule("W071", ERROR, "preemptible-shard-no-gather",
             "a preemptible fan-out shard can be checkpoint-aborted and "
             "requeued; without the sibling gather barrier nothing "
             "fences re-publication of its shard URI — add the gather "
             "step or drop preemptible")

# ---------------------------------------------------------------- sanitizer
H101 = _rule("H101", ERROR, "duplicate-done",
             "a step completed more times than it was dispatched — a "
             "replayed/forged completion got past the runtime's "
             "outstanding-set guard")
H102 = _rule("H102", ERROR, "orphan-completion",
             "a completion arrived for a step never granted a lane slot "
             "— the event stream violates dispatch -> done ordering")
H103 = _rule("H103", ERROR, "lost-completion",
             "a dispatched step never reported done in a run that "
             "finished successfully — a completion was dropped")
H110 = _rule("H110", ERROR, "install-regression",
             "a tier's replica of a URI went backwards in version within "
             "one namespace epoch — a stale transfer overwrote a newer "
             "write (version-hazard fence failed)")
H111 = _rule("H111", ERROR, "evict-install-race",
             "a replica version was evicted that was never installed on "
             "that tier — eviction raced an in-flight install")

# ------------------------------------------------- explorer (cross-schedule)
H120 = _rule("H120", ERROR, "fence-epoch-regression",
             "an install landed carrying a namespace epoch older than one "
             "already observed for that namespace — a transfer that "
             "started before drop_namespace() installed into the reused "
             "namespace; fence the install on the live epoch")
H121 = _rule("H121", ERROR, "memo-double-execution",
             "one memo key (code fingerprint + input digests) executed "
             "more than once under memoization — the in-flight entry "
             "guard failed to make the second tenant a waiter")
H122 = _rule("H122", ERROR, "fair-share-starvation",
             "a run with ready steps and the smallest virtual time was "
             "passed over for a full starvation window of dispatches — "
             "the deficit-weighted scheduler is not serving the run it "
             "owes the next slot")
H123 = _rule("H123", ERROR, "residency-overshoot",
             "a namespace's resident bytes exceeded its configured "
             "per-tier budget — eviction did not run (or ran too late) "
             "on the install that crossed the ceiling")
H124 = _rule("H124", ERROR, "checkpoint-divergence",
             "resuming from a checkpointed prefix converged to different "
             "final content digests than the uninterrupted run — the "
             "checkpoint froze an inconsistent (completed, vars) pair "
             "or resume re-applied a non-idempotent step")
H125 = _rule("H125", ERROR, "parked-run-starved",
             "a parked submission stayed eligible (capacity free, head "
             "of the deadline order) for a full admission window without "
             "being admitted — the drain loop missed the capacity-freed "
             "wakeup; every slot release must re-run admission")
H126 = _rule("H126", ERROR, "preempt-burned-progress",
             "a preempted batch step lost retry budget or a completed "
             "checkpoint step — preemption must be attempt-free and "
             "resume from the latest checkpoint, else SLO pressure "
             "silently eats batch tenants' work")

# ---------------------------------------------------------------- selfcheck
L001 = _rule("L001", ERROR, "unregistered-event-kind",
             "add the kind to repro_torch.obs.events.EVENT_SCHEMA with its "
             "required/optional info keys")
L002 = _rule("L002", ERROR, "unregistered-metric",
             "add the name to repro_torch.obs.metrics.METRIC_CATALOG with a "
             "one-line doc")
L010 = _rule("L010", ERROR, "lock-order-inversion",
             "two code paths acquire the same pair of locks in opposite "
             "orders — a classic ABBA deadlock; pick one canonical order "
             "(document it on the lock declarations) and fix the "
             "inverted site")
L011 = _rule("L011", WARNING, "blocking-call-under-lock",
             "a blocking operation (sleep, socket recv/accept, untimed "
             "wait on a foreign event, pickling) runs while a lock is "
             "held — every other thread contending on that lock stalls "
             "for the full blocking duration; move the slow work outside "
             "the critical section")
L012 = _rule("L012", ERROR, "cond-wait-no-predicate-loop",
             "Condition.wait() outside a while-predicate loop — spurious "
             "wakeups and missed notifies are legal, so the waiter must "
             "re-check its predicate in a loop (while not pred: "
             "cond.wait())")


def max_severity(findings) -> str:
    """Worst severity present ('' when findings is empty)."""
    worst = ""
    for f in findings:
        if f.severity == ERROR:
            return ERROR
        if f.severity == WARNING:
            worst = WARNING
        elif not worst:
            worst = INFO
    return worst
