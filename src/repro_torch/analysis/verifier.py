"""Static workflow verifier: lint a ``Workflow`` before execution.

:func:`verify` runs the rule catalogue (``W0xx`` in
``repro_torch.analysis.findings``) over a workflow and returns structured
:class:`Finding`\\ s. Two contexts:

  * **static** (``provided=None``) — ``scripts/emlint.py`` over a module
    that merely builds the workflow. Explicitly declared variables
    (``wf.var``) are assumed to be provided at submit time, so only
    structurally certain defects fire (cycles through forward reads of
    step *outputs*, missing impls, signature mismatches, races...).
  * **submit** (``provided={...}``) — ``EmeraldRuntime.submit`` at
    admission, where the actual bound set (init_vars + namespace-resident
    URIs) is known, so unbound reads and feedback cycles are decidable.

Graph rules reason over :meth:`Workflow.dependencies(kinds=True)`: RAW
edges are true dataflow, WAR/WW edges are scheduler-inserted fences.
Two conflicting accesses ordered *only* by a fence are correct under the
current in-order driver but are one scheduler change away from a race —
the verifier flags them so the intent is written down as dataflow.
"""
from __future__ import annotations

import inspect
from typing import Dict, Iterable, List, Optional, Set

import torch

from repro_torch.analysis import findings as F
from repro_torch.analysis.findings import Finding, finding
from repro_torch.core.migration import fabric_runnable_reason, memo_unsafe_reasons
from repro_torch.core.workflow import Step, Workflow, WorkflowError


class WorkflowRejected(WorkflowError):
    """``submit(validate="error")`` refused the workflow. Carries the
    full finding list; str() shows the blocking errors."""

    def __init__(self, workflow_name: str, all_findings: List[Finding]):
        self.workflow = workflow_name
        self.findings = list(all_findings)
        errors = [f for f in self.findings if f.severity == F.ERROR]
        lines = "\n  ".join(str(f) for f in errors)
        super().__init__(
            f"workflow {workflow_name!r} rejected by the verifier "
            f"({len(errors)} error(s); submit(validate=\"warn\"|\"off\") "
            f"to override):\n  {lines}")


def _is_device_array(v) -> bool:
    """A tensor on an accelerator: a step that captures one pins device
    memory outside MDSS and cannot move to another tier."""
    return isinstance(v, torch.Tensor) and v.device.type != "cpu"


def _captured_device_arrays(fn) -> List[str]:
    names = []
    cells = getattr(fn, "__closure__", None) or ()
    free = getattr(getattr(fn, "__code__", None), "co_freevars", ())
    for nm, cell in zip(free, cells):
        try:
            v = cell.cell_contents
        except ValueError:
            continue
        if _is_device_array(v):
            names.append(nm)
    for v in (getattr(fn, "__defaults__", None) or ()):
        if _is_device_array(v):
            names.append("<default>")
    return names


def verify(wf: Workflow, *, provided: Optional[Iterable[str]] = None,
           residency_budget: Optional[Dict[str, int]] = None,
           tiers=None, capacity_bytes: int = 0,
           registry=None) -> List[Finding]:
    """Run every verifier rule over ``wf``; returns findings (possibly
    empty), never raises on defective workflows.

    ``provided``: URIs bound at submission (init_vars + resident data);
    ``None`` = static context (see module doc). ``tiers`` /
    ``capacity_bytes`` ground the residency-budget feasibility check;
    ``registry`` is the fabric step registry W004 checks names against
    (the port has no default registry until the fabric is ported).
    """
    out: List[Finding] = []
    top = wf.toplevel()
    names = [s.name for s in top]
    idx = {n: i for i, n in enumerate(names)}
    parents = {s.parent for s in wf.steps.values() if s.parent}
    kdeps = wf.dependencies(kinds=True)

    # RAW-ancestor bitmasks: raw_anc[s] has bit idx[d] set iff there is a
    # true-dataflow path d ~> s. Declaration order is a topological order
    # of the (fenced) DAG, so one forward sweep suffices; queries are O(1).
    raw_anc: Dict[str, int] = {}
    for n in names:
        m = 0
        for d, ks in kdeps[n].items():
            if "RAW" in ks:
                m |= raw_anc[d] | (1 << idx[d])
        raw_anc[n] = m

    def raw_path(a: str, b: str) -> bool:
        return bool((raw_anc[b] >> idx[a]) & 1)

    # Per-URI access scan (same sweep dependencies() does, but keeping
    # the var-level detail the graph rules need).
    writers: Dict[str, List[str]] = {}       # uri -> writers in order
    dead_writes = []                         # (prev_writer, overwriter, uri)
    war_pairs = []                           # (reader, overwriter, uri)
    last_writer: Dict[str, str] = {}
    readers_since: Dict[str, List[str]] = {}
    for s in top:
        for v in s.inputs:
            readers_since.setdefault(v, []).append(s.name)
        for v in s.outputs:
            prev = last_writer.get(v)
            live_readers = [r for r in readers_since.get(v, ())
                            if r != s.name]
            if prev is not None and prev != s.name and not live_readers:
                dead_writes.append((prev, s.name, v))
            for r in live_readers:
                war_pairs.append((r, s.name, v))
            writers.setdefault(v, []).append(s.name)
            readers_since[v] = []
            last_writer[v] = s.name

    provided_set: Optional[Set[str]] = \
        None if provided is None else set(provided)

    # ---------------------------------------------------- W001 cycle
    # Feedback edges: a read with no prior writer resolves at runtime to
    # submission-provided data — unless nothing provides it and a LATER
    # step writes it, in which case the author meant that step's output
    # and the "DAG" is a cycle the declaration order papered over.
    graph: Dict[str, Set[str]] = {n: set(kdeps[n]) for n in names}
    for s in top:
        for v in s.inputs:
            ws = writers.get(v, [])
            prior = [w for w in ws if idx[w] < idx[s.name]]
            later = [w for w in ws if idx[w] > idx[s.name]]
            if prior or not later:
                continue
            var = wf.variables.get(v)
            externally_bound = (
                provided_set is not None and v in provided_set
                or provided_set is None and var is not None
                and not var.implicit)
            if not externally_bound:
                graph[s.name].add(later[0])

    # Iterative coloured DFS (a 1k-step chain must not hit the Python
    # recursion limit); an edge n -> d reads "n awaits d".
    color: Dict[str, int] = {}
    path: List[str] = []
    cycles: List[List[str]] = []
    for root in names:
        if color.get(root, 0):
            continue
        todo = [(root, iter(sorted(graph[root], key=lambda x: idx[x])))]
        color[root] = 1
        path.append(root)
        while todo:
            n, it = todo[-1]
            for d in it:
                c = color.get(d, 0)
                if c == 0:
                    color[d] = 1
                    path.append(d)
                    todo.append(
                        (d, iter(sorted(graph[d], key=lambda x: idx[x]))))
                    break
                if c == 1:
                    cycles.append(path[path.index(d):] + [d])
            else:
                color[n] = 2
                path.pop()
                todo.pop()
    for cyc in cycles:
        witness = " -> ".join(cyc)
        out.append(finding(
            F.W001,
            f"dependency cycle: {witness} (each step awaits the next's "
            "output; no member can ever become ready)",
            steps=tuple(dict.fromkeys(cyc))))

    # ---------------------------------------------- W002 unbound-input
    if provided_set is not None:
        for s in top:
            for v in s.inputs:
                ws = writers.get(v, [])
                if any(idx[w] < idx[s.name] for w in ws):
                    continue
                if v in provided_set:
                    continue
                later = [w for w in ws if idx[w] > idx[s.name]]
                extra = (f"; {later[0]} writes it only later — provide "
                         "an initial value if this is a feedback loop"
                         ) if later else ""
                out.append(finding(
                    F.W002,
                    f"step {s.name} reads {v}, which nothing provides "
                    f"(not in init_vars, not resident, no prior "
                    f"writer){extra}",
                    steps=(s.name,), uri=v, where=s.defined_at))

    # ---------------------------------- per-step implementation rules
    for s in wf.steps.values():
        if s.name in parents:
            continue                     # container node: children execute
        if s.fn is None and not s.remote_impl:
            out.append(finding(
                F.W003,
                f"step {s.name} has neither fn nor remote_impl — it can "
                "execute nowhere",
                steps=(s.name,), where=s.defined_at))
        if s.remote_impl:
            reg = registry
            if reg is not None and s.remote_impl not in reg:
                out.append(finding(
                    F.W004,
                    f"step {s.name} names remote_impl "
                    f"{s.remote_impl!r}, which is not in the fabric "
                    "step registry (workers may register more modules "
                    "at spawn; verify init_modules)",
                    steps=(s.name,), where=s.defined_at))
        out.extend(_signature_findings(s))
        if s.remotable and s.fn is not None \
                and not getattr(s, "device_step", True):
            reason = fabric_runnable_reason(s)
            if reason:
                out.append(finding(
                    F.W020,
                    f"remotable step {s.name} cannot ship to fabric "
                    f"workers: {reason}",
                    steps=(s.name,), where=s.defined_at))
        if s.remotable and s.fn is not None:
            captured = _captured_device_arrays(s.fn)
            if captured:
                out.append(finding(
                    F.W021,
                    f"remotable step {s.name} captures device array(s) "
                    f"{', '.join(captured)} in its closure/defaults",
                    steps=(s.name,), where=s.defined_at))
        if s.memoizable is True:
            reasons = memo_unsafe_reasons(s)
            if reasons:
                out.append(finding(
                    F.W030,
                    f"memoizable step {s.name} reads state outside its "
                    f"memo key: {'; '.join(reasons)}",
                    steps=(s.name,), where=s.defined_at))
            if not s.outputs:
                out.append(finding(
                    F.W031,
                    f"memoizable step {s.name} declares no outputs, so "
                    "no execution is ever memoized",
                    steps=(s.name,), where=s.defined_at))
        if getattr(s, "slo_ms", None) is not None:
            # the coalescer keys fused batches on (code fingerprint,
            # shape) — only remotable, deterministic-by-declaration
            # steps can safely fuse across tenants
            why = []
            if not s.remotable:
                why.append("is not remotable")
            if s.memoizable is False:
                why.append("is declared memoizable=False (not "
                           "deterministic over its declared inputs)")
            if why:
                out.append(finding(
                    F.W070,
                    f"step {s.name} carries slo_ms={s.slo_ms} but "
                    f"{' and '.join(why)} — the serving front door "
                    "cannot coalesce it, so the SLO steers nothing",
                    steps=(s.name,), where=s.defined_at))

    # ------------------------------------------- W010/W011/W012 races
    for v, ws in writers.items():
        for w1, w2 in zip(ws, ws[1:]):
            if not raw_path(w1, w2):
                out.append(finding(
                    F.W010,
                    f"{w1} and {w2} both write {v} with no dataflow "
                    "path between them — their order (hence the final "
                    "version) rests only on a declaration-order fence",
                    steps=(w1, w2), uri=v))
    for r, w, v in war_pairs:
        if v in wf.steps[w].inputs:
            # read-modify-write: the overwriter consumes the version it
            # replaces (the canonical update-step idiom) — it extends
            # the version chain rather than clobbering a live read
            continue
        if not raw_path(r, w):
            out.append(finding(
                F.W011,
                f"{r} reads {v} and {w} later blindly overwrites it "
                "(never reading that version), ordered only by an "
                "anti-dependency fence, not dataflow",
                steps=(r, w), uri=v))
    for w1, w2, v in dead_writes:
        out.append(finding(
            F.W012,
            f"{w1}'s version of {v} is overwritten by {w2} before "
            "anything reads it",
            steps=(w1, w2), uri=v))

    # --------------------------------------------- W040/W041 budgets
    declared_bytes = sum(s.bytes_hint for s in top if s.outputs)
    for tier_name, budget in (residency_budget or {}).items():
        if tiers is not None and tier_name not in tiers:
            out.append(finding(
                F.W041,
                f"residency_budget names unknown tier {tier_name!r} "
                f"(known: {sorted(tiers)})", uri=tier_name))
            continue
        if capacity_bytes and budget > capacity_bytes:
            out.append(finding(
                F.W040,
                f"residency_budget[{tier_name!r}]={budget} exceeds the "
                f"store's capacity_bytes={capacity_bytes}",
                uri=tier_name))
        elif declared_bytes and budget < declared_bytes:
            out.append(finding(
                F.W040,
                f"residency_budget[{tier_name!r}]={budget} is below the "
                f"{declared_bytes:.0f} bytes the workflow declares it "
                "will materialise (sum of bytes_hint over writing "
                "steps)", uri=tier_name))

    # ------------------------------------------ W060..W063 fan-out
    out.extend(_fanout_findings(wf, top))

    # ----------------------------------------------- W050 dead-step
    live: Set[str] = {s.name for s in top if not s.outputs}
    live |= {ws[-1] for ws in writers.values()}
    for n in reversed(names):
        if n in live:
            for d, ks in kdeps[n].items():
                if "RAW" in ks:
                    live.add(d)
    for s in top:
        if s.name not in live:
            out.append(finding(
                F.W050,
                f"step {s.name} is dead: every output is overwritten "
                "before being read and nothing downstream consumes it",
                steps=(s.name,), where=s.defined_at))
    return out


def _unpicklable_reason(fn) -> str:
    """Why ``fn`` cannot ride a pickle (fabric ship / checkpoint), or ''."""
    import pickle
    if getattr(fn, "__name__", "") == "<lambda>":
        return "is a lambda — unpicklable"
    try:
        pickle.dumps(fn)
    except Exception as e:
        return f"is unpicklable ({type(e).__name__}: {e})"
    return ""


def _fanout_findings(wf: Workflow, top: List[Step]) -> List[Finding]:
    """W060–W063: fan-out legality.

    Runs over both forms the verifier can see: the *unexpanded* step
    (static lint, or a spec so broken the partitioner refused to expand
    it — W060/W061) and the *expanded* scatter/shard/gather triple the
    runtime admits (W061 on the closure carriers, W062/W063 on the
    shard-URI wiring of hand-built or mutated expansions).
    """
    from repro_torch.core.mdss import shard_uri
    from repro_torch.core.partitioner import _fanout_spec_errors
    out: List[Finding] = []
    shard_writers: Dict[str, Dict[str, str]] = {}   # parent -> uri -> shard
    preemptible_shards: Dict[str, List[str]] = {}   # parent -> shard names
    gather_parents: Set[str] = set()
    for s in top:
        spec = s.fanout
        if spec is not None and not s.fanout_role:
            for err in _fanout_spec_errors(s):
                out.append(finding(
                    F.W060,
                    f"step {s.name}'s fan-out spec {err}",
                    steps=(s.name,), where=s.defined_at))
        if spec is not None:
            carried = []
            if s.fanout_role in ("", "scatter") and spec.partition_fn:
                carried.append(("partition_fn", spec.partition_fn))
            if s.fanout_role in ("", "gather") and spec.combine_fn:
                carried.append(("combine_fn", spec.combine_fn))
            for label, fn in carried:
                reason = _unpicklable_reason(fn)
                if reason:
                    out.append(finding(
                        F.W061,
                        f"step {s.name}'s {label} {reason}; fabric "
                        "workers and checkpoints cannot carry it",
                        steps=(s.name,), where=s.defined_at))
        if s.fanout_role == "gather":
            gather_parents.add(s.fanout_parent)
        if s.fanout_role == "shard" and getattr(s, "preemptible", False):
            preemptible_shards.setdefault(
                s.fanout_parent, []).append(s.name)
        if s.fanout_role == "gather" and s.fanout_shards > 0:
            expected = {shard_uri(o, k)
                        for o in s.outputs for k in range(s.fanout_shards)}
            dropped = sorted(expected - set(s.inputs))
            if dropped:
                out.append(finding(
                    F.W062,
                    f"gather step {s.name} never reads sibling shard "
                    f"output(s) {', '.join(dropped)} — those shards' "
                    "results silently vanish from the combined value",
                    steps=(s.name,), uri=dropped[0], where=s.defined_at))
        if s.fanout_role == "shard":
            seen = shard_writers.setdefault(s.fanout_parent, {})
            for o in s.outputs:
                if o in seen and seen[o] != s.name:
                    out.append(finding(
                        F.W063,
                        f"sibling shards {seen[o]} and {s.name} of "
                        f"fan-out {s.fanout_parent} both write {o} — "
                        "the surviving version depends on completion "
                        "order",
                        steps=(seen[o], s.name), uri=o,
                        where=s.defined_at))
                else:
                    seen[o] = s.name
    for parent, shards in sorted(preemptible_shards.items()):
        if parent not in gather_parents:
            out.append(finding(
                F.W071,
                f"preemptible shard(s) {', '.join(sorted(shards))} of "
                f"fan-out {parent} have no sibling gather step — a "
                "preempted-and-requeued shard would re-publish its "
                "shard URI with no barrier fencing downstream readers",
                steps=tuple(sorted(shards)), uri=parent))
    return out


def _signature_findings(s: Step) -> List[Finding]:
    """W005: statically-certain call mismatches between the step's
    declared inputs and its fn's parameters (execution calls
    ``fn(**{input: staged value})``)."""
    fn = s.fn
    if fn is None:
        return []
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return []
    params = list(sig.parameters.values())
    if any(p.kind == p.VAR_KEYWORD for p in params):
        return []                         # **kw absorbs anything
    named = {p.name for p in params
             if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
    required = {p.name for p in params
                if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
                and p.default is p.empty}
    pos_only = [p.name for p in params
                if p.kind == p.POSITIONAL_ONLY and p.default is p.empty]
    out = []
    # staging calls fn(**{arg_names[i]: value_of(inputs[i])}) — the
    # declared parameter names are arg_names when set (fan-out shard
    # steps read uri#k but call the original fn by its own names)
    declared = set(s.arg_names) if s.arg_names else set(s.inputs)
    extra = sorted(declared - named)
    missing = sorted(required - declared)
    if extra:
        out.append(finding(
            F.W005,
            f"step {s.name} declares input(s) {', '.join(extra)} its fn "
            "does not accept — the staged call fn(**inputs) will raise "
            "TypeError",
            steps=(s.name,), where=s.defined_at))
    if missing:
        out.append(finding(
            F.W005,
            f"step {s.name}'s fn requires parameter(s) "
            f"{', '.join(missing)} absent from the step's declared "
            "inputs — the staged call will raise TypeError",
            steps=(s.name,), where=s.defined_at))
    if pos_only:
        out.append(finding(
            F.W005,
            f"step {s.name}'s fn takes positional-only parameter(s) "
            f"{', '.join(pos_only)}; staging passes inputs by keyword",
            steps=(s.name,), where=s.defined_at))
    return out
