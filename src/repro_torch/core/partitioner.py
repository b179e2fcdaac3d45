"""Static workflow partitioner (paper §3.1–§3.2).

Given an annotated workflow, validates the three legal-partition properties
and emits a *partitioned workflow*: the same step sequence with a
``MigrationPoint`` (the paper's "temporary step") inserted before every
remotable step. At run time the migration point suspends execution, hands
the step to the migration manager, and resumes on re-integration.

Properties enforced (paper §3.2):
  P1 — steps that access special local hardware cannot be offloaded.
  P2 — a remotable step's inputs/outputs must be variables declared at the
       same nesting level as the step (visible to siblings), so data can be
       re-integrated.
  P3 — no nested offloading: a remotable step may not contain remotable
       descendants; suspend/resume strictly alternate (guaranteed at step
       granularity by construction, validated for nesting).

Beyond-paper: **data-parallel fan-out expansion**. A step annotated with
:class:`~repro_torch.core.workflow.Fanout` is rewritten here — before the
legality checks, so every downstream consumer (verifier, scheduler,
executor, sanitizer) sees only ordinary steps — into::

    big                      big.scatter     (partition_fn -> P#0..P#N-1)
    inputs=(P, cfg)    =>    big#k           (fn over P#k + broadcast cfg,
    outputs=(out,)                            k = 0..N-1, writes out#k)
    fanout=Fanout(N)         big.gather      (combine_fn -> out)

Each shard value ``uri#k`` is its own content-addressed MDSS entry, so
dedup, locality scoring, and per-shard memoization fall out of the
existing machinery; each shard step is an independent ready task for the
runtime's lanes and the fabric's requeue-on-worker-loss. Shard steps
keep the original fn (stable code fingerprint — the per-shard memo key
survives resubmission) and remap staged kwargs via ``Step.arg_names`` so
``fn(P=...)`` still receives its declared parameter names.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.mdss import shard_uri
from repro_torch.core.workflow import (Fanout, Step, Variable, Workflow,
                                 WorkflowError)


class PartitionError(WorkflowError):
    def __init__(self, prop: int, msg: str):
        super().__init__(f"Property {prop} violated: {msg}")
        self.prop = prop


@dataclass
class MigrationPoint:
    """The 'temporary step' inserted before a remotable step."""
    target: str                 # name of the remotable step it guards

    @property
    def name(self) -> str:
        return f"__migrate__{self.target}"


@dataclass
class PartitionedWorkflow:
    workflow: Workflow
    sequence: List[object] = field(default_factory=list)  # Step | MigrationPoint

    @property
    def migration_points(self) -> List[MigrationPoint]:
        return [s for s in self.sequence if isinstance(s, MigrationPoint)]

    @property
    def remotable_steps(self) -> List[Step]:
        return [s for s in self.sequence
                if isinstance(s, Step) and s.remotable]


def _check_p1(wf: Workflow, s: Step):
    if s.remotable and s.requires_local_hardware:
        raise PartitionError(
            1, f"step {s.name} is remotable but requires local hardware")


def _check_p2(wf: Workflow, s: Step):
    if not s.remotable:
        return
    level = s.scope(wf)
    for v in s.inputs + s.outputs:
        var = wf.variables.get(v)
        if var is None:
            raise PartitionError(2, f"step {s.name}: variable {v} undeclared")
        if var.scope != level:
            raise PartitionError(
                2, f"step {s.name} (level {level}) uses variable {v} "
                   f"declared at level {var.scope}; inputs/outputs must be "
                   f"defined at the same level as the step")


def _check_p3(wf: Workflow, s: Step):
    if not s.remotable:
        return
    for d in wf.descendants(s.name):
        if d.remotable:
            raise PartitionError(
                3, f"remotable step {s.name} contains remotable descendant "
                   f"{d.name} (nested offloading)")


def partition(wf: Workflow) -> PartitionedWorkflow:
    """Validate legality and insert migration points (paper Fig 5/6).

    Fan-out steps are expanded first (:func:`expand_fanouts`), so the
    legality checks — and everything downstream of the returned
    ``PartitionedWorkflow`` — run over the scatter/shard/gather form.
    """
    wf = expand_fanouts(wf)
    wf.validate_vars()
    for s in wf.steps.values():
        _check_p1(wf, s)
        _check_p2(wf, s)
        _check_p3(wf, s)
    seq: List[object] = []
    for s in wf.toplevel():
        if s.remotable:
            seq.append(MigrationPoint(target=s.name))
        seq.append(s)
    return PartitionedWorkflow(workflow=wf, sequence=seq)


# ---------------------------------------------------------------- fan-out
def split_rows(value, n: int):
    """Default partition_fn: split along axis 0 into ``n`` parts."""
    return np.array_split(np.asarray(value), n)


def concat_rows(parts):
    """Default combine_fn: reassemble row-split parts along axis 0."""
    return np.concatenate([np.asarray(p) for p in parts], axis=0)


def _make_scatter_fn(scattered: Tuple[str, ...], n: int, partition_fn):
    def scatter(**kw):
        out = {}
        for uri in scattered:
            parts = list(partition_fn(kw[uri], n))
            if len(parts) != n:
                raise WorkflowError(
                    f"partition_fn returned {len(parts)} parts for {uri}, "
                    f"expected {n}")
            for k, part in enumerate(parts):
                out[shard_uri(uri, k)] = part
        return out
    return scatter


def _make_gather_fn(outputs: Tuple[str, ...], n: int, combine_fn):
    def gather(**kw):
        return {o: combine_fn([kw[shard_uri(o, k)] for k in range(n)])
                for o in outputs}
    return gather


def _append_step(wf: Workflow, s: Step):
    """Install an already-built Step (no re-validation — the source
    workflow's builders ran once; expansion only relocates/clones)."""
    wf.steps[s.name] = s
    wf.order.append(s.name)
    for out in s.outputs:
        if out not in wf.variables:
            wf.variables[out] = Variable(out, s.scope(wf),
                                         defined_at=s.defined_at,
                                         implicit=True)


def expand_fanouts(wf: Workflow) -> Workflow:
    """Rewrite every legally-fanned-out step into scatter + N shards +
    gather (see module docstring). Steps whose fan-out spec is illegal
    (``shards < 1``, scatter of a non-input) are left UNEXPANDED so the
    verifier's W060 names the defect at admission instead of this pass
    half-building a broken DAG. Returns ``wf`` itself when nothing
    expands; never mutates the input workflow.
    """
    todo = [s for s in wf.steps.values()
            if s.fanout is not None and not s.fanout_role
            and _fanout_spec_errors(s) == ()]
    if not todo:
        return wf
    for s in todo:
        if s.parent is not None or wf.children_of(s.name):
            raise WorkflowError(
                f"fan-out step {s.name} is nested (parent/children); "
                "fan-out is defined for top-level leaf steps only")
    expanding = {s.name for s in todo}
    out = Workflow(wf.name)
    for v in wf.variables.values():
        if not v.implicit:
            out.variables[v.name] = v
    for name in wf.order:
        s = wf.steps[name]
        if s.name not in expanding:
            _append_step(out, s)
            continue
        spec = s.fanout
        n = spec.shards
        scattered = tuple(spec.scatter) or s.inputs[:1]
        part_fn = spec.partition_fn or split_rows
        comb_fn = spec.combine_fn or concat_rows
        _append_step(out, Step(
            name=f"{s.name}.scatter",
            fn=_make_scatter_fn(scattered, n, part_fn),
            inputs=scattered,
            outputs=tuple(shard_uri(u, k)
                          for u in scattered for k in range(n)),
            device_step=False, memoizable=False, retries=s.retries,
            fanout=spec, fanout_role="scatter", fanout_parent=s.name,
            fanout_shards=n, defined_at=s.defined_at))
        for k in range(n):
            _append_step(out, replace(
                s,
                name=f"{s.name}#{k}",
                inputs=tuple(shard_uri(u, k) if u in scattered else u
                             for u in s.inputs),
                arg_names=s.inputs,
                outputs=tuple(shard_uri(o, k) for o in s.outputs),
                out_names=s.outputs,
                flops_hint=s.flops_hint / n,
                bytes_hint=s.bytes_hint / n,
                fanout=None, fanout_role="shard", fanout_parent=s.name,
                shard_index=k, fanout_shards=n))
        _append_step(out, Step(
            name=f"{s.name}.gather",
            fn=_make_gather_fn(s.outputs, n, comb_fn),
            inputs=tuple(shard_uri(o, k)
                         for o in s.outputs for k in range(n)),
            outputs=s.outputs,
            device_step=False, memoizable=False, retries=s.retries,
            fanout=spec, fanout_role="gather", fanout_parent=s.name,
            fanout_shards=n, defined_at=s.defined_at))
    return out


def _fanout_spec_errors(s: Step) -> Tuple[str, ...]:
    """Spec defects that make expansion impossible (the verifier's W060
    wording mirrors these)."""
    spec = s.fanout
    errs = []
    if spec.shards < 1:
        errs.append(f"declares {spec.shards} shards; a fan-out needs at "
                    "least one")
    unknown = [u for u in spec.scatter if u not in s.inputs]
    if unknown:
        errs.append(f"scatters {', '.join(unknown)}, not among the step's "
                    "declared inputs")
    if not spec.scatter and not s.inputs:
        errs.append("has no inputs to scatter over")
    return tuple(errs)
