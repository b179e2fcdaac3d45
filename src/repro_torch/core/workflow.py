"""Workflow model (paper §2/§3.1): steps, variables with scope, DAG.

The paper expresses workflows in WF/XAML with a ``migration`` attribute on
offloadable nodes. The equivalent here is a declarative Python DAG:

    wf = Workflow("AT")
    wf.var("model", scope=())          # workflow-level variable
    wf.step("forward", fn, inputs=("model",), outputs=("syn",))
    wf.step("misfit", fn2, inputs=("syn", "obs"), outputs=("chi",),
            remotable=True)

Steps may nest (``parent=``) — XAML's hierarchical nodes — and variables
carry a scope path used by the partitioner's Property-2 check. Dataflow
(read-after-write on variable URIs) defines the DAG; steps with no path
between them are *parallel* and may offload concurrently (paper Fig 9b).
"""
from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


def _call_site(depth: int = 2) -> str:
    """``file:line`` of the caller ``depth`` frames up (best effort)."""
    try:
        f = sys._getframe(depth)
        return f"{f.f_code.co_filename}:{f.f_lineno}"
    except Exception:
        return ""


@dataclass
class Variable:
    name: str
    scope: Tuple[str, ...] = ()     # path of enclosing step names; () = top
    defined_at: str = ""            # "file:line" of the declaring call
    implicit: bool = False          # auto-declared as a step output (never
                                    # part of the workflow's input surface)


@dataclass(frozen=True)
class Fanout:
    """Data-parallel fan-out annotation for a step.

    A step carrying a ``Fanout`` never executes as declared: the
    partitioner expands it at submit time into one *scatter* step (runs
    ``partition_fn`` over each scattered input, publishing N independent
    content-addressed shard values ``uri#k``), N *shard* sub-steps (the
    original fn over its shard's slice plus the un-scattered broadcast
    inputs), and one *gather* step (``combine_fn`` over the shard
    outputs ``out#k``, publishing the step's declared outputs). Each
    shard is an independent ready task: it is placed, fair-share-charged,
    requeued on worker loss, and memoized (key = code fingerprint + that
    shard's input digest) on its own.

    ``scatter`` names which inputs are partitioned per shard (default:
    the first declared input); the rest broadcast whole to every shard.
    ``partition_fn(value, n)`` must return exactly ``n`` parts (default:
    row split along axis 0); ``combine_fn(parts)`` reassembles the shard
    outputs (default: row concatenation). Both should be module-level
    (picklable) functions so checkpoints and workers can carry them —
    the verifier's W061 flags closures/lambdas.
    """
    shards: int
    scatter: Tuple[str, ...] = ()
    partition_fn: Optional[Callable] = None
    combine_fn: Optional[Callable] = None


@dataclass
class Step:
    name: str
    fn: Optional[Callable[..., Dict[str, Any]]] = None
    inputs: Tuple[str, ...] = ()
    outputs: Tuple[str, ...] = ()
    remotable: bool = False
    requires_local_hardware: bool = False      # Property 1 trigger
    parent: Optional[str] = None               # nesting (XAML hierarchy)
    device_step: bool = True                   # fn runs on the tier's device
    flops_hint: float = 0.0                    # cost-model hints
    bytes_hint: float = 0.0
    retries: int = 2                           # fault-tolerance budget
    remote_impl: Optional[str] = None          # fabric step-registry name
    # cross-run memoization override: True forces it on for this step,
    # False forces it off (e.g. a clock/RNG-reading step under a
    # memoize=True runtime), None defers to the manager-wide default.
    # Only set True for deterministic, side-effect-free steps.
    memoizable: Optional[bool] = None
    # data-parallel fan-out (see Fanout): set on the user-declared step;
    # the partitioner's expansion replaces it with scatter/shard/gather
    # steps whose fanout_role/fanout_parent/shard_index identify them
    fanout: Optional[Fanout] = None
    fanout_role: str = ""                      # "" | scatter | shard | gather
    fanout_parent: str = ""                    # original step's name
    shard_index: int = -1                      # k for shard steps
    fanout_shards: int = 0                     # fan-out width N
    # serving front door: a preemptible step's in-flight broker task may
    # be checkpoint-aborted and requeued (attempt-free) when an
    # interactive tenant's SLO is threatened. Only long batch work
    # should opt in; the verifier's W071 gates fan-out legality.
    preemptible: bool = False
    # per-step latency SLO (interactive serving). Feeds the coalescer's
    # flush deadline and the admission queue's slack ordering; W070
    # flags it on steps the front door cannot actually batch.
    slo_ms: Optional[float] = None
    # staged-call parameter names, parallel to ``inputs``: execution
    # calls fn(**{arg_names[i]: value_of(inputs[i])}). None = inputs ARE
    # the parameter names (the default contract). Lets an expanded shard
    # step read ``P#3`` while its fn still receives ``P=``.
    arg_names: Optional[Tuple[str, ...]] = None
    # returned-dict keys, parallel to ``outputs``: the fn returns
    # {out_names[i]: value} and execution publishes it as outputs[i].
    # None = outputs ARE the returned keys. The shard twin of arg_names:
    # the original fn still returns {"out": ...}, published as out#3.
    out_names: Optional[Tuple[str, ...]] = None
    defined_at: str = ""                       # "file:line" of wf.step(...)

    def scope(self, wf: "Workflow") -> Tuple[str, ...]:
        """Path of enclosing steps."""
        path = []
        p = self.parent
        while p is not None:
            path.append(p)
            p = wf.steps[p].parent
        return tuple(reversed(path))


def remotable(**hints):
    """Decorator marking a plain function's step defaults (API sugar)."""
    def wrap(fn):
        fn.__emerald_remotable__ = True
        fn.__emerald_hints__ = hints
        return fn
    return wrap


class WorkflowError(ValueError):
    pass


@dataclass
class Workflow:
    name: str
    steps: Dict[str, Step] = field(default_factory=dict)
    order: List[str] = field(default_factory=list)
    variables: Dict[str, Variable] = field(default_factory=dict)

    # ------------------------------------------------------------- builders
    def var(self, name: str, scope: Tuple[str, ...] = ()) -> "Workflow":
        site = _call_site()
        if name in self.variables:
            prev = self.variables[name].defined_at or "<unknown site>"
            raise WorkflowError(
                f"variable {name} redefined at {site or '<unknown site>'}; "
                f"first declared at {prev}")
        self.variables[name] = Variable(name, tuple(scope), defined_at=site)
        return self

    def step(self, name: str, fn=None, *, inputs=(), outputs=(),
             remotable: Optional[bool] = None, parent=None, **kw) -> Step:
        site = _call_site()
        if name in self.steps:
            prev = self.steps[name].defined_at or "<unknown site>"
            raise WorkflowError(
                f"step {name} redefined at {site or '<unknown site>'}; "
                f"first defined at {prev}")
        if parent is not None and parent not in self.steps:
            raise WorkflowError(f"unknown parent step {parent}")
        outputs = tuple(outputs)
        seen: set = set()
        for out in outputs:
            if out in seen:
                raise WorkflowError(
                    f"step {name} (at {site or '<unknown site>'}) declares "
                    f"output {out} more than once; a step publishes exactly "
                    "one version per output URI")
            seen.add(out)
        if remotable is None:
            remotable = bool(getattr(fn, "__emerald_remotable__", False))
        hints = dict(getattr(fn, "__emerald_hints__", {}))
        hints.update(kw)
        hints.setdefault("defined_at", site)
        s = Step(name, fn, tuple(inputs), outputs, remotable,
                 parent=parent, **hints)
        self.steps[name] = s
        self.order.append(name)
        # implicitly declare output variables at the step's level
        for out in s.outputs:
            if out not in self.variables:
                self.variables[out] = Variable(out, s.scope(self),
                                               defined_at=site,
                                               implicit=True)
        return s

    # ------------------------------------------------------------ structure
    def toplevel(self) -> List[Step]:
        return [self.steps[n] for n in self.order if self.steps[n].parent is None]

    def children_of(self, name: str) -> List[Step]:
        return [self.steps[n] for n in self.order if self.steps[n].parent == name]

    def descendants(self, name: str) -> List[Step]:
        out = []
        for c in self.children_of(name):
            out.append(c)
            out.extend(self.descendants(c.name))
        return out

    def dependencies(self, kinds: bool = False):
        """Dataflow DAG over top-level steps.

        Edges: read-after-write (a reader depends on the latest writer),
        write-after-write (a re-writer depends on the previous writer) and
        write-after-read (a re-writer depends on every reader of the
        previous version — otherwise a concurrent writer could clobber an
        earlier reader's input). All edges point from earlier to later
        steps in declaration order, so ``order`` is a valid topological
        order of this DAG.

        With ``kinds=True`` each edge carries its hazard kinds instead of
        being a bare name: ``{step: {dep: frozenset({"RAW","WAR","WW"})}}``.
        RAW edges are true dataflow; WAR/WW edges are anti-dependency
        fences the scheduler inserts to serialise conflicting versions.
        """
        kinded: Dict[str, Dict[str, set]] = {}
        last_writer: Dict[str, str] = {}
        readers: Dict[str, List[str]] = {}     # readers since the last write
        for s in self.toplevel():
            edges = kinded.setdefault(s.name, {})
            for v in s.inputs:
                if v in last_writer:
                    edges.setdefault(last_writer[v], set()).add("RAW")
                readers.setdefault(v, []).append(s.name)
            for v in s.outputs:
                if v in last_writer and last_writer[v] != s.name:
                    # write-after-write ordering
                    edges.setdefault(last_writer[v], set()).add("WW")
                for r in readers.get(v, ()):  # write-after-read ordering
                    if r != s.name:
                        edges.setdefault(r, set()).add("WAR")
                readers[v] = []               # new version: no readers yet
                last_writer[v] = s.name
        if kinds:
            return {n: {d: frozenset(ks) for d, ks in es.items()}
                    for n, es in kinded.items()}
        return {n: set(es) for n, es in kinded.items()}

    def successors(self, deps: Optional[Dict[str, set]] = None
                   ) -> Dict[str, set]:
        """Reverse adjacency of :meth:`dependencies` (step -> dependents).

        Pass a precomputed ``deps`` to avoid rebuilding the edge map.
        """
        deps = self.dependencies() if deps is None else deps
        succ: Dict[str, set] = {n: set() for n in deps}
        for n, ds in deps.items():
            for d in ds:
                succ[d].add(n)
        return succ

    def in_degrees(self, completed=(),
                   deps: Optional[Dict[str, set]] = None) -> Dict[str, int]:
        """Remaining-dependency counts, ignoring already-``completed`` steps."""
        done = set(completed)
        deps = self.dependencies() if deps is None else deps
        return {n: len(ds - done) for n, ds in deps.items() if n not in done}

    def validate_vars(self):
        for s in self.steps.values():
            for v in s.inputs:
                if v not in self.variables:
                    raise WorkflowError(
                        f"step {s.name} reads undeclared variable {v}")
