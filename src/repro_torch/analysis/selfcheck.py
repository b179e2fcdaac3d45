"""Source self-lint: telemetry-registry drift + lock-discipline checks.

Parses every module under ``src/repro_torch/`` and checks two families of rules:

Telemetry drift — the contract that every event kind and metric name
the code can produce is documented:

  * L001 — ``emit(<kind>, ...)`` call sites vs
    ``repro_torch.obs.events.EVENT_SCHEMA``
  * L002 — ``inc("name")`` / ``observe("name")`` / ``gauge("name")`` /
    ``set("name")`` call sites vs ``repro_torch.obs.metrics.METRIC_CATALOG``.
    Metric names are dotted by convention; undotted string args to these
    methods (unrelated ``set(...)`` calls etc.) are ignored. Names built
    dynamically — f-strings (``f"fanout.{kind}_done"``) or literal
    concatenation (``"fanout." + kind``) — are checked as patterns: the
    literal fragments must match at least one registered name, so a
    renamed catalogue entry still fails the lint even when the call
    site interpolates.

Lock discipline — an AST pass over every ``with <lock>:`` site
(objects whose expression mentions ``lock``/``cond``/``mutex``/``sem``):

  * L010 — inconsistent lock-acquisition order: two code paths acquire
    the same pair of locks in opposite orders (ABBA deadlock); reported
    once per pair with both witness sites. Lock identity is the
    expression scoped to its class (``Broker::self._cond``), so
    same-named locks on different classes do not alias; re-entering the
    lock already held (RLock) is ignored.
  * L011 — blocking call while holding a lock: ``sleep``, socket
    ``recv``/``recv_into``/``recv_exact``/``accept``, ``pickle``
    dumps/loads, or an *untimed* ``.wait()`` on anything other than a
    held condition (a condition's own wait releases the lock; a foreign
    ``Event.wait()`` does not).
  * L012 — ``cond.wait()`` on a held condition with no enclosing
    ``while`` predicate loop: spurious wakeups and missed notifies are
    legal, so a bare ``if``-guarded wait is a latent hang.

The static pass is lexical and intra-function by design: it cannot see
aliasing or cross-function lock flows, so it is tuned to be quiet on
legitimate code (timed waits pass L011/L012's untimed rule; ``with a,
b:`` records the documented order). ``emlint --self`` and the pytest
wrapper both call :func:`check_source`; :func:`check_snippet` is the
defect-corpus entry point.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import findings as F
from repro_torch.analysis.findings import Finding, finding

_METRIC_FNS = ("inc", "observe", "gauge", "set")
_LOCKY_RE = re.compile(r"(lock|cond|mutex|sem)", re.I)
_BLOCKING_ATTRS = ("recv", "recv_into", "recv_exact", "accept", "sleep")
_PICKLE_FNS = ("dumps", "loads", "dump", "load")


def default_src_dir() -> str:
    here = os.path.dirname(os.path.abspath(__file__))   # .../repro_torch/analysis
    return os.path.dirname(here)                        # .../repro_torch


# ---------------------------------------------------------------- telemetry

def _name_pattern(node) -> Optional[Tuple[str, bool]]:
    """(regex, is_exact) for a string-building expression: a literal is
    exact; f-strings and ``+``-concatenation become patterns whose
    interpolated holes match anything. None for non-string shapes."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return re.escape(node.value), True
    if isinstance(node, ast.JoinedStr):
        parts, exact = [], True
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(re.escape(v.value))
            else:
                parts.append(".+")
                exact = False
        return "".join(parts), exact
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _name_pattern(node.left)
        right = _name_pattern(node.right)
        if left is None and right is None:
            return None
        lp = left[0] if left else ".+"
        rp = right[0] if right else ".+"
        return lp + rp, False
    return None


def _literal_part(pattern: str) -> str:
    """The escaped-literal content of a pattern (holes stripped), used
    to decide whether a name is 'dotted by convention'."""
    return re.sub(r"\.\+", "", pattern).replace("\\.", ".")


def _check_telemetry_call(node: ast.Call, rel: str, schema, catalog,
                          out: List[Finding]):
    fn = node.func
    name = (fn.attr if isinstance(fn, ast.Attribute)
            else fn.id if isinstance(fn, ast.Name) else None)
    if name is None or not node.args:
        return
    pat = _name_pattern(node.args[0])
    if pat is None:
        return
    pattern, exact = pat
    where = f"{rel}:{node.lineno}"
    if name == "emit":
        if exact:
            kind = node.args[0].value
            if kind not in schema:
                out.append(finding(
                    F.L001,
                    f"emit({kind!r}) is not registered in EVENT_SCHEMA",
                    uri=kind, where=where))
        elif not any(re.fullmatch(pattern, k) for k in schema):
            out.append(finding(
                F.L001,
                f"no EVENT_SCHEMA kind matches the dynamic emit "
                f"pattern {_literal_part(pattern) or '<any>'!r}",
                uri=_literal_part(pattern), where=where))
    elif name in _METRIC_FNS:
        if "." not in _literal_part(pattern):
            return   # undotted: not a metric-style name
        if exact:
            mname = node.args[0].value
            if mname not in catalog:
                out.append(finding(
                    F.L002,
                    f"metric {mname!r} is not registered in "
                    "METRIC_CATALOG",
                    uri=mname, where=where))
        elif not any(re.fullmatch(pattern, m) for m in catalog):
            out.append(finding(
                F.L002,
                f"no METRIC_CATALOG name matches the dynamic metric "
                f"pattern {_literal_part(pattern)!r}",
                uri=_literal_part(pattern), where=where))


# ------------------------------------------------------------ lock discipline

def _lock_id(expr, klass: List[str], rel: str) -> Optional[str]:
    """Stable identity for a lock-like ``with`` context expression, or
    None when the expression does not look like a lock. ``self.*``
    locks are scoped to their class so same-named locks on different
    classes do not alias."""
    if isinstance(expr, ast.Call):
        return None   # transient (with Lock():) — nothing to order
    try:
        text = ast.unparse(expr)
    except Exception:                                  # pragma: no cover
        return None
    if not _LOCKY_RE.search(text):
        return None
    if text.startswith("self.") and klass:
        return f"{klass[-1]}::{text}"
    return f"{rel}::{text}"


class _LockScan(ast.NodeVisitor):
    """Per-file lexical lock tracking: held-lock stack across ``with``
    bodies, ``while``-ancestor depth for L012, blocking calls for L011,
    and acquisition-order pairs for the cross-file L010 aggregation."""

    def __init__(self, rel: str, pairs: Dict[Tuple[str, str], str],
                 out: List[Finding]):
        self.rel = rel
        self.pairs = pairs       # (outer, inner) -> first witness site
        self.out = out
        self.klass: List[str] = []
        self.held: List[Tuple[str, str, int]] = []  # (id, site, whiledepth)
        self.while_depth = 0

    # --------------------------------------------------------- scope walls
    def visit_ClassDef(self, node):
        self.klass.append(node.name)
        self.generic_visit(node)
        self.klass.pop()

    def _visit_function(self, node):
        # a nested def/lambda body does not run under the enclosing
        # with; its lock context starts empty
        saved, self.held = self.held, []
        saved_w, self.while_depth = self.while_depth, 0
        self.generic_visit(node)
        self.held, self.while_depth = saved, saved_w

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function
    visit_Lambda = _visit_function

    def visit_While(self, node):
        self.while_depth += 1
        self.generic_visit(node)
        self.while_depth -= 1

    def visit_With(self, node):
        acquired = 0
        for item in node.items:
            self.visit(item.context_expr)
            lid = _lock_id(item.context_expr, self.klass, self.rel)
            if lid is None or any(h[0] == lid for h in self.held):
                continue   # not a lock, or RLock re-entry
            site = f"{self.rel}:{item.context_expr.lineno}"
            for held_id, _, _ in self.held:
                self.pairs.setdefault((held_id, lid), site)
            self.held.append((lid, site, self.while_depth))
            acquired += 1
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        del self.held[len(self.held) - acquired:]

    visit_AsyncWith = visit_With

    # ------------------------------------------------------ blocking calls
    def visit_Call(self, node):
        if self.held:
            self._check_blocking(node)
        self.generic_visit(node)

    def _check_blocking(self, node: ast.Call):
        fn = node.func
        where = f"{self.rel}:{node.lineno}"
        innermost = self.held[-1]
        if isinstance(fn, ast.Name):
            if fn.id == "sleep":
                self.out.append(finding(
                    F.L011,
                    f"sleep() while holding {innermost[0]} (acquired at "
                    f"{innermost[1]})", where=where))
            return
        if not isinstance(fn, ast.Attribute):
            return
        recv_id = _lock_id(fn.value, self.klass, self.rel)
        if fn.attr == "wait":
            held_entry = next(
                (h for h in self.held if recv_id and h[0] == recv_id),
                None)
            if held_entry is not None:
                # condition-style wait: releases its own lock, so not a
                # blocking call — but it needs a predicate loop (L012)
                if self.while_depth == 0:
                    self.out.append(finding(
                        F.L012,
                        f"{ast.unparse(fn.value)}.wait() outside a "
                        f"while-predicate loop (lock acquired at "
                        f"{held_entry[1]})", where=where))
            elif not node.args and not node.keywords:
                self.out.append(finding(
                    F.L011,
                    f"untimed {ast.unparse(fn.value)}.wait() while "
                    f"holding {innermost[0]} (acquired at "
                    f"{innermost[1]}) — the wait does not release that "
                    f"lock", where=where))
            return
        if fn.attr in _BLOCKING_ATTRS:
            self.out.append(finding(
                F.L011,
                f"{ast.unparse(fn.value)}.{fn.attr}(...) while holding "
                f"{innermost[0]} (acquired at {innermost[1]})",
                where=where))
        elif (fn.attr in _PICKLE_FNS
              and isinstance(fn.value, ast.Name)
              and fn.value.id == "pickle"):
            self.out.append(finding(
                F.L011,
                f"pickle.{fn.attr}(...) while holding {innermost[0]} "
                f"(acquired at {innermost[1]})", where=where))


def _emit_order_findings(pairs: Dict[Tuple[str, str], str],
                         out: List[Finding]):
    """L010: every (A then B) order paired with a (B then A) witness."""
    reported = set()
    for (a, b), site_ab in sorted(pairs.items()):
        site_ba = pairs.get((b, a))
        if site_ba is None:
            continue
        key = (a, b) if a < b else (b, a)
        if key in reported:
            continue
        reported.add(key)
        out.append(finding(
            F.L010,
            f"inconsistent lock order: {a} then {b} at {site_ab}, but "
            f"{b} then {a} at {site_ba}",
            where=site_ab))


# -------------------------------------------------------------- entry points

class _Scan:
    """One lint pass: telemetry drift per file, lock pairs across
    files."""

    def __init__(self):
        from repro_torch.obs.events import EVENT_SCHEMA
        from repro_torch.obs.metrics import METRIC_CATALOG
        self.schema = EVENT_SCHEMA
        self.catalog = METRIC_CATALOG
        self.pairs: Dict[Tuple[str, str], str] = {}
        self.out: List[Finding] = []

    def add_file(self, text: str, rel: str):
        tree = ast.parse(text, filename=rel)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                _check_telemetry_call(node, rel, self.schema,
                                      self.catalog, self.out)
        _LockScan(rel, self.pairs, self.out).visit(tree)

    def finish(self) -> List[Finding]:
        _emit_order_findings(self.pairs, self.out)
        return self.out


def check_source(src_dir: Optional[str] = None) -> List[Finding]:
    """Lint every ``.py`` under ``src_dir`` (default: this tree's
    ``src/repro_torch/``): telemetry drift (L001/L002) and lock discipline
    (L010–L012, with acquisition orders aggregated across the whole
    tree so cross-module inversions are caught)."""
    src_dir = src_dir or default_src_dir()
    scan = _Scan()
    for root, _dirs, files in os.walk(src_dir):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, src_dir)
            with open(path, encoding="utf-8") as fh:
                scan.add_file(fh.read(), rel)
    return scan.finish()


def check_snippet(text: str, filename: str = "<snippet>") -> List[Finding]:
    """Lint one source snippet (the ``tests/defects/`` corpus entry
    point): same rules as :func:`check_source`, lock orders aggregated
    within the snippet only."""
    scan = _Scan()
    scan.add_file(text, filename)
    return scan.finish()
