"""emlint — Emerald's standalone workflow verifier + source self-lint.

Usage:
    python -m repro_torch.tools.emlint TARGET [TARGET ...]   lint workflows
    python -m repro_torch.tools.emlint --self      lint src/repro_torch
    python -m repro_torch.tools.emlint --list      print the rule catalogue

A TARGET is a dotted module name (``examples.quickstart``,
``benchmarks.bench_dag``) or a ``.py`` file path; append ``:attr`` to
lint one specific attribute. Workflows are collected from the imported
module:

  * every module-level :class:`Workflow` instance,
  * an ``EMLINT_WORKFLOWS`` attribute — an iterable of Workflow
    instances and/or zero-arg callables returning a Workflow (or a list
    of Workflows) — the convention for modules that only build
    workflows inside functions.

Exit status 1 when any error-severity finding fires (``--strict``: any
warning too). Lints statically (``provided=None``): explicitly declared
``wf.var(...)`` variables are assumed to be provided at submit time, so
only structurally certain defects block.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import sys
from typing import List, Tuple

from repro_torch.analysis import RULES, verify
from repro_torch.analysis.findings import ERROR, WARNING
from repro_torch.analysis.selfcheck import check_source
from repro_torch.core.workflow import Workflow


def import_target(target: str):
    """The module a TARGET names (dotted name or ``.py`` path) and the
    ``:attr`` suffix, if any."""
    mod_part, _, attr = target.partition(":")
    if mod_part.endswith(".py") or os.path.sep in mod_part:
        path = os.path.abspath(mod_part)
        name = os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(f"emlint_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(mod_part)
    return mod, attr


def as_workflows(obj) -> List[Workflow]:
    """Workflows from a Workflow, a zero-arg callable returning some, or
    a list or tuple of either."""
    if isinstance(obj, Workflow):
        return [obj]
    if callable(obj):
        return as_workflows(obj())
    if isinstance(obj, (list, tuple)):
        out = []
        for x in obj:
            out.extend(as_workflows(x))
        return out
    return []


def collect(target: str) -> List[Tuple[str, Workflow]]:
    """(label, workflow) pairs found in ``target``."""
    mod, attr = import_target(target)
    found: List[Tuple[str, Workflow]] = []
    if attr:
        wfs = as_workflows(getattr(mod, attr))
        if not wfs:
            raise SystemExit(
                f"emlint: {target}: attribute {attr!r} yields no Workflow")
        return [(f"{target}/{wf.name}", wf) for wf in wfs]
    for name, obj in sorted(vars(mod).items()):
        if isinstance(obj, Workflow):
            found.append((f"{target}/{obj.name}", obj))
    for obj in getattr(mod, "EMLINT_WORKFLOWS", ()):
        for wf in as_workflows(obj):
            found.append((f"{target}/{wf.name}", wf))
    if not found:
        raise SystemExit(
            f"emlint: {target}: no module-level Workflow and no "
            "EMLINT_WORKFLOWS attribute — nothing to lint")
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="emlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("targets", nargs="*",
                    help="modules / files building Workflows")
    ap.add_argument("--self", dest="selfcheck", action="store_true",
                    help="lint src/repro_torch for unregistered event "
                         "kinds and metric names, and lock discipline")
    ap.add_argument("--list", action="store_true",
                    help="print the rule catalogue and exit")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on warnings too, not just errors")
    args = ap.parse_args(argv)

    if args.list:
        for rid, info in sorted(RULES.items()):
            print(f"{rid}  {info.severity:<7}  {info.title}")
            print(f"      hint: {info.hint}")
        return 0

    findings = []
    if args.selfcheck:
        fs = check_source()
        for f in fs:
            print(str(f))
        print(f"emlint --self: {len(fs)} finding(s)")
        findings += fs
    for target in args.targets:
        for label, wf in collect(target):
            fs = verify(wf)
            for f in fs:
                print(f"{label}: {f}")
            print(f"emlint {label}: {len(fs)} finding(s), "
                  f"{len(wf.toplevel())} step(s)")
            findings += fs
    if not args.selfcheck and not args.targets:
        ap.error("nothing to do: pass targets and/or --self")

    blocking = [f for f in findings
                if f.severity == ERROR
                or (args.strict and f.severity == WARNING)]
    return 1 if blocking else 0


if __name__ == "__main__":
    sys.exit(main())
