"""emcheck — deterministic schedule-space model checking for Emerald.

Usage:
    python -m repro_torch.tools.emcheck --model diamond --exhaustive
    python -m repro_torch.tools.emcheck --model diamond \\
        --bug duplicate_done --max-hazards 1 --minimize \\
        --out dup_done.repro.json
    python -m repro_torch.tools.emcheck --replay dup_done.repro.json
    python -m repro_torch.tools.emcheck --model two_tenant --samples 500 \\
        --seed 7
    python -m repro_torch.tools.emcheck --list-models
    python -m repro_torch.tools.emcheck mypkg.workflows    # module target

Modes:

  * ``--exhaustive`` (default for built-in models): DFS every
    interleaving up to ``--max-schedules``, with visited-state dedup
    and partial-order reduction. Reports whether the space was
    exhausted (full interleaving coverage) and the distinct-terminal
    coverage count.
  * ``--samples N``: seeded random schedule sampling with
    crash/preempt/ghost injection — for DAGs too large to exhaust.
    Identical ``--seed`` reproduces identical episodes.
  * ``--replay FILE``: strictly re-execute a serialized reproducer and
    exit 0 iff the recorded hazards re-trigger (1 otherwise) — the
    deterministic regression gate for minimized schedules.

A positional TARGET is a dotted module name or ``.py`` path (emlint's
collection convention: module-level Workflow instances and/or
``EMLINT_WORKFLOWS``); each collected workflow is checked as its own
single-tenant model. ``--bug`` plants a known defect
(``--list-bugs``) so the checker can be validated against it.

Exit status: 0 clean (or replay reproduced), 1 hazards found (or
replay failed to reproduce), 2 usage error.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

from repro_torch.analysis import explorer as ex
from repro_torch.core.workflow import Workflow
from repro_torch.tools.emlint import as_workflows, import_target


def collect(target: str) -> List[Tuple[str, Workflow]]:
    mod, attr = import_target(target)
    if attr:
        wfs = as_workflows(getattr(mod, attr))
        if not wfs:
            raise SystemExit(
                f"emcheck: {target}: attribute {attr!r} yields no Workflow")
        return [(f"{target}/{wf.name}", wf) for wf in wfs]
    found: List[Tuple[str, Workflow]] = []
    for name in dir(mod):
        if name.startswith("_"):
            continue
        obj = getattr(mod, name)
        if isinstance(obj, Workflow):
            found.append((f"{target}/{obj.name}", obj))
    for wf in as_workflows(getattr(mod, "EMLINT_WORKFLOWS", ())):
        found.append((f"{target}/{wf.name}", wf))
    if not found:
        raise SystemExit(f"emcheck: {target}: no Workflow instances found")
    return found


def _parse_param(kv: str):
    key, _, val = kv.partition("=")
    if not _ or not key:
        raise SystemExit(f"emcheck: bad --param {kv!r} (want key=value)")
    for cast in (int, float):
        try:
            return key, cast(val)
        except ValueError:
            continue
    return key, val


def _report(label: str, res: ex.ExploreResult, quiet: bool) -> None:
    mode = "exhausted" if res.exhaustive else "truncated"
    print(f"emcheck: {label}: {res.schedules} schedules ({mode}), "
          f"{len(res.coverage)} distinct terminal states, "
          f"{res.decisions} decisions, {res.deduped} deduped, "
          f"{res.por_pruned} POR-pruned, "
          f"{res.hazard_count} hazardous traces")
    if not quiet:
        for sched, findings in res.hazards[:5]:
            print(f"  schedule ({len(sched)} decisions): "
                  f"{' '.join(sched[:8])}{' ...' if len(sched) > 8 else ''}")
            for f in findings[:5]:
                print(f"    {f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="emcheck", add_help=True)
    ap.add_argument("targets", nargs="*",
                    help="module or file targets to collect workflows from")
    ap.add_argument("--model", action="append", default=[],
                    help="built-in model name (repeatable; --list-models)")
    ap.add_argument("--param", action="append", default=[],
                    metavar="K=V", help="model builder parameter")
    ap.add_argument("--bug", action="append", default=[],
                    help="plant a known defect (repeatable; --list-bugs)")
    ap.add_argument("--exhaustive", action="store_true",
                    help="DFS the full schedule space (default)")
    ap.add_argument("--samples", type=int, default=0,
                    help="random schedule sampling instead of DFS")
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed (identical seed => identical runs)")
    ap.add_argument("--max-schedules", type=int, default=20000)
    ap.add_argument("--max-hazards", type=int, default=0,
                    help="stop after this many hazardous traces (0 = all)")
    ap.add_argument("--no-por", action="store_true",
                    help="disable partial-order reduction")
    ap.add_argument("--no-dedup", action="store_true",
                    help="disable visited-state dedup")
    ap.add_argument("--resume-check", action="store_true",
                    help="run the H124 prefix-resume convergence check")
    ap.add_argument("--minimize", action="store_true",
                    help="delta-debug the first hazardous schedule")
    ap.add_argument("--out", metavar="FILE",
                    help="write a reproducer for the first hazard "
                         "(implies --minimize)")
    ap.add_argument("--replay", metavar="FILE",
                    help="replay a serialized reproducer")
    ap.add_argument("--list-models", action="store_true")
    ap.add_argument("--list-bugs", action="store_true")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.list_models:
        for name in sorted(ex.MODELS):
            doc = (ex.MODELS[name].__doc__ or "").strip().split("\n")[0]
            print(f"{name:12s} {doc}")
        return 0
    if args.list_bugs:
        for bug in ex.BUGS:
            print(bug)
        return 0

    if args.replay:
        doc = ex.load_reproducer(args.replay)
        findings, ok = ex.replay_reproducer(doc)
        rules = sorted({f.rule for f in findings})
        want = doc.get("hazards", [])
        if ok:
            print(f"emcheck: replay {args.replay}: reproduced "
                  f"{'+'.join(want)} in {len(doc['schedule'])} decisions")
            if not args.quiet:
                for f in findings:
                    print(f"  {f}")
            return 0
        print(f"emcheck: replay {args.replay}: FAILED to reproduce "
              f"{'+'.join(want)} (got {'+'.join(rules) or 'nothing'})")
        return 1

    models: List[Tuple[str, ex.SimModel]] = []
    params = dict(_parse_param(kv) for kv in args.param)
    for name in args.model:
        models.append((name, ex.build_model(name, bugs=args.bug, **params)))
    for target in args.targets:
        for label, wf in collect(target):
            models.append((label, ex.SimModel(
                [ex.Tenant("A", wf)], bugs=set(args.bug))))
    if not models:
        ap.error("nothing to check: give --model, a target, or --replay")

    worst = 0
    for label, model in models:
        if args.samples:
            res = ex.sample(model, schedules=args.samples, seed=args.seed,
                            resume_check=args.resume_check)
        else:
            res = ex.explore(
                model, max_schedules=args.max_schedules,
                por=not args.no_por, dedup=not args.no_dedup,
                resume_check=args.resume_check,
                max_hazards=args.max_hazards or None)
        _report(label, res, args.quiet)
        if res.hazards:
            worst = 1
            sched, findings = res.hazards[0]
            if args.minimize or args.out:
                sched = ex.minimize(model, sched,
                                    resume_check=args.resume_check)
                print(f"emcheck: {label}: minimized to {len(sched)} "
                      f"decisions: {' '.join(sched)}")
            if args.out:
                if not model.name:
                    print(f"emcheck: {label}: cannot serialize an ad-hoc "
                          f"module model; reproducers need a --model",
                          file=sys.stderr)
                    return 2
                ex.save_reproducer(args.out, model, sched, findings,
                                   minimized=args.minimize or bool(args.out),
                                   seed=args.seed if args.samples else None)
                print(f"emcheck: wrote reproducer {args.out}")
    return worst


if __name__ == "__main__":
    sys.exit(main())
