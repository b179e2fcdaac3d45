"""Emerald correctness tooling on PyTorch: static verifier + dynamic
sanitizer + schedule-space explorer + source self-lint.

Four entry points, one finding model (``repro_torch.analysis.findings``):

  * :func:`verify` — rule-based static lint over a :class:`Workflow`
    (cycles with witness paths, dataflow races, offloadability,
    memo-safety, residency-budget feasibility, dead code). Runs at
    admission via ``EmeraldRuntime.submit(validate=...)`` and standalone
    via ``python -m repro_torch.tools.emlint``.
  * :mod:`sanitizer` — happens-before checker over a run's event log
    and the MDSS replica-install log (``sanitizer.check(events)``,
    ``sanitizer.check_store(mdss)``); ``sanitizer.record_submissions()``
    replays every runtime submission made inside it.
  * :mod:`selfcheck` — source lint keeping ``emit(`` kinds and metric
    names in lockstep with their registries, plus the AST lock-
    discipline pass (acquisition order, blocking-under-lock,
    predicate-loop waits) over ``src/repro_torch`` (``emlint --self``).
  * :mod:`explorer` — deterministic schedule-space model checking
    (``python -m repro_torch.tools.emcheck``): every explored
    interleaving replays through the sanitizer plus cross-schedule
    invariants (H120–H126), and hazardous schedules minimize to
    replayable reproducer files.

This package depends only on ``repro_torch.core.workflow`` /
``repro_torch.core.migration`` / ``repro_torch.obs`` at import — never
on the runtime — so the runtime can import it for admission-time
validation without a cycle.
"""
from repro_torch.analysis import explorer, sanitizer, selfcheck  # noqa: F401
from repro_torch.analysis.findings import (ERROR, INFO, RULES, WARNING,  # noqa: F401
                                           Finding, RuleInfo, max_severity)
from repro_torch.analysis.verifier import WorkflowRejected, verify  # noqa: F401
