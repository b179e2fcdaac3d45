"""Emerald correctness tooling on PyTorch: the static verifier that
``EmeraldRuntime.submit`` runs at admission, with its finding model.

The sanitizer, schedule-space explorer and self-check of
``repro.analysis`` come in a later slice.
"""
from repro_torch.analysis.findings import (ERROR, INFO, RULES, WARNING,  # noqa: F401
                                           Finding, RuleInfo, max_severity)
from repro_torch.analysis.verifier import WorkflowRejected, verify  # noqa: F401
