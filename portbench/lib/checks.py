"""The numbers that decide ``correct``: the program's outputs against the
plain reference's. Each is a gap, 0 where they agree; the limits are in
each cell's file (``workloads/<cell>.json``, ``check``) with the readings
they were set from in ``PERF.md``.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional

import numpy as np

# a leaf whose reference gradient is under this share of the median
# leaf's moves under AdamW by round-off alone: left out of the change
GRAD_FLOOR = 1e-3


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def grad_error(prog: dict, ref: dict) -> float:
    """The worst leaf's norm of the difference of the first clipped
    gradients over the reference's norm of that leaf or of the median
    leaf, whichever is larger (tensors on the host)."""
    import torch
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in ref.items()}
    med = statistics.median(norms.values())
    return max(float(torch.linalg.vector_norm(prog[k].float() - ref[k]))
               / max(norms[k], med) for k in ref)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog/ref: ``loss`` per step, ``grad_norm`` per leaf (the first
    clipped gradient), ``change`` per leaf (after the last step), and
    ``grads``, the first clipped gradient itself."""
    gmed = statistics.median(ref["grad_norm"].values())
    moved = [k for k, g in ref["grad_norm"].items() if g >= GRAD_FLOOR * gmed]
    out = {"loss_gap": max(rel_gap(p, q) for p, q in
                           zip(prog["loss"], ref["loss"])),
           "grad_gap": leaf_gap(prog["grad_norm"], ref["grad_norm"]),
           "change_gap": leaf_gap(prog["change"], ref["change"], moved)}
    if prog.get("grads") is not None and ref.get("grads") is not None:
        out["grad_err"] = grad_error(prog["grads"], ref["grads"])
    return out


def row_error(got: np.ndarray, want: np.ndarray) -> float:
    """The worst row's relative L2 error (rows of logits)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(max(np.linalg.norm(g - w) / np.linalg.norm(w)
                     for g, w in zip(got, want)))
