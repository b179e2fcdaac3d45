"""Registered step functions executable inside fabric workers.

Workers cannot unpickle closures or lambdas, so the fabric's primary
dispatch currency is a *registry name*: a step declares
``remote_impl="matmul"`` and every worker resolves it here at task time
(workers import this module — and any extra ``--init`` modules — at
startup). Functions take the step's input URIs as kwargs and return a
dict keyed by output URI, same contract as an in-process step fn, so the
MigrationManager can run the identical function locally as a fallback
tier.

numpy-only on purpose: this module is imported by every worker process
and must not drag torch in.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import numpy as np

STEP_REGISTRY: Dict[str, Callable] = {}

# Set in the worker process environment by pool.spawn; lets a task know it
# is running inside a fabric worker (used by fault-injection steps that
# must be lethal remotely but harmless when re-run in-process).
WORKER_ENV = "EMERALD_WORKER_ID"


def register_step(name: Optional[str] = None):
    def wrap(fn):
        STEP_REGISTRY[name or fn.__name__] = fn
        return fn
    return wrap


def resolve(name: str) -> Callable:
    try:
        return STEP_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"step {name!r} not registered; known: {sorted(STEP_REGISTRY)}")


def in_worker() -> bool:
    return bool(os.environ.get(WORKER_ENV))


# ------------------------------------------------------------ demo steps
@register_step("echo")
def echo(**kw):
    return kw


@register_step("pid")
def pid(**kw):
    return {"pid": np.int64(os.getpid())}


@register_step("add_one")
def add_one(x=0.0, **kw):
    return {"y": np.asarray(x, dtype=np.float64) + 1.0}


@register_step("matmul")
def matmul(a=None, b=None, **kw):
    return {"c": np.asarray(a) @ np.asarray(b)}


@register_step("sleep")
def sleep(seconds=0.05, **kw):
    time.sleep(float(np.asarray(seconds)))
    return {"slept": np.float64(seconds)}


@register_step("spin")
def spin(seconds=0.05, **kw):
    """Busy-wait — holds a whole worker process, unlike ``sleep``."""
    end = time.perf_counter() + float(np.asarray(seconds))
    x = 0.0
    while time.perf_counter() < end:
        x += 1.0
    return {"spun": np.float64(seconds)}


# ----------------------------------------------------- fault injection
def _bump_counter(path: str) -> int:
    """File-based counter so fault schedules survive worker crashes."""
    try:
        with open(path) as f:
            count = int(f.read() or 0)
    except FileNotFoundError:
        count = 0
    with open(path, "w") as f:
        f.write(str(count + 1))
    return count


@register_step("crash_n_times")
def crash_n_times(counter_file="", n_crashes=1, x=0.0, **kw):
    """Hard-kill the hosting worker for the first ``n_crashes`` calls, then
    succeed — deterministic across processes via ``counter_file``."""
    n = int(np.asarray(n_crashes))
    if _bump_counter(str(counter_file)) < n:
        os._exit(17)
    return {"y": np.asarray(x, dtype=np.float64) + 1.0}


@register_step("fail_n_times")
def fail_n_times(counter_file="", n_fails=1, x=0.0, **kw):
    """Raise (clean remote error, worker survives) for the first
    ``n_fails`` calls, then succeed."""
    n = int(np.asarray(n_fails))
    if _bump_counter(str(counter_file)) < n:
        raise RuntimeError("injected step failure")
    return {"y": np.asarray(x, dtype=np.float64) + 1.0}


@register_step("crash_in_worker")
def crash_in_worker(x=0.0, **kw):
    """Kill the process when running inside a fabric worker; succeed when
    re-run in-process — exercises the executor's tier-fallback path."""
    if in_worker():
        os._exit(17)
    return {"y": np.asarray(x, dtype=np.float64) * 10.0}
