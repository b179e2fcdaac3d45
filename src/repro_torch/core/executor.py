"""Emerald single-workflow executor — compat shim over the runtime.

Historically this module owned the event-driven dataflow loop. That loop
now lives in :mod:`repro_torch.core.runtime` as the multi-run dispatcher of
``EmeraldRuntime`` (one long-lived scheduler serving N concurrent
workflows over shared lanes); ``EmeraldExecutor`` keeps the original
one-workflow-at-a-time API by submitting into a runtime and blocking on
the handle:

  * constructed the classic way, ``run()`` spins up a private runtime for
    the call and tears it down after — identical lifecycle (and thread
    footprint) to the pre-runtime executor, with the same event stream
    (suspend/offload/resume alternation per step, retries, speculation,
    prefetch, per-completion checkpoints),
  * constructed with ``runtime=``, the executor becomes a typed front-end
    onto a *shared* runtime: several executors (e.g. a server's prefill
    and decode workflows) interleave over one scheduler, one fabric, one
    MDSS — see ``launch/serve.py``,
  * either way the MigrationManager is shared state, so compile caches
    and cost-model statistics survive across ``run()`` calls exactly as
    before.

Checkpoint mechanics are inherited from :class:`RunCheckpointer` — the
executor itself is the per-run checkpointer it hands to the runtime, so
the snapshot-cache invariants (and tests that instrument
``_save_checkpoint``) are preserved.

``Event`` and ``WorkflowFailure`` are defined in ``repro_torch.core.runtime``
and re-exported here for compatibility.

Fan-out steps work through the shim unchanged: the ``PartitionedWorkflow``
handed to the constructor was built by :func:`repro_torch.core.partitioner.
partition`, which expands every ``Fanout``-annotated step into
scatter/shard/gather before this module ever sees it — the executor
dispatches the shards as ordinary independent ready steps.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from repro_torch.core.migration import MigrationManager
from repro_torch.core.partitioner import PartitionedWorkflow
from repro_torch.core.runtime import (EmeraldRuntime, Event,  # noqa: F401
                                RunCheckpointer, RunHandle, WorkflowFailure)


class EmeraldExecutor(RunCheckpointer):
    def __init__(self, pwf: PartitionedWorkflow, manager: MigrationManager,
                 *, policy: str = "annotate", cloud_tier: str = "cloud",
                 max_workers: int = 8, local_workers: int = 4,
                 speculate_after: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None,
                 prefetch: bool = True,
                 runtime: Optional[EmeraldRuntime] = None):
        from repro_torch.core.scheduler import POLICIES
        assert policy in POLICIES
        self.pwf = pwf
        self.manager = manager
        RunCheckpointer.__init__(self, manager.mdss, pwf.workflow,
                                 checkpoint_dir)
        self.policy = policy       # resolved per run by the runtime
        self.cloud_tier = cloud_tier
        self.max_workers = max_workers
        self.local_workers = local_workers
        self.speculate_after = speculate_after
        self.prefetch = prefetch
        self._runtime = runtime           # shared runtime (None = per-run)
        # every run's events (including checkpoint events — submit rebinds
        # the checkpointer's _emit to the run's emitter) land here
        self.events: List[Event] = []
        self._live_handle: Optional[RunHandle] = None

    # ------------------------------------------------------------------- run
    def run(self, init_vars: Dict[str, Any], *, resume: bool = False,
            fetch=None):
        """Execute the workflow (blocking single-run API).

        ``fetch`` limits which variables are synced back to the local tier
        at re-integration (default: all). Leaving hot state (params,
        optimizer state) un-fetched keeps it resident on the cloud tier so
        the next run's offloads are code-only — the paper's MDSS saving.
        """
        return self.submit(init_vars, resume=resume, fetch=fetch).result()

    def submit(self, init_vars: Dict[str, Any], *, resume: bool = False,
               fetch=None, weight: float = 1.0, priority: int = 0
               ) -> RunHandle:
        """Non-blocking variant of :meth:`run` for shared-runtime use.

        With a private (per-call) runtime the handle's lifecycle owns the
        runtime teardown: the lanes are joined when the result resolves,
        exactly like the classic blocking ``run``.

        The executor is its own per-run checkpointer (one snapshot cache,
        one ``<wf>.wfckpt`` file), so with ``checkpoint_dir`` set its runs
        must not overlap — concurrent checkpointed submissions belong on
        ``EmeraldRuntime.submit`` (fresh checkpointer per run) or on
        separate executors.
        """
        if self.checkpoint_dir and self._live_handle is not None \
                and not self._live_handle.done():
            raise RuntimeError(
                "overlapping checkpointed submissions on one executor "
                "would corrupt its checkpoint; use EmeraldRuntime.submit "
                "or one executor per concurrent run")
        rt = self._runtime
        owned = rt is None
        reap = None
        if owned:
            rt = EmeraldRuntime(
                self.manager, policy=self.policy, cloud_tier=self.cloud_tier,
                max_workers=self.max_workers,
                local_workers=self.local_workers,
                speculate_after=self.speculate_after, prefetch=self.prefetch,
                name=f"emerald-{self.wf.name}")

            # tear the private runtime down when the run reaches ANY
            # terminal state (result, failure, cancel) — a caller that
            # never touches result() must not leak the driver + pools.
            # The hook is installed by submit() before the run is
            # enqueued, so even an instantly-finalizing run fires it.
            # close() joins the driver and pools, so the hook runs it on
            # a reaper thread, never on the finalizing thread itself.
            def reap(_handle, _rt=rt):
                threading.Thread(target=_rt.close, daemon=True,
                                 name=f"emerald-{self.wf.name}-reap").start()
        try:
            handle = rt.submit(self.pwf, init_vars, policy=self.policy,
                               fetch=fetch, resume=resume, weight=weight,
                               priority=priority, namespace="",
                               speculate_after=self.speculate_after,
                               prefetch=self.prefetch,
                               checkpointer=self, events=self.events,
                               on_done=reap)
        except BaseException:
            # submission itself failed (e.g. a corrupt checkpoint raising
            # in _load_checkpoint) — no run, no on_done hook, so close the
            # just-created private runtime here instead of leaking it
            if owned:
                rt.close()
            raise
        if owned:
            # result() additionally closes synchronously (idempotent) to
            # preserve the old pools-shut-before-run-returns contract
            handle._close_on_result = rt
        self._live_handle = handle
        return handle
