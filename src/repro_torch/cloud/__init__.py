"""Emerald offload fabric of the port: process-separated broker + worker
pool, the client/cloud-service split of ``repro_torch.cloud``:

    Workflow -> Executor -> MigrationManager
                                 |  tier.worker_pool (Fabric)
                                 v
       Broker --(length-prefixed pytree frames over loopback TCP)--> N
       worker subprocesses, heartbeat-monitored, crash-requeued,
       elastically autoscaled with warm-pool reuse.

``Fabric`` is the one-stop facade: it owns the pool, broker, autoscaler
and hands out the MDSS ``RPCTransport``. Attach it to a tier with
``attach(tiers, fabric)`` and the MigrationManager dispatches remotable
registry steps (``Step.remote_impl``) and picklable host steps through
real OS processes. Device steps stay in-process on the tier's device.
Workers run ``python -m repro_torch.cloud.worker`` and import numpy, not
torch.
"""
from __future__ import annotations

import pickle
from typing import Optional, Sequence

from repro_torch.cloud.autoscaler import Autoscaler, AutoscalerConfig  # noqa: F401
from repro_torch.cloud.broker import (Broker, FabricError,  # noqa: F401
                                      RemoteStepError, ShipTimeout, Task,
                                      WorkerLostError)
from repro_torch.cloud.pool import SpawnError, WorkerHandle, WorkerPool  # noqa: F401
from repro_torch.cloud.tasklib import STEP_REGISTRY, register_step, resolve  # noqa: F401
from repro_torch.cloud.wire import (BF16Bits, ChannelStore,  # noqa: F401
                                    ChunkStore, WireError, content_digest,
                                    decode, encode, manifest_of, recv_msg,
                                    send_msg)


def __getattr__(name):
    # RPCTransport pulls in repro_torch.core (torch); loaded lazily so
    # worker subprocesses importing this package stay numpy-only and spawn
    # fast.
    if name == "RPCTransport":
        from repro_torch.cloud.rpc_transport import RPCTransport
        return RPCTransport
    raise AttributeError(name)


class Fabric:
    """Pool + broker + autoscaler bundle, usable as a context manager."""

    def __init__(self, workers: int = 2, *,
                 init_modules: Sequence[str] = ("repro_torch.cloud.tasklib",),
                 max_attempts: int = 3, heartbeat_s: float = 0.25,
                 heartbeat_timeout_s: float = 5.0, replace_dead: bool = True,
                 autoscaler: Optional[AutoscalerConfig] = None,
                 dedup: bool = True):
        # dedup: content-addressed chunk dedup on every worker socket —
        # repeated payloads (warm params in task kwargs, ship echoes)
        # cross as digest references instead of bytes
        self.pool = WorkerPool(init_modules=init_modules,
                               heartbeat_s=heartbeat_s, dedup=dedup)
        self.broker = Broker(self.pool, max_attempts=max_attempts,
                             heartbeat_timeout_s=heartbeat_timeout_s,
                             replace_dead=replace_dead, dedup=dedup)
        self.autoscaler = Autoscaler(self.broker, autoscaler) \
            if autoscaler is not None else None
        self.broker.start_workers(workers)

    # ------------------------------------------------------ step dispatch
    def can_run(self, step) -> bool:
        """True if ``step`` can execute in a worker: a registry name, or a
        plain (host, picklable) function. Device steps stay in-process —
        their point is running on the tier's device, not process
        separation."""
        if getattr(step, "remote_impl", None):
            return True
        if getattr(step, "device_step", True) or step.fn is None:
            return False
        try:
            pickle.dumps(step.fn)
            return True
        except Exception:
            return False

    def submit_step(self, step, kwargs: dict,
                    max_attempts: Optional[int] = None,
                    priority: int = 0, trace_ctx=None) -> Task:
        # trace_ctx: (trace_id, span_id) of the driver-side span — rides
        # the task frame header so the worker's recv/exec/send phases
        # come back as child spans (see broker/worker)
        preemptible = bool(getattr(step, "preemptible", False))
        if getattr(step, "remote_impl", None):
            return self.broker.submit(step=step.remote_impl, kwargs=kwargs,
                                      max_attempts=max_attempts,
                                      priority=priority, trace_ctx=trace_ctx,
                                      preemptible=preemptible)
        return self.broker.submit(fn_bytes=pickle.dumps(step.fn),
                                  kwargs=kwargs, max_attempts=max_attempts,
                                  priority=priority, trace_ctx=trace_ctx,
                                  preemptible=preemptible)

    def ship(self, value, timeout: Optional[float] = 60.0) -> Task:
        return self.broker.ship(value, timeout=timeout)

    # ------------------------------------------------------------ plumbing
    def transport(self, tiers=None, cost_model=None):
        from repro_torch.cloud.rpc_transport import RPCTransport
        return RPCTransport(self, tiers=tiers, cost_model=cost_model)

    def shutdown(self):
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.broker.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


def attach(tiers, fabric: Fabric, tier_names: Sequence[str] = ("cloud",),
           mdss=None, cost_model=None):
    """Back ``tier_names`` with ``fabric`` and (optionally) swap the MDSS
    transport for the fabric's RPCTransport. Returns the transport."""
    for name in tier_names:
        tiers[name].worker_pool = fabric
    transport = fabric.transport(tiers=tiers, cost_model=cost_model)
    if mdss is not None:
        mdss.transport = transport
    return transport
