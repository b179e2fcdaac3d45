"""Fabric quickstart on the PyTorch port: offload workflow steps into real
worker processes.

    PYTHONPATH=src python examples/torch_fabric_quickstart.py [--device cuda]

The counterpart of ``examples/fabric_quickstart.py`` on ``repro_torch``:
the port's offload fabric behind the cloud tier. A broker dispatches
remotable registry steps over loopback TCP to a pool of worker
subprocesses (``python -m repro_torch.cloud.worker``, numpy only), MDSS
transfers ship real bytes through the RPCTransport, the cost model learns
the observed wire bandwidth, and an autoscaler grows/shrinks the pool
with the queue. ``--device`` names the cloud tier's device; device steps
(none here) would run there in-process.
"""
import argparse
import os
import time

import numpy as np

from repro_torch.cloud import AutoscalerConfig, Fabric, attach
from repro_torch.core import (CostModel, EmeraldExecutor, MDSS,
                              MigrationManager, Workflow, default_tiers,
                              partition)


def build_workflow():
    # 1. Step implementations by name: every worker resolves these from
    #    repro_torch.cloud.tasklib at task time (lambdas can't cross
    #    processes). Here the built-in "matmul" step.
    # 2. `remote_impl` names the registry entry; fn=None means the local
    #    fallback also resolves from the registry.
    wf = Workflow("fabric_quickstart")
    wf.var("a")
    wf.var("b")
    wf.step("multiply", None, inputs=("a", "b"), outputs=("c",),
            remotable=True, device_step=False, remote_impl="matmul")
    wf.step("norm", lambda c: {"score": np.linalg.norm(c)},
            inputs=("c",), outputs=("score",), device_step=False)
    return wf


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the cloud tier's device")
    args = ap.parse_args()
    wf = build_workflow()

    # 3. Bring up the fabric: 2 workers now, autoscaling 1..4.
    with Fabric(workers=2, autoscaler=AutoscalerConfig(
            min_workers=1, max_workers=4)) as fabric:
        tiers = default_tiers(cloud_device=args.device)
        cost = CostModel(tiers)
        mdss = MDSS(tiers, cost_model=cost)
        attach(tiers, fabric, mdss=mdss, cost_model=cost)  # cloud tier backed

        ex = EmeraldExecutor(partition(wf), MigrationManager(tiers, mdss,
                                                             cost))
        rng = np.random.default_rng(0)
        a = rng.standard_normal((256, 256)).astype(np.float32)
        result = ex.run({"a": a, "b": a})

        print(f"driver pid {os.getpid()}, worker pids "
              f"{fabric.broker.worker_pids()}")
        print(f"score: {result['score']:.3f}")
        print("events:")
        for e in ex.events:
            extra = ""
            if e.kind == "offload":
                extra = (f"remote={e.info['remote']} "
                         f"pid={e.info['worker_pid']} "
                         f"bytes_in={e.info['bytes_in']} "
                         f"bytes_out={e.info['bytes_out']}")
            print(f"  {e.kind:<8s} {e.step:<12s} {e.tier:<6s} {extra}")
        print(f"mdss bytes moved: {dict(mdss.bytes_moved)}")
        bw = {k: f"{v / 1e6:.1f}MB/s" for k, v in cost.measured_bw.items()}
        print(f"observed wire bandwidth: {bw}")

        # 4. Elasticity: flood the broker and let the autoscaler react.
        tasks = [fabric.broker.submit(step="sleep",
                                      kwargs={"seconds": 0.2})
                 for _ in range(8)]
        act = fabric.autoscaler.tick()
        print(f"autoscaler after burst: {act}")
        for t in tasks:
            t.result(30)
        time.sleep(0.1)
        print(f"workers active={fabric.broker.num_workers()} "
              f"(incl warm={fabric.broker.num_workers(include_warm=True)}), "
              f"tasks done={fabric.broker.tasks_done}, "
              f"requeued={fabric.broker.tasks_requeued}")


if __name__ == "__main__":
    main()
