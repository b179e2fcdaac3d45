"""Quickstart on the PyTorch port: build a cloud-offloading scientific
workflow in ~30 lines, its offloaded steps on the card.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda]

The counterpart of ``examples/quickstart.py`` on ``repro_torch``: the
same workflow, steps and printed lines; ``--device`` names the cloud
tier's device (``cpu`` runs it on the host).
"""
import argparse

import torch

from repro_torch.core import (CostModel, EmeraldExecutor, MDSS,
                              MigrationManager, Workflow, default_tiers,
                              partition)


def build_workflow():
    # 1. Declare the workflow: steps, dataflow variables, remotable
    #    annotations.
    wf = Workflow("quickstart")
    wf.var("signal")
    wf.step("prepare",
            lambda signal: {"spectrum": torch.fft.rfft(signal).real},
            inputs=("signal",), outputs=("spectrum",))
    wf.step("heavy_filter",                                   # offloaded
            lambda spectrum: {"filtered": torch.tanh(spectrum) * spectrum},
            inputs=("spectrum",), outputs=("filtered",), remotable=True)
    wf.step("heavy_energy",                           # offloaded, parallel
            lambda spectrum: {"energy": torch.sum(spectrum ** 2)},
            inputs=("spectrum",), outputs=("energy",), remotable=True)
    wf.step("report", lambda filtered, energy:
            {"summary": torch.stack([filtered.mean(), energy])},
            inputs=("filtered", "energy"), outputs=("summary",))
    return wf


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the cloud tier's device")
    args = ap.parse_args()
    wf = build_workflow()

    # 2. Partition: validates Properties 1-3, inserts migration points.
    pwf = partition(wf)
    print("migration points:", [m.name for m in pwf.migration_points])

    # 3. Execute: remotable steps offload to the cloud tier; parallel
    #    steps run concurrently; MDSS moves only stale data.
    tiers = default_tiers(cloud_device=args.device)
    cost = CostModel(tiers)
    mdss = MDSS(tiers, cost_model=cost)
    ex = EmeraldExecutor(partition(wf), MigrationManager(tiers, mdss, cost))
    result = ex.run({"signal": torch.linspace(0, 1, 4096)})

    print("summary:", result["summary"].cpu().numpy())
    print("events:")
    for e in ex.events:
        print(f"  {e.kind:<8s} {e.step:<14s} {e.tier}")
    print(f"bytes moved: {dict(mdss.bytes_moved)}")
    print(f"modeled transfer seconds: {mdss.modeled_seconds:.6f}")


if __name__ == "__main__":
    main()


# emlint (python -m repro_torch.tools.emlint) collects these for static
# verification
EMLINT_WORKFLOWS = [build_workflow]
