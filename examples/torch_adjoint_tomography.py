"""End-to-end adjoint tomography on the PyTorch port — the paper's
evaluation app (§4), its offloaded steps on the card.

The counterpart of ``examples/adjoint_tomography.py`` on ``repro_torch``:
the 4-step AT workflow (forward sim, misfit, Fréchet kernel, update) with
steps 2-4 offloaded, iterating "until the seismograms match", and the
Emerald event log + MDSS transfer savings per iteration. The model and
the observations start on the host (the local tier); ``--device`` names
the cloud tier's device.

    PYTHONPATH=src python examples/torch_adjoint_tomography.py [--iters 12]
"""
import argparse
import time

import torch

from repro_torch.apps.adjoint_tomography import (ATConfig, build_workflow,
                                                 make_observations,
                                                 starting_model, true_model)
from repro_torch.core import (CostModel, EmeraldExecutor, MDSS,
                              MigrationManager, default_tiers, partition)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--nt", type=int, default=150)
    ap.add_argument("--policy", default="annotate",
                    choices=["annotate", "cost_model", "never"])
    ap.add_argument("--device", default="cuda",
                    help="the cloud tier's device")
    args = ap.parse_args()

    cfg = ATConfig(nx=args.nx, ny=max(args.nx // 4, 8),
                   nz=max(args.nx // 4, 8), nt=args.nt)
    print(f"mesh {cfg.mesh_name}, {cfg.nt} timesteps; policy={args.policy}")
    obs = make_observations(cfg, device="cpu")

    tiers = default_tiers(cloud_device=args.device)
    cm = CostModel(tiers)
    mdss = MDSS(tiers, cost_model=cm)
    mgr = MigrationManager(tiers, mdss, cm)
    ex = EmeraldExecutor(partition(build_workflow(cfg)), mgr,
                         policy=args.policy)

    model = starting_model(cfg, device="cpu")
    chi0 = None
    t0 = time.time()
    for it in range(args.iters):
        mdss.reset_accounting()
        res = ex.run({"model": model, "obs": obs}, fetch=("model", "chi"))
        model = res["model"]
        chi = float(res["chi"])
        chi0 = chi0 or chi
        bar = "#" * max(1, int(40 * chi / chi0))
        moved = mdss.total_bytes_moved()
        print(f"iter {it:2d}  misfit {chi:10.3e}  {bar:<40s} "
              f"[{moved/1e6:6.2f} MB moved]")
    err = float(torch.sqrt(torch.mean(
        (model.cpu() - true_model(cfg, device="cpu")) ** 2)))
    print(f"\nfinal model RMS error vs true model: {err:.2f} m/s "
          f"({time.time()-t0:.1f}s total)")
    offl = [e for e in ex.events if e.kind == "offload"]
    print(f"offloads: {len(offl)} (steps 2-4 x {args.iters} iterations)")


if __name__ == "__main__":
    main()


# emlint (python -m repro_torch.tools.emlint) collects these for static
# verification
def _emlint_wf():
    return build_workflow(ATConfig(nx=16, ny=8, nz=8, nt=10))


EMLINT_WORKFLOWS = [_emlint_wf]
