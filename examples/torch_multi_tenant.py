"""Two heterogeneous tenants — adjoint tomography + an LM scorer — on ONE
long-lived EmeraldRuntime of the PyTorch port, their offloaded steps on
the card.

The counterpart of ``examples/multi_tenant.py`` on ``repro_torch``:

  * the **AT tenant** iterates the 4-step inversion in its own MDSS
    namespace ``at`` — the updated model stays resident there between
    iterations, so every iteration after the first offloads code-only,
  * the **LM tenant** scores prompt batches against params published once
    to the *shared* namespace — every LM submission reads the same
    cloud-resident copy; submissions carry an interactive priority class
    and a higher fair-share weight,
  * both tenants interleave over the same lane pair: the runtime grants
    each free slot to the run with the smallest deficit-weighted share,
    so the wide AT iterations cannot starve the LM requests.

The LM's params are drawn on the host from a seeded ``torch.Generator``.

    PYTHONPATH=src python examples/torch_multi_tenant.py [--at-iters 6]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.apps.adjoint_tomography import (ATConfig, build_workflow,
                                                 make_observations,
                                                 starting_model)
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
from repro_torch.core import (CostModel, EmeraldRuntime, MDSS,
                              MigrationManager, Workflow, default_tiers)
from repro_torch.models.model_zoo import Model


def build_lm_workflow(model):
    """Score a prompt batch: remotable prefill + local argmax readout."""
    prefill = model.prefill

    def score(params, batch, cache):
        logits, _ = prefill(params, batch, cache)
        return {"logits": logits}

    def readout(logits):
        return {"top": torch.argmax(logits, -1)}

    wf = Workflow("lm-score")
    for v in ("params", "batch", "cache"):
        wf.var(v)
    wf.step("score", score, inputs=("params", "batch", "cache"),
            outputs=("logits",), remotable=True)
    wf.step("readout", readout, inputs=("logits",), outputs=("top",))
    return wf


def code_only(handle):
    """(code-only offloads, offloads) of one finished run."""
    offl = [e for e in handle.events if e.kind == "offload"]
    return sum(1 for e in offl if e.info.get("code_only")), len(offl)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--at-iters", type=int, default=6)
    ap.add_argument("--lm-requests", type=int, default=6)
    ap.add_argument("--nx", type=int, default=48)
    ap.add_argument("--device", default="cuda",
                    help="the cloud tier's device")
    args = ap.parse_args()

    tiers = default_tiers(cloud_device=args.device)
    cm = CostModel(tiers)
    mdss = MDSS(tiers, cost_model=cm)
    mgr = MigrationManager(tiers, mdss, cm)

    # --- tenant setup -----------------------------------------------------
    at_cfg = ATConfig(nx=args.nx, ny=max(args.nx // 4, 8),
                      nz=max(args.nx // 4, 8), nt=100)
    at_wf = build_workflow(at_cfg)              # built once, submitted N times

    lm_cfg = reduced(get_config("tinyllama-1.1b"), n_layers=2, d_model=64,
                     d_ff=128)
    lm_run = RunConfig(model=lm_cfg, shape=ShapeProfile("mt", 64, 2, "decode"),
                       remat="none")
    lm_model = Model(lm_run)
    lm_wf = build_lm_workflow(lm_model)
    rng = np.random.default_rng(0)

    with EmeraldRuntime(mgr, max_workers=6, name="multi-tenant") as rt:
        # warm cross-run data: published ONCE into the shared namespace,
        # read by every submission, cloud-resident after the first offload
        rt.publish("obs", make_observations(at_cfg, device="cpu"))
        rt.publish("params", lm_model.init_params(
            torch.Generator().manual_seed(0), device="cpu"))
        rt.publish("cache", lm_model.init_cache())

        t0 = time.time()
        # seed the AT namespace with the starting model; later iterations
        # read the previous update straight from namespace residency
        at_handle = rt.submit(at_wf, {"model": starting_model(at_cfg, "cpu")},
                              namespace="at", fetch=("chi",))
        lm_handles, at_handles, chis = [], [at_handle], []
        for j in range(args.lm_requests):
            batch = {"tokens": torch.from_numpy(rng.integers(
                0, lm_cfg.vocab_size, (2, 16)).astype(np.int32))}
            # interactive class + double fair-share weight: LM requests
            # overtake the batch AT tenant under lane contention
            lm_handles.append(rt.submit(lm_wf, {"batch": batch},
                                        weight=2.0, priority=1,
                                        fetch=("top",)))
            if at_handle.done():
                chis.append(float(at_handle.result()["chi"]))
                if len(chis) < args.at_iters:
                    at_handle = rt.submit(at_wf, {}, namespace="at",
                                          fetch=("chi",))
                    at_handles.append(at_handle)
        while len(chis) < args.at_iters:
            chis.append(float(at_handle.result(300)["chi"]))
            if len(chis) < args.at_iters:
                at_handle = rt.submit(at_wf, {}, namespace="at",
                                      fetch=("chi",))
                at_handles.append(at_handle)
        tops = [h.result(300)["top"] for h in lm_handles]
        dt = time.time() - t0

        # --- report -------------------------------------------------------
        print(f"{len(chis)} AT iterations + {len(tops)} LM scores in "
              f"{dt:.1f}s on one runtime ({rt.runs_completed} runs)")
        print(f"AT misfit: {chis[0]:.3e} -> {chis[-1]:.3e}")
        print(f"LM top tokens (req 0): {tops[0].cpu().numpy().ravel()[:8]}")
        print(f"compile-cache hits across runs: {mgr.compile_cache_hits}")
        print(f"code-only offloads per AT iteration: "
              f"{[code_only(h) for h in at_handles]}")
        for ns in ("shared", "at"):
            print(f"namespace {ns!r}: {len(mdss.namespace_entries(ns))} "
                  f"entries, {mdss.namespace_bytes(ns) / 1e6:.2f} MB moved")
        lm_ns_bytes = sum(v for k, v in mdss.ns_bytes_moved.items()
                          if k.startswith("run"))
        print(f"per-LM-run namespaces moved {lm_ns_bytes / 1e6:.2f} MB total "
              f"(params/cache stayed shared + resident)")


if __name__ == "__main__":
    main()


# emlint (python -m repro_torch.tools.emlint) collects these for static
# verification
def _emlint_wf():
    import types
    stub = types.SimpleNamespace(prefill=lambda params, batch, cache:
                                 (None, None))
    return build_lm_workflow(stub)


EMLINT_WORKFLOWS = [_emlint_wf]
