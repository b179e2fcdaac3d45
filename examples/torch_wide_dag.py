"""Wide heterogeneous DAG through the port's event-driven executor.

    PYTHONPATH=src python examples/torch_wide_dag.py [--device cuda]

The counterpart of ``examples/wide_dag.py`` on ``repro_torch``: four
independent offloadable sources with a 10:1 runtime spread, the fast
sources feeding short chains of follow-up steps, one reduce joining
everything. The completion-triggered runtime dispatches (and prefetches
the inputs of) the fast branches' successors while the long pole is still
running, so the makespan tracks the critical path instead of
sum-of-wave-maxima. ``--device`` names the cloud tier's device.
"""
import argparse
import time

import numpy as np

from repro_torch.core import (CostModel, EmeraldExecutor, MDSS,
                              MigrationManager, Workflow,
                              critical_path_lengths, default_tiers,
                              partition)


def sleeper(name, seconds, out):
    def fn(**kw):
        time.sleep(seconds)
        return {out: np.float64(seconds)}
    return fn


def build_workflow():
    # 1. Four sources: 0.05s, 0.05s, 0.05s and a 0.5s long pole. Each fast
    #    source feeds a 2-deep chain; the reduce joins all tails.
    wf = Workflow("wide")
    wf.var("x")
    tails = []
    for i, dur in enumerate((0.05, 0.05, 0.05, 0.5)):
        wf.step(f"src{i}", sleeper(f"src{i}", dur, f"y{i}"), inputs=("x",),
                outputs=(f"y{i}",), remotable=True, device_step=False)
        tail = f"y{i}"
        if dur < 0.5:
            for c in range(2):
                nm = f"mid{i}_{c}"
                wf.step(nm, sleeper(nm, 0.1, f"y_{nm}"), inputs=(tail,),
                        outputs=(f"y_{nm}",), remotable=True,
                        device_step=False)
                tail = f"y_{nm}"
        tails.append(tail)
    wf.step("reduce", sleeper("reduce", 0.05, "y_r"), inputs=tuple(tails),
            outputs=("y_r",), remotable=True, device_step=False)
    return wf


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the cloud tier's device")
    args = ap.parse_args()
    wf = build_workflow()

    # 2. Dispatch priorities: critical-path length first.
    print("critical-path priorities (dispatch order under contention):")
    for name, cpl in sorted(critical_path_lengths(wf).items(),
                            key=lambda kv: -kv[1]):
        print(f"  {name:<10s} {cpl:.1f}")

    # 3. Run. Wave-barrier bound would be 0.5 + 2*0.1 + 0.05 = 0.75s; the
    #    critical path (and the event-driven makespan) is 0.5 + 0.05 = 0.55s.
    tiers = default_tiers(cloud_device=args.device)
    cm = CostModel(tiers)
    mdss = MDSS(tiers, cost_model=cm)
    ex = EmeraldExecutor(partition(wf), MigrationManager(tiers, mdss, cm))
    t0 = time.perf_counter()
    ex.run({"x": np.float64(0.0)})
    makespan = time.perf_counter() - t0
    print(f"\nmakespan: {makespan * 1e3:.0f} ms "
          f"(critical path 550 ms, wave barrier would pay ~750 ms)")

    # 4. The event log shows per-step suspend -> offload -> resume
    #    (Property 3) interleaved across steps — e.g. mid0_0 resumes long
    #    before src3 does.
    print("\nevent log:")
    t_first = ex.events[0].t
    for e in ex.events:
        if e.kind in ("suspend", "offload", "resume", "prefetch"):
            print(f"  t={1e3 * (e.t - t_first):6.0f}ms {e.kind:<9s} "
                  f"{e.step}")


if __name__ == "__main__":
    main()


# emlint (python -m repro_torch.tools.emlint) collects these for static
# verification
EMLINT_WORKFLOWS = [build_workflow]
