"""The controls and the planted faults of each cell, read on the card.

    python3 portbench/tools/control.py --workload <cell> --seeds 11 12 13

For each seed: the plain reference in the configuration's precision (the
truth), the same reference one precision lower in the program's place
(the control: fp8 matrix products for a bf16 model), and, for training,
the reference with half of every batch left out (a planted fault). Each is read with the cell's own comparison
(``lib/checks.py``) at the cell's own sizes, and printed as one JSON line
per seed. These readings set the limits' upper ends (``PERF.md``). The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def train_readings(r) -> dict:
    from portbench.drivers.train import reference_readings
    from portbench.lib import checks, weights
    leaves = weights.mamba1_leaves(r.config)
    n = r.traffic["checked_steps"]
    truth = reference_readings(r, leaves, n)
    out = {"control": checks.train_numbers(
               reference_readings(r, leaves, n, quant="fp8"), truth),
           "half_batch": checks.train_numbers(
               reference_readings(r, leaves, n, rows=r.traffic["batch"] // 2),
               truth)}
    out["state_unchanged"] = {"change_gap": 1.0}
    return out


def frontdoor_readings(r) -> dict:
    import numpy as np
    import torch
    from portbench.drivers.frontdoor import pick_rows
    from portbench.lib import checks, traffic, weights
    from portbench.reference import mamba1
    mamba1.no_tf32()
    reqs = traffic.open_windows(r.traffic, r.seed, r.seconds, r.config["vocab_size"])
    picked = pick_rows(r, reqs, list(range(len(reqs))))
    w = weights.draw(weights.mamba1_leaves(r.config), r.seed, r.device)
    got, want = [], []
    for L in sorted({len(reqs[i]["tokens"]) for i in picked}):
        toks = torch.as_tensor(np.stack([reqs[i]["tokens"] for i in picked
                                         if len(reqs[i]["tokens"]) == L]),
                               device=r.device)
        with torch.no_grad():
            want.append(mamba1.logits(r.config, w, toks, last_only=True)
                        .double().cpu().numpy())
            got.append(mamba1.logits(r.config, w, toks, quant="fp8",
                                     last_only=True).double().cpu().numpy())
    return {"control": {"row_err": checks.row_error(np.concatenate(got),
                                                    np.concatenate(want))}}


def main(argv=None) -> int:
    from portbench.lib import harness as h
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    cell = h.find_cell(args.workload)
    h.cache_env()
    h.require_cards(cell["entry"]["chips"])
    driver = cell["spec"]["driver"]
    for seed in args.seeds:
        r = h.Run(types.SimpleNamespace(seed=seed, seconds=args.seconds,
                                        trace=0), cell)
        out = {"train": train_readings,
               "frontdoor": frontdoor_readings}[driver](r)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
        from portbench.drivers._shared import free_device
        free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
