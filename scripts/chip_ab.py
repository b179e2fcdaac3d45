#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch port on one card, in turns.

    python3 scripts/chip_ab.py BASELINE_ROOT [CHANGE_ROOT]

Runs ``chip_smoke.py``'s FrontDoor phase (7, in front of full
tinyllama-1.1b) and its adjoint-tomography phase at Fig 11 (5, local
against offloaded) from each checkout, in the order baseline, change,
change, baseline, each in a fresh process from that checkout's root (so
each builds and loads its own kernels), and prints per run the FrontDoor
p50/p99 ms and wall s and the AT s/iteration of both arms, the reduction
and the kernel step's wall s. CHANGE_ROOT defaults to the current
directory. Needs one CUDA card; every phase's own checks still apply.
"""
import json
import subprocess
import sys

CODE = r'''
import sys
sys.path.insert(0, "."); sys.path.insert(0, "src")
import chip_smoke as cs
import torch
torch.backends.cuda.matmul.allow_tf32 = False
for m in cs.kernel_counters().values():
    m.build()
cfg, run = cs.serve_config("tinyllama-1.1b")
cs.phase_frontdoor(cfg, run)
from repro_torch.apps.adjoint_tomography import FIG11
cs.phase_at(FIG11)
'''


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    base, change = sys.argv[1], sys.argv[2] if len(sys.argv) == 3 else "."
    failed = 0
    for root in (base, change, change, base):
        res = subprocess.run([sys.executable, "-c", CODE], cwd=root,
                             capture_output=True, text=True, timeout=600)
        print("==", root, "rc", res.returncode, flush=True)
        for line in res.stdout.splitlines():
            line = line.strip()
            if line.startswith("frontdoor {"):
                d = json.loads(line[len("frontdoor "):])
                print("  fd", {k: d[k] for k in ("p50_ms", "p99_ms",
                                                 "wall_s", "flushes")},
                      flush=True)
            if line.startswith("at {"):
                d = json.loads(line[len("at "):])
                print("  at", {"local": d["local"]["s_per_iter"],
                               "off": d["offloaded"]["s_per_iter"],
                               "red": d["reduction"],
                               "ks_wall": d["kernel_step_on_card"]["wall_s"]},
                      flush=True)
        if res.returncode:
            failed += 1
            print(res.stdout[-3000:], res.stderr[-3000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
