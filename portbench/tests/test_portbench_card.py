"""On the card: one short run of the scoring cell through the command the
benchmark's checks run, and its result line read back. Skips without a
card (the ``cuda_card`` fixture decides)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_short_scoring_run_reads_correct(cuda_card, trace):
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "falcon-mamba-7b.frontdoor",
         "--seed", str(2 ** 31 + 99 + trace), "--seconds", "3",
         "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["kind"] == cuda_card
    want = {"idle_share.frontdoor", "mfu.frontdoor",
            "batching.rows_per_flush.frontdoor",
            "selective_scan_fwd_roofline.frontdoor"} if trace \
        else {"setup_s", "request_p95_ms"}
    assert set(line["metrics"]) == want
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert list(line)[-1] == "compared"
    assert res.stderr.strip().splitlines()[-1].startswith("check ")
