"""A measurement path without a card fails: it prints no result and exits
with another code than 0, and never falls back to the CPU."""
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

from portbench.lib import harness

ROOT = Path(__file__).resolve().parents[2]


def _no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the path without one")


def test_run_without_a_card_prints_no_result():
    _no_card()
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "falcon-mamba-7b.frontdoor",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    for line in res.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
    assert "no CUDA device" in res.stderr


def test_require_cards_refuses():
    _no_card()
    with pytest.raises(SystemExit):
        harness.require_cards(1)


def test_traced_stretch_is_never_taken_on_the_cpu():
    cell = {"entry": {"chips": 1}, "spec": {"traffic": {}}, "config": {},
            "end_to_end": [], "per_layer": [], "readers": {}}
    r = harness.Run(types.SimpleNamespace(seed=1, seconds=1, trace=1), cell,
                    device="cpu")
    with r.stretch():
        pass
    assert r.profile is None


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell("no-such-cell")


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("x"))
    assert "repro_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("y"))
    assert "jax" in harness.forbidden_modules()
