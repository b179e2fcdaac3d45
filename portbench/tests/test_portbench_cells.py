"""Each cell's driver run on the CPU at a tiny size, past the harness's
look for a card: sound, it agrees with the plain reference and reads
``correct``; with the timed path broken underneath (a planted fault), it
reads not correct. The control (the reference one precision lower in the
program's place) is held at a tiny size here; on the card it runs at the
cell's size (``tools/control.py``).
"""
import copy
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.lib import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = {p.stem: json.loads(p.read_text())
         for p in (ROOT / "portbench" / "workloads").glob("*.json")}

TINY_LM = {"program_arch": "falcon-mamba-7b", "num_hidden_layers": 2,
           "hidden_size": 64, "intermediate_size": 128, "state_size": 8,
           "conv_kernel": 4, "time_step_rank": 8, "vocab_size": 256,
           "torch_dtype": "float32", "layer_norm_epsilon": 1e-5,
           "tie_word_embeddings": False}
TINY_TRAFFIC = {
    "train": {"seq": 32, "batch": 4, "optimizer": {"micro": 2}},
    "frontdoor": {"rate_per_s": 15.0, "lengths": [8, 16, 32],
                  "warm_batches": [1, 2], "checked_per_length": 3},
}


def tiny(driver: str):
    name, spec = next((n, s) for n, s in CELLS.items() if s["driver"] == driver)
    spec = copy.deepcopy(spec)
    for k, v in TINY_TRAFFIC[driver].items():
        if isinstance(v, dict):
            spec["traffic"][k].update(v)
        else:
            spec["traffic"][k] = v
    return spec, dict(TINY_LM)


def run_driver(driver: str, seed=11, seconds=1.5, config=None):
    spec, conf = tiny(driver)
    cell = {"entry": {"chips": 1}, "spec": spec, "config": config or conf,
            "end_to_end": [], "per_layer": [], "readers": {}}
    r = harness.Run(types.SimpleNamespace(seed=seed, seconds=seconds, trace=0),
                    cell, device="cpu")
    mod = harness.load_module(harness.BENCH / "drivers" / f"{driver}.py",
                              f"t_cells_{driver}")
    mod.run(r)
    return r


def values(r):
    return {k: c["value"] for k, c in r.compared.items()}


# ------------------------------------------------------------- sound runs
def test_train_agrees_with_reference():
    r = run_driver("train")
    v = values(r)
    assert r.correct and r.attempted >= 1, v
    assert v["grad_err"] < 1e-4 and v["grad_gap"] < 1e-4 and v["change_gap"] < 1e-4
    assert r.extra["readings"]["loss_gap"] < 1e-5


def test_frontdoor_agrees_with_reference():
    r = run_driver("frontdoor")
    v = values(r)
    assert r.correct and r.failed == 0 and r.attempted >= 10, v
    assert v["row_err"] < 1e-5


# --------------------------------------------------------- planted faults
def _state_unchanged_train(monkeypatch):
    from repro_torch.models.model_zoo import Model
    real = Model.train_step

    def broken(self):
        step = real.fget(self)

        def fn(params, opt_state, batch):
            _, _, metrics = step(params, opt_state, batch)
            return params, opt_state, metrics
        return fn
    monkeypatch.setattr(Model, "train_step", property(broken))


def _state_unchanged_from_step_2(monkeypatch):
    """The first step writes its state back; every later one returns the
    state it was given (a write-back that stops once the state has made
    one round trip)."""
    from repro_torch.models.model_zoo import Model
    real = Model.train_step
    calls = [0]

    def broken(self):
        step = real.fget(self)

        def fn(params, opt_state, batch):
            calls[0] += 1
            new_p, new_s, metrics = step(params, opt_state, batch)
            if calls[0] == 1:
                return new_p, new_s, metrics
            return params, opt_state, metrics
        return fn
    monkeypatch.setattr(Model, "train_step", property(broken))


def _half_batch_train(monkeypatch):
    from repro_torch.models.model_zoo import Model
    real = Model.grads

    def grads(self, params, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return real(self, params, half)
    monkeypatch.setattr(Model, "grads", grads)


def _answer_altered_lm(monkeypatch):
    from repro_torch.models import transformer as tfm
    real = tfm.forward_prefill

    def prefill(*a, **k):
        logits, cache = real(*a, **k)
        bumped = logits.clone()
        bumped[0] += logits.std()
        return bumped, cache
    monkeypatch.setattr(tfm, "forward_prefill", prefill)


@pytest.mark.parametrize("driver,fault", [
    ("train", _state_unchanged_train), ("train", _state_unchanged_from_step_2),
    ("train", _half_batch_train), ("frontdoor", _answer_altered_lm),
], ids=["train-state-unchanged", "train-state-unchanged-from-step-2",
        "train-half-batch", "frontdoor-answer-altered"])
def test_planted_fault_reads_not_correct(monkeypatch, driver, fault):
    fault(monkeypatch)
    r = run_driver(driver)
    assert not r.correct, r.compared


# ---------------------------------------------------------------- controls
# The controls' errors grow with depth and vocabulary: the scoring
# control is held at the published depth over narrow widths, the training
# control at 4 layers.
CONTROL_LM = dict(TINY_LM, num_hidden_layers=64, hidden_size=256,
                  intermediate_size=512, state_size=16, time_step_rank=16,
                  vocab_size=16384, torch_dtype="bfloat16")
CONTROL_TRAIN = dict(CONTROL_LM, num_hidden_layers=4, vocab_size=4096)


def _reading_run(driver):
    spec, conf = tiny(driver)
    conf = CONTROL_TRAIN if driver == "train" else CONTROL_LM
    if driver == "frontdoor":
        spec["traffic"]["lengths"] = [16, 32, 64]
    cell = {"entry": {"chips": 1}, "spec": spec, "config": conf,
            "end_to_end": [], "per_layer": [], "readers": {}}
    return harness.Run(types.SimpleNamespace(seed=13, seconds=1.5, trace=0),
                       cell, device="cpu"), spec["check"]


@pytest.mark.parametrize("driver", ["train", "frontdoor"])
def test_control_fails_the_cells_limits(driver):
    from portbench.tools import control
    r, limits = _reading_run(driver)
    read = {"train": control.train_readings,
            "frontdoor": control.frontdoor_readings}[driver](r)
    got = read["control"]
    assert any(got[k] > limits[k] for k in got if k in limits), (got, limits)
