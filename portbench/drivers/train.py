"""Training through the port's ``Trainer``: closed loop, step after step.

Set-up builds one ``Trainer`` on the seed's weights, hands it the seed's
batches, and drives its first ``checked_steps`` steps through ``fit(1)``,
the window's own call: the first ships the params and AdamW state to the
card. The window runs further ``fit(1)`` steps on the same object until
``--seconds`` have passed, ending at the end of a step. Afterwards the
plain reference follows the first steps from the same weights and
batches: each step's loss, each leaf's norm of the first clipped
gradient (the program's from AdamW's first moment after step 1) and of
the params' change after the checked steps.
"""
from __future__ import annotations

import contextlib

import torch


class Batches:
    """The Trainer's data source: the seed's batch ``i``, as the
    program's CPU tensors."""

    def __init__(self, seed: int, tr: dict, vocab: int):
        self.seed, self.tr, self.vocab = seed, tr, vocab

    def batch(self, i: int):
        from portbench.lib.traffic import lm_batch
        b = lm_batch(self.seed, i, self.tr["batch"], self.tr["seq"], self.vocab)
        return {k: torch.from_numpy(v) for k, v in b.items()}


def build(r):
    from portbench.drivers._shared import model_config
    from portbench.lib import weights
    from repro_torch.configs.base import RunConfig, ShapeProfile
    from repro_torch.launch.train import Trainer
    tr, hp = r.traffic, r.traffic["optimizer"]
    run_cfg = RunConfig(
        model=model_config(r.config),
        shape=ShapeProfile("train", tr["seq"], tr["batch"], "train"),
        remat=tr["remat"], grad_accum=tr["batch"] // hp["micro"],
        optimizer="adamw", opt_state_dtype="float32",
        learning_rate=hp["learning_rate"], weight_decay=hp["weight_decay"],
        grad_clip=hp["grad_clip"])
    leaves = weights.mamba1_leaves(r.config)
    drawn = weights.draw(leaves, r.seed, r.device)
    host = {k: v.to("cpu") for k, v in drawn.items()}
    del drawn
    trainer = Trainer(run_cfg, policy="annotate", seed=r.seed,
                      device="cpu" if r.device == "cpu" else None,
                      params=weights.nest(host))
    trainer.data = Batches(r.seed, tr, r.config["vocab_size"])
    return trainer, host, leaves


def program_readings(trainer, host, n_steps: int, b1: float, step_fn):
    """Run the checked steps through ``step_fn``; the program's loss per
    step, first-gradient norms per leaf and change norms per leaf."""
    from portbench.drivers._shared import leaf_norms
    from portbench.lib.weights import flatten
    grads = None
    for i in range(n_steps):
        step_fn(i)
        if i == 0:
            mu = flatten(trainer.mdss.peek_latest("opt_state")[0]["mu"])
            grads = leaf_norms(mu, 1.0 / (1.0 - b1))
            first = {k: v.float().cpu() / (1.0 - b1) for k, v in mu.items()}
            del mu
    params = flatten(trainer.mdss.peek_latest("params")[0])
    change = {k: float(torch.linalg.vector_norm(
        params[k].float() - host[k].to(params[k].device).float()))
        for k in params}
    return {"loss": [h["loss"] for h in trainer.history[:n_steps]],
            "grad_norm": grads, "change": change, "grads": first}


def reference_readings(r, leaves, n_steps: int, rows=None, quant=None,
                       keep_grads=True):
    from portbench.lib import traffic, weights
    from portbench.reference import mamba1
    mamba1.no_tf32()
    tr = r.traffic
    w = weights.draw(leaves, r.seed, r.device)
    batches = [traffic.lm_batch(r.seed, i, tr["batch"], tr["seq"],
                                r.config["vocab_size"]) for i in range(n_steps)]
    hp = dict(tr["optimizer"])
    return mamba1.train(r.config, w, batches, hp, quant=quant, rows=rows,
                        keep_grads=keep_grads)


def run(r):
    from portbench.drivers._shared import free_device, spans_of
    from portbench.lib import checks
    tr = r.traffic
    n_check = tr["checked_steps"]
    tokens = tr["batch"] * tr["seq"]
    trainer, host, leaves = build(r)
    r.note("trainer built")
    tracer = trainer.runtime.tracer
    r.program_spans = lambda: spans_of(tracer)

    def step(i, unit=None):
        n0 = len(trainer.runtime.tracer.spans())
        with r.span("train_step", step=i) as attrs:
            trainer.fit(1, log_every=0)
        if unit is not None:
            unit["spans"] = [(s.name, s.dur_s) for s in
                             trainer.runtime.tracer.spans()[n0:]
                             if s.attrs.get("step") == "train_step"]
            attrs["tokens"] = tokens

    try:
        prog = program_readings(trainer, host, n_check,
                                tr["optimizer"]["b1"], step)
        r.note(f"checked steps done: {prog['loss']}")
        r.open_window()
        i = n_check
        while True:
            unit = {"tokens": tokens}
            with (r.stretch() if not r.units
                  else contextlib.nullcontext()):
                step(i, unit)
            r.units.append(unit)
            i += 1
            if r.elapsed() >= r.seconds:
                break
        r.close_window()
        r.read_peak()
    finally:
        trainer.close()
    r.attempted, r.failed = len(r.units), 0
    r.e2e["setup_s"] = r.setup_s
    r.e2e["train_tokens_per_s"] = tokens * len(r.units) / r.window_s
    r.extra["n_params_no_embed"] = sum(
        v.numel() for k, v in host.items() if k != "embed/embedding")
    del trainer, host
    free_device()
    r.note(f"window closed: {len(r.units)} steps")
    ref = reference_readings(r, leaves, n_check)
    r.note("reference done")
    numbers = checks.train_numbers(prog, ref)
    r.note(f"readings {numbers}")
    r.extra["readings"] = numbers
    for name, limit in r.spec["check"].items():
        r.compare(name, numbers[name], limit)
