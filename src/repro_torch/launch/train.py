"""End-to-end trainer: LM training orchestrated as an Emerald workflow.

The port of ``repro.launch.train``. The training loop is a scientific
workflow (paper §2): the data step runs locally, and the
computation-intensive ``train_step`` is a *remotable* step the Emerald
runtime offloads to the cloud tier, one H100 (``cuda:0``) unless the
caller names another device (``device="cpu"`` in the tests). MDSS keeps
params and optimizer state resident on the card between iterations, so
after the first offload every iteration is **code-only**: only the batch
crosses the link, the paper's §3.4 saving, counted by
``mdss.bytes_moved``.

Checkpoints are written locally (disk is local hardware), which pulls
params back through MDSS only at checkpoint cadence.

CLI (a full config on the card, random weights from a seed; or its tiny
test config on the host):
  python -m repro_torch.launch.train --arch tinyllama-1.1b
  python -m repro_torch.launch.train --arch tinyllama-1.1b --reduced --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch import _tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
from repro_torch.core import (CostModel, EmeraldExecutor, EmeraldRuntime,
                              MDSS, MigrationManager, Workflow, default_tiers,
                              partition)
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.model_zoo import Model


@dataclass
class Trainer:
    """``device`` is the cloud tier's device: ``cuda:0`` by default
    (raises without a card), ``"cpu"`` to train on the host. ``params``
    are the initial params on the host; by default they are drawn from a
    ``torch.Generator`` seeded with ``seed`` on the cloud tier's device
    (the card draws a full model in well under a second) and placed on
    the host. Tests hand in params converted from the reference.
    ``telemetry=False`` builds the runtime with its spans and counters
    off (MDSS's included)."""
    run: RunConfig
    policy: str = "annotate"
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    seed: int = 0
    async_ckpt: bool = True
    device: Optional[str] = None
    params: Optional[Any] = None
    telemetry: bool = True

    def __post_init__(self):
        self.model = Model(self.run)
        self.data = SyntheticLMData(self.run.model, self.run.shape, self.seed)
        self.tiers = default_tiers(cloud_device=self.device)
        self.cost_model = CostModel(self.tiers)
        self.mdss = MDSS(self.tiers, cost_model=self.cost_model)
        self.manager = MigrationManager(self.tiers, self.mdss, self.cost_model)
        self.ckpt = (Checkpointer(self.ckpt_dir, mdss=self.mdss,
                                  async_save=self.async_ckpt)
                     if self.ckpt_dir else None)
        self.history: list = []
        self._live = False       # params/opt resident in MDSS across fit()s
        self._step = 0
        self._build_workflow()

    def _build_workflow(self):
        wf = Workflow("lm-train")
        wf.var("params").var("opt_state").var("batch")
        n_params = sum(math.prod(s.shape) for s in
                       _tree.tree_leaves(self.model.template))
        tokens = self.run.shape.global_batch * self.run.shape.seq_len
        wf.step("train_step", self._step_fn(),
                inputs=("params", "opt_state", "batch"),
                outputs=("params", "opt_state", "metrics"),
                remotable=True, flops_hint=6.0 * n_params * tokens,
                bytes_hint=2.0 * n_params)
        self.workflow = wf
        # one long-lived runtime across the whole fit loop: lanes and the
        # driver are set up once, not once per training step
        self.runtime = EmeraldRuntime(self.manager, policy=self.policy,
                                      name="train", telemetry=self.telemetry)
        self.executor = EmeraldExecutor(
            partition(wf), self.manager, policy=self.policy,
            runtime=self.runtime)

    def close(self):
        self.runtime.close()

    def _step_fn(self):
        step = self.model.train_step

        def fn(params, opt_state, batch):
            p, o, m = step(params, opt_state, batch)
            return {"params": p, "opt_state": o, "metrics": m}

        return fn

    def _initial_params(self):
        if self.params is not None:
            params, self.params = self.params, None
            return params
        gen = torch.Generator(device=self.tiers["cloud"].device)
        return self.model.init_params(gen.manual_seed(self.seed),
                                      device="cpu")

    # ------------------------------------------------------------------ api
    def fit(self, steps: int, *, resume: bool = False, log_every: int = 20):
        start = self._step
        init = {}
        if not self._live:
            params = opt_state = None
            if resume and self.ckpt and self.ckpt.latest_step("train") is not None:
                tmpl = {"params": self.model.abstract_params(),
                        "opt_state": self.model.abstract_opt_state()}
                state, meta = self.ckpt.restore("train", tmpl)
                params, opt_state = state["params"], state["opt_state"]
                start = meta["step"]
            if params is None:
                params = self._initial_params()
                opt_state = self.model.opt_init(params)
            init = {"params": params, "opt_state": opt_state}
            self._live = True
        t0 = time.time()
        for i in range(start, start + steps):
            init["batch"] = self.data.batch(i)
            out = self.executor.run(init, fetch=("metrics",))
            init = {}          # params/opt stay resident on the cloud tier
            m = {k: float(v) for k, v in out["metrics"].items()}
            m["step"] = i
            self.history.append(m)
            if log_every and (i % log_every == 0 or i == start + steps - 1):
                print(f"step {i:5d} loss {m['loss']:.4f} "
                      f"grad_norm {m['grad_norm']:.3f} "
                      f"({time.time()-t0:.1f}s)", flush=True)
            if self.ckpt and (i + 1) % self.ckpt_every == 0:
                self.save_checkpoint(i + 1)
        self._step = start + steps
        if self.ckpt:
            self.ckpt.wait()
        return self.history

    def save_checkpoint(self, step: int):
        tree = {"params": self.mdss.get("params", "local"),
                "opt_state": self.mdss.get("opt_state", "local")}
        self.ckpt.save("train", step, tree,
                       topology={"mesh": "host", "arch": self.run.model.name})

    # ------------------------------------------------------------- reporting
    def transfer_report(self) -> Dict:
        offloads = [e for e in self.executor.events if e.kind == "offload"]
        return {
            "offloads": len(offloads),
            "code_only": sum(1 for e in offloads if e.info.get("code_only")),
            "bytes_moved": dict(self.mdss.bytes_moved),
            "modeled_transfer_s": self.mdss.modeled_seconds,
        }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized same-family config")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--policy", default="annotate",
                    choices=["annotate", "cost_model", "never"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="the cloud tier's device (default cuda:0)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = ShapeProfile("cli", args.seq, args.batch, "train")
    run = RunConfig(model=cfg, shape=shape, remat="none",
                    learning_rate=args.lr)
    tr = Trainer(run, policy=args.policy, ckpt_dir=args.ckpt_dir,
                 device=args.device)
    try:
        tr.fit(args.steps, resume=args.resume)
        print("transfer report:", tr.transfer_report())
    finally:
        tr.close()


if __name__ == "__main__":
    main()
