"""Batched serving: prefill + decode loop as Emerald remotable steps.

The port of ``repro.launch.serve.Server``:

  * requests (token prompts) queue up; the server packs up to
    ``max_batch`` into a slot-based batch,
  * ``prefill`` (remotable) builds the KV caches on the serving tier,
  * ``decode`` (remotable) advances every active slot one token per call;
    finished slots (length budget) free up,
  * params + caches stay resident on the serving tier via MDSS — decode
    offloads are code-only; only the sampled tokens and the fetched
    logits cross the link,
  * both workflows execute over **one shared** :class:`EmeraldRuntime`.

The serving tier is the ``cloud`` tier: one H100 (``cuda:0``) unless the
caller names another device (``device="cpu"`` in the tests). Params and
fresh caches are handed in on the ``local`` tier (the host) and MDSS
ships them to the card. ``FrontDoor`` (request coalescing) comes with
``core/batching`` in a later slice.

CLI (full tinyllama-1.1b on the card, random weights from a seed):
  python -m repro_torch.launch.serve --arch tinyllama-1.1b
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
from repro_torch.core import (CostModel, EmeraldExecutor, EmeraldRuntime,
                              MDSS, MigrationManager, Workflow, default_tiers,
                              partition)
from repro_torch.models.model_zoo import Model

INTERACTIVE = 1          # dispatch class for latency-bound decodes


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,) int32
    max_new: int = 16
    tokens: List[int] = field(default_factory=list)
    done: bool = False


def _greedy(logits) -> torch.Tensor:
    # int32, as the reference's argmax: the tokens are MDSS values and
    # their bytes are accounted
    return torch.argmax(logits, -1).to(torch.int32)


class Server:
    def __init__(self, run: RunConfig, params, *, policy: str = "annotate",
                 max_batch: Optional[int] = None,
                 runtime: Optional[EmeraldRuntime] = None,
                 device=None):
        """``params`` live on the host (the ``local`` tier). ``device`` is
        the serving tier's device: ``cuda:0`` by default (raises without a
        card), ``"cpu"`` to serve on the host. Ignored with ``runtime``,
        whose tiers already name their devices."""
        self.run = run
        self.model = Model(run)
        self.policy = policy
        self.max_batch = max_batch or run.shape.global_batch
        self._owns_runtime = runtime is None
        if runtime is None:
            self.tiers = default_tiers(cloud_device=device)
            self.cost_model = CostModel(self.tiers)
            self.mdss = MDSS(self.tiers, cost_model=self.cost_model)
            self.manager = MigrationManager(self.tiers, self.mdss,
                                            self.cost_model)
            runtime = EmeraldRuntime(self.manager, policy=policy,
                                     name="serve")
        else:                    # tenant of an existing multi-tenant runtime
            self.manager = runtime.manager
            self.tiers = self.manager.tiers
            self.cost_model = self.manager.cost_model
            self.mdss = runtime.mdss
        self.runtime = runtime
        self._build_workflows()
        self.params = params
        self.queue: List[Request] = []
        self.stats = {"prefills": 0, "decode_calls": 0, "tokens_out": 0}

    def close(self):
        # a tenant never tears down a shared runtime it doesn't own
        if self._owns_runtime:
            self.runtime.close()

    def _build_workflows(self):
        prefill, decode = self.model.prefill, self.model.decode_step

        def prefill_fn(params, batch, cache):
            logits, cache = prefill(params, batch, cache)
            return {"logits": logits, "cache": cache}

        def decode_fn(params, tokens, cache):
            logits, cache = decode(params, tokens, cache)
            return {"logits": logits, "cache": cache}

        wfp = Workflow("serve-prefill")
        for v in ("params", "batch", "cache"):
            wfp.var(v)
        wfp.step("prefill", prefill_fn, inputs=("params", "batch", "cache"),
                 outputs=("logits", "cache"), remotable=True)
        wfd = Workflow("serve-decode")
        for v in ("params", "tokens", "cache"):
            wfd.var(v)
        wfd.step("decode", decode_fn, inputs=("params", "tokens", "cache"),
                 outputs=("logits", "cache"), remotable=True)
        # two typed front-ends over the ONE shared runtime: prefill and
        # decode interleave on the same lanes and MDSS
        self.ex_prefill = EmeraldExecutor(partition(wfp), self.manager,
                                          policy=self.policy,
                                          runtime=self.runtime)
        self.ex_decode = EmeraldExecutor(partition(wfd), self.manager,
                                         policy=self.policy,
                                         runtime=self.runtime)

    # ------------------------------------------------------------------ api
    def submit(self, req: Request):
        self.queue.append(req)

    def _pack(self, reqs: List[Request]):
        """Left-pad-free packing: common prefix length = min prompt len."""
        B = self.max_batch
        plen = min(len(r.prompt) for r in reqs)
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(reqs):
            toks[i] = r.prompt[:plen]
        return torch.from_numpy(toks), plen

    def step_batch(self) -> List[Request]:
        """Serve one packed batch from the queue to completion."""
        if not self.queue:
            return []
        reqs = self.queue[: self.max_batch]
        self.queue = self.queue[self.max_batch:]
        toks, plen = self._pack(reqs)
        local = self.tiers["local"].device
        out = self.ex_prefill.run(
            {"params": self.params, "batch": {"tokens": toks},
             "cache": self.model.init_cache(local)},
            fetch=("logits",))
        self.stats["prefills"] += 1
        last = _greedy(out["logits"])
        for i, r in enumerate(reqs):
            r.tokens.append(int(last[i]))
        max_new = max(r.max_new for r in reqs)
        budget = min(max_new - 1, self.run.shape.seq_len - plen - 1)
        for _ in range(budget):
            out = self.ex_decode.submit({"tokens": last}, fetch=("logits",),
                                        priority=INTERACTIVE).result()
            self.stats["decode_calls"] += 1
            last = _greedy(out["logits"])
            for i, r in enumerate(reqs):
                if not r.done and len(r.tokens) < r.max_new:
                    r.tokens.append(int(last[i]))
                    self.stats["tokens_out"] += 1
                else:
                    r.done = True
            if all(r.done or len(r.tokens) >= r.max_new for r in reqs):
                break
        for r in reqs:
            r.done = True
        return reqs

    def transfer_report(self) -> Dict:
        offloads = [e for e in self.ex_decode.events if e.kind == "offload"]
        return {"decode_offloads": len(offloads),
                "decode_code_only": sum(1 for e in offloads
                                        if e.info.get("code_only")),
                "bytes_moved": dict(self.mdss.bytes_moved)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the arch's tiny CPU-test config")
    ap.add_argument("--device", default=None,
                    help="serving device (default cuda:0; 'cpu' for the host)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = reduced(get_config(args.arch)) if args.reduced \
        else get_config(args.arch)
    run = RunConfig(model=cfg, shape=ShapeProfile("serve", 128, 4, "decode"),
                    remat="none")
    model = Model(run)
    params = model.init_params(torch.Generator().manual_seed(args.seed))
    srv = Server(run, params, device=args.device)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        srv.submit(Request(rid, rng.integers(
            0, cfg.vocab_size, rng.integers(8, 32)).astype(np.int32),
            max_new=args.max_new))
    t0 = time.time()
    done: List[Request] = []
    try:
        while srv.queue:
            done += srv.step_batch()
    finally:
        srv.close()
    dt = time.time() - t0
    for r in done:
        print(f"req {r.rid}: {len(r.tokens)} tokens -> {r.tokens[:8]}...")
    print(f"{srv.stats} in {dt:.2f}s; transfers: {srv.transfer_report()}")


if __name__ == "__main__":
    main()
