"""Serve a small LM with batched requests through Emerald remotable steps
on the PyTorch port, the steps on the card.

The counterpart of ``examples/serve_lm.py`` on ``repro_torch``:
continuous-batching-lite (requests queue, pack into slots, prefill once,
decode until done); params + KV caches stay resident on the serving tier.
The same reduced config (4 layers, d_model 128); the params are drawn on
the host from a seeded ``torch.Generator`` (torch's RNG does not
reproduce ``jax.random``). ``python -m repro_torch.launch.serve`` serves
the full configs.

    PYTHONPATH=src python examples/torch_serve_lm.py --requests 12
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
from repro_torch.launch.serve import Request, Server
from repro_torch.models.model_zoo import Model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="the serving tier's device")
    args = ap.parse_args()

    cfg = reduced(get_config(args.arch), n_layers=4, d_model=128)
    run = RunConfig(model=cfg,
                    shape=ShapeProfile("serve", 256, args.batch, "decode"),
                    remat="none")
    params = Model(run).init_params(torch.Generator().manual_seed(0),
                                    device="cpu")
    srv = Server(run, params, device=args.device)

    rng = np.random.default_rng(7)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              int(rng.integers(8, 64))).astype(np.int32)
        srv.submit(Request(rid, prompt, max_new=args.max_new))

    t0 = time.time()
    finished = []
    while srv.queue:
        batch = srv.step_batch()
        finished += batch
        print(f"batch done: {[r.rid for r in batch]} "
              f"({srv.stats['tokens_out']} tokens so far)")
    dt = time.time() - t0
    tok = srv.stats["tokens_out"]
    print(f"\n{len(finished)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok/dt:.1f} tok/s on {args.device})")
    print("stats:", srv.stats)
    print("transfers:", srv.transfer_report())
    srv.close()


if __name__ == "__main__":
    main()
