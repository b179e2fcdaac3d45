"""Train a ~100M-parameter LM end-to-end through the Emerald workflow on
the PyTorch port, its train step on the card.

The counterpart of ``examples/train_lm.py`` on ``repro_torch``: the
training loop is the workflow; ``train_step`` is remotable; params and
optimizer state live on the cloud tier between steps (code-only
offloads). Checkpoints save locally every ``--ckpt-every`` steps (50 by
default) and the run is resumable. ``--reduced`` swaps the ~100M model
for the reduced tinyllama config (a smoke run on the host).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
"""
import argparse
import os
import tempfile

from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.configs.base import (ModelConfig, RunConfig, ShapeProfile,
                                      reduced)
from repro_torch.launch.train import Trainer

# ~100M params: 2*V*d + L*(4*d^2 + 3*d*ff) = 2*32000*512 + 12*(1M + 2.4M)
MODEL_100M = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=512, n_heads=8,
    n_kv_heads=4, head_dim=64, d_ff=1536, vocab_size=32000,
    dtype="float32", param_dtype="float32",
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "emerald-torch-lm-100m"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--policy", default="annotate")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced tinyllama config instead of ~100M")
    ap.add_argument("--device", default="cuda",
                    help="the cloud tier's device")
    args = ap.parse_args()

    cfg = reduced(get_config("tinyllama-1.1b")) if args.reduced \
        else MODEL_100M
    run = RunConfig(model=cfg,
                    shape=ShapeProfile("train", args.seq, args.batch, "train"),
                    remat="none", learning_rate=args.lr)
    tr = Trainer(run, policy=args.policy, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, device=args.device)
    n = sum(s.numel() for s in _tree.tree_leaves(tr.model.abstract_params()))
    print(f"model: {n/1e6:.1f}M params; {args.steps} steps "
          f"of {args.batch}x{args.seq} tokens")
    tr.fit(args.steps, resume=args.resume, log_every=10)
    print("transfer report:", tr.transfer_report())
    tr.close()


if __name__ == "__main__":
    main()
