"""Model API hub: config -> template, params, optimizer, caches and step
functions.

    model = Model(run_config)
    model.init_params(generator, device)    # real tensors
    model.abstract_params()                 # meta tensors (shapes, dtypes)
    model.opt_init / model.opt_update       # functional optimizer
    model.train_step                        # (params, opt, batch) -> ...
    model.eval_loss                         # (params, batch) -> metrics
    model.init_cache(device)                # zeroed decode caches
    model.prefill / model.decode_step       # serving step functions

The port of ``repro.models.model_zoo.Model``: no shardings and no dry-run
case yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import _tree
from repro_torch.configs.base import RunConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.params import init_params, torch_dtype
from repro_torch.optim.optimizers import clip_by_global_norm, make_optimizer
from repro_torch.optim.schedules import cosine_schedule


@dataclass
class Model:
    run: RunConfig

    def __post_init__(self):
        self.cfg = self.run.model
        self.template = tfm.model_template(self.cfg)
        self.opt_init, self.opt_update = make_optimizer(
            self.run.optimizer, state_dtype=self.run.opt_state_dtype,
            weight_decay=self.run.weight_decay)
        self.schedule = cosine_schedule(self.run.learning_rate)

    # ------------------------------------------------------------ parameters
    def init_params(self, generator: torch.Generator, device=None):
        return init_params(self.template, generator, self.cfg.param_dtype,
                           device)

    def abstract_params(self):
        """The params' shapes and dtypes, as tensors on the meta device
        (no storage)."""
        return _tree.tree_map(lambda s: torch.empty(
            s.shape, dtype=torch_dtype(s.dtype or self.cfg.param_dtype),
            device="meta"), self.template)

    def abstract_opt_state(self):
        return self.opt_init(self.abstract_params())

    # ----------------------------------------------------------------- cache
    def init_cache(self, device="cpu"):
        sp = self.run.shape
        enc_len = sp.seq_len if self.cfg.is_encoder_decoder else 0
        return tfm.init_cache(self.cfg, sp.global_batch, sp.seq_len, device,
                              enc_len=enc_len)

    # ------------------------------------------------------------ step fns
    # Steps run on the runtime's lane threads, and grad mode is per
    # thread: the mode is set inside each step.
    @property
    def train_step(self) -> Callable:
        cfg, run = self.cfg, self.run
        opt_update, schedule = self.opt_update, self.schedule

        def grads_of(params, batch):
            # gradients of detached copies: the tensors MDSS holds never
            # get requires_grad
            leaves = [p.detach().requires_grad_()
                      for p in _tree.tree_leaves(params)]
            with torch.enable_grad():
                loss, metrics = tfm.forward_train(
                    cfg, run, _tree.unflatten_like(params, leaves), batch)
                grads = torch.autograd.grad(loss, leaves)
            return list(grads), {k: v.detach() for k, v in metrics.items()}

        def step(params, opt_state, batch):
            if run.grad_accum > 1:
                # microbatch accumulation: equal slices of the global
                # batch's leading dim average exactly to the full-batch
                # gradient; the sums in float32, as the reference's
                n = run.grad_accum
                micro = [_tree.tree_map(lambda x: x.reshape(
                    (n, x.shape[0] // n) + x.shape[1:])[i], batch)
                    for i in range(n)]
                gsum, msum = grads_of(params, micro[0])
                gsum = [g.float() for g in gsum]
                for mb in micro[1:]:
                    g, m = grads_of(params, mb)
                    for acc, gi in zip(gsum, g):
                        acc.add_(gi)
                    msum = {k: msum[k] + m[k] for k in msum}
                    del g
                grads = [(g / n).to(p.dtype) for g, p in
                         zip(gsum, _tree.tree_leaves(params))]
                del gsum
                metrics = {k: v / n for k, v in msum.items()}
            else:
                grads, metrics = grads_of(params, batch)
            with torch.no_grad():
                grads, gnorm = clip_by_global_norm(
                    _tree.unflatten_like(params, grads), run.grad_clip)
                lr = schedule(opt_state["step"] + 1)   # 0-based counter
                params, opt_state = opt_update(params, grads, opt_state,
                                               lr=lr)
            metrics = dict(metrics, grad_norm=gnorm, lr=lr)
            return params, opt_state, metrics

        return step

    @property
    def eval_loss(self) -> Callable:
        cfg, run = self.cfg, self.run

        def fn(params, batch):
            with torch.no_grad():
                return tfm.forward_train(cfg, run, params, batch)[1]

        return fn

    @property
    def prefill(self) -> Callable:
        cfg, run = self.cfg, self.run

        def fn(params, batch, cache):
            with torch.no_grad():
                return tfm.forward_prefill(cfg, run, params, batch, cache)

        return fn

    @property
    def decode_step(self) -> Callable:
        cfg, run = self.cfg, self.run

        def fn(params, tokens, cache):
            with torch.no_grad():
                return tfm.forward_decode(cfg, run, params, tokens, cache)

        return fn
