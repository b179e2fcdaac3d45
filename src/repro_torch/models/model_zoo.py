"""Model API hub: config -> template, params, shardings, optimizer, caches
and step functions.

    model = Model(run_config)
    model.init_params(generator, device)    # real tensors
    model.abstract_params()                 # meta tensors (shapes, dtypes)
    model.param_pspecs(mesh)                # PSpec tree (any mesh)
    model.param_shardings(mesh)             # NamedSharding tree (live mesh)
    model.opt_init / model.opt_update       # functional optimizer
    model.train_step                        # (params, opt, batch) -> ...
    model.eval_loss                         # (params, batch) -> metrics
    model.init_cache(device)                # zeroed decode caches
    model.prefill / model.decode_step       # serving step functions

The port of ``repro.models.model_zoo.Model``, the dry-run case aside. The
pspec methods resolve on any object with a ``shape`` mapping (an abstract
mesh will do); the sharding methods need a live mesh
(``launch.mesh``). The multi-device steps are
``optim.grad_compress.multipod_train_step`` and
``parallel.pipeline.pipeline_train_step``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import _tree
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import batch_logical_axes, make_batch_specs
from repro_torch.models import transformer as tfm
from repro_torch.models.params import init_params, logical_axes, torch_dtype
from repro_torch.optim.optimizers import (clip_by_global_norm, make_optimizer,
                                          opt_state_axes)
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.parallel.sharding import get_rules, tree_pspecs, tree_shardings


@dataclass
class Model:
    run: RunConfig

    def __post_init__(self):
        self.cfg = self.run.model
        self.rules = get_rules(self.run.sharding_preset,
                               self.run.rule_overrides)
        self.template = tfm.model_template(self.cfg)
        self.param_axes = logical_axes(self.template)
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

    def param_pspecs(self, mesh):
        return tree_pspecs(self.rules, self.param_axes,
                           self.abstract_params(), mesh)

    def param_shardings(self, mesh):
        return tree_shardings(self.rules, self.param_axes,
                              self.abstract_params(), mesh)

    def opt_axes(self):
        return opt_state_axes(self.run.optimizer, self.param_axes)

    def opt_pspecs(self, mesh):
        return tree_pspecs(self.rules, self.opt_axes(),
                           self.abstract_opt_state(), mesh)

    def opt_shardings(self, mesh):
        return tree_shardings(self.rules, self.opt_axes(),
                              self.abstract_opt_state(), mesh)

    # ----------------------------------------------------------------- batch
    def abstract_batch(self):
        return make_batch_specs(self.cfg, self.run.shape)

    def batch_pspecs(self, mesh):
        return tree_pspecs(self.rules, batch_logical_axes(
            self.cfg, self.run.shape), self.abstract_batch(), mesh)

    def batch_shardings(self, mesh):
        return tree_shardings(self.rules, batch_logical_axes(
            self.cfg, self.run.shape), self.abstract_batch(), mesh)

    # ----------------------------------------------------------------- cache
    def cache_spec(self):
        """(the decode caches as meta tensors, their logical axes)."""
        sp = self.run.shape
        enc_len = sp.seq_len if self.cfg.is_encoder_decoder else 0
        spec = tfm.cache_spec(self.cfg, sp.global_batch, sp.seq_len, enc_len)
        return (_tree.tree_map(lambda s: torch.empty(
                    s.shape, dtype=s.dtype, device="meta"), spec),
                _tree.tree_map(lambda s: s.axes, spec))

    def abstract_cache(self):
        return self.cache_spec()[0]

    def init_cache(self, device="cpu"):
        sp = self.run.shape
        enc_len = sp.seq_len if self.cfg.is_encoder_decoder else 0
        return tfm.init_cache(self.cfg, sp.global_batch, sp.seq_len, device,
                              enc_len=enc_len)

    def cache_pspecs(self, mesh):
        val, axes = self.cache_spec()
        return tree_pspecs(self.rules, axes, val, mesh)

    def cache_shardings(self, mesh):
        val, axes = self.cache_spec()
        return tree_shardings(self.rules, axes, val, mesh)

    # ------------------------------------------------------------ step fns
    # Steps run on the runtime's lane threads, and grad mode is per
    # thread: the mode is set inside each step.
    def grads(self, params, batch):
        """(gradient leaves, in ``tree_leaves(params)`` order; metrics) of
        the loss on ``batch``. Gradients of detached copies: the tensors
        MDSS holds never get requires_grad."""
        leaves = [p.detach().requires_grad_()
                  for p in _tree.tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = tfm.forward_train(
                self.cfg, self.run, _tree.unflatten_like(params, leaves),
                batch)
            grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def apply_grads(self, params, opt_state, grads, metrics, gnorm=None):
        """Clip the gradient leaves by their global norm (``gnorm`` if
        given) and take one optimizer step: (params, opt_state, metrics
        with grad_norm and lr)."""
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(
                _tree.unflatten_like(params, grads), self.run.grad_clip,
                gnorm)
            lr = self.schedule(opt_state["step"] + 1)   # 0-based counter
            params, opt_state = self.opt_update(params, grads, opt_state,
                                                lr=lr)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    @property
    def train_step(self) -> Callable:
        run, grads_of = self.run, self.grads

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
            return self.apply_grads(params, opt_state, grads, metrics)

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
