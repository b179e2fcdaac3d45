"""Model API hub: config -> template, params, caches and serving steps.

    model = Model(run_config)
    model.init_params(generator, device)    # real tensors
    model.init_cache(device)                # zeroed decode caches
    model.prefill / model.decode_step       # serving step functions

The port of ``repro.models.model_zoo.Model`` for the serve path: no
shardings, no train step and no dry-run case yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.params import init_params


@dataclass
class Model:
    run: RunConfig

    def __post_init__(self):
        self.cfg = self.run.model
        self.template = tfm.model_template(self.cfg)

    # ------------------------------------------------------------ parameters
    def init_params(self, generator: torch.Generator, device=None):
        return init_params(self.template, generator, self.cfg.param_dtype,
                           device)

    # ----------------------------------------------------------------- cache
    def init_cache(self, device="cpu"):
        sp = self.run.shape
        return tfm.init_cache(self.cfg, sp.global_batch, sp.seq_len, device)

    # ------------------------------------------------------------ step fns
    # Steps run on the runtime's lane threads, and grad mode is per
    # thread: the mode is set inside each step.
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
