"""The port's ``Server`` held against the JAX ``Server`` on the CPU:
reduced tinyllama-1.1b (2 layers) with params converted from the
reference's ``init_params``, the same requests; identical greedy tokens,
``stats``, ``transfer_report()`` and per-workflow event kinds."""
import collections

import jax
import numpy as np

from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeProfile as JShape
from repro.configs.base import reduced as jreduced
from repro.launch.serve import Request as JRequest
from repro.launch.serve import Server as JServer
from repro.models.model_zoo import Model as JModel
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
from repro_torch.launch.serve import Request, Server
from repro_torch.models.params import from_reference


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(rid, rng.integers(0, vocab, int(rng.integers(8, 14))
                                  ).astype(np.int32), max_new=6)
            for rid in range(6)]


def _serve(srv, reqs):
    try:
        for r in reqs:
            srv.submit(r)
        done = []
        while srv.queue:
            done += srv.step_batch()
        kinds = {name: dict(collections.Counter(e.kind for e in ex.events))
                 for name, ex in (("prefill", srv.ex_prefill),
                                  ("decode", srv.ex_decode))}
        return {"tokens": [r.tokens for r in done], "stats": srv.stats,
                "transfers": srv.transfer_report(), "kinds": kinds}
    finally:
        srv.close()


def test_server_matches_reference_server():
    jcfg = jreduced(jget_config("tinyllama-1.1b"), n_layers=2)
    jrun = JRunConfig(model=jcfg, shape=JShape("s", 64, 4, "decode"),
                      remat="none")
    jparams = JModel(jrun).init_params(jax.random.PRNGKey(0))
    cfg = reduced(get_config("tinyllama-1.1b"), n_layers=2)
    run = RunConfig(model=cfg, shape=ShapeProfile("s", 64, 4, "decode"),
                    remat="none")
    params = from_reference(jax.tree.map(np.asarray, jparams))

    want = _serve(JServer(jrun, jparams), _requests(JRequest, cfg.vocab_size))
    got = _serve(Server(run, params, device="cpu"),
                 _requests(Request, cfg.vocab_size))
    assert got == want
    assert got["stats"] == {"prefills": 2, "decode_calls": 10,
                            "tokens_out": 30}
    rep = got["transfers"]
    assert rep["decode_offloads"] == 10
    # decode moves tokens up and logits down, never params or caches
    logits_bytes = 12 * 4 * cfg.vocab_padded * 4     # 12 fetches
    assert rep["bytes_moved"][("cloud", "local")] == logits_bytes
