"""The port's ``Trainer`` (an Emerald workflow whose ``train_step`` is
offloaded to the cloud tier, here the host) held against the JAX
package's on the CPU, at reduced size (2 layers, d_model 64, f32):
offloaded against local (``test_train_offload_matches_local_exactly``'s
rtol 1e-6), a 5-step loss history against the JAX ``Trainer`` from the
same initial params (rtol 1e-4; measured: ~1e-7 relative), and the loss
dropping over 40 steps with the params uploaded once
(``test_lm_training_through_emerald_learns``); and the CLI.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeProfile as JShape
from repro.configs.base import reduced as jreduced
from repro.launch.train import Trainer as JTrainer
from repro.models.model_zoo import Model as JModel
from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
from repro_torch.launch.train import Trainer
from repro_torch.models.params import from_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _runs(arch, S, B, **kw):
    jcfg = jreduced(jget_config(arch), n_layers=2)
    cfg = reduced(get_config(arch), n_layers=2)
    return (JRunConfig(model=jcfg, shape=JShape("t", S, B, "train"), **kw),
            RunConfig(model=cfg, shape=ShapeProfile("t", S, B, "train"), **kw))


def test_train_offload_matches_local_exactly():
    """Offloaded training == local training, step for step."""
    _, run = _runs("tinyllama-1.1b", 32, 2, remat="none")
    arms = {}
    for policy in ("annotate", "never"):
        tr = Trainer(run, policy=policy, device="cpu")
        arms[policy] = tr.fit(5, log_every=0)
        rep = tr.transfer_report()
        tr.close()
        assert rep["offloads"] == (5 if policy == "annotate" else 0)
    for a, b in zip(arms["annotate"], arms["never"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)


def test_trainer_matches_reference_trainer():
    """Five steps through the port's Trainer and the JAX Trainer, from the
    same initial params and the same batches: loss history at rtol 1e-4
    (measured ~1e-7 relative)."""
    jrun, run = _runs("tinyllama-1.1b", 32, 2, remat="none")
    jtr = JTrainer(jrun)
    jh = jtr.fit(5, log_every=0)
    jtr.close()
    # the JAX Trainer's own draw, converted
    p = from_reference(jax.tree.map(np.asarray, JModel(jrun).init_params(
        jax.random.PRNGKey(0))))
    tr = Trainer(run, device="cpu", params=p)
    h = tr.fit(5, log_every=0)
    tr.close()
    assert [m["step"] for m in h] == [m["step"] for m in jh]
    for a, b in zip(h, jh):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)


def test_lm_training_through_emerald_learns():
    _, run = _runs("tinyllama-1.1b", 64, 4, remat="none",
                   learning_rate=3e-3)
    tr = Trainer(run, device="cpu")
    hist = tr.fit(40, log_every=0)
    rep = tr.transfer_report()
    tr.close()
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3
    assert rep["offloads"] == 40
    # params uploaded once; per-step traffic is just the batch
    up = rep["bytes_moved"][("local", "cloud")]
    n_params_bytes = sum(x.nbytes for x in _tree.tree_leaves(
        tr.model.init_params(torch.Generator().manual_seed(0))))
    batch_bytes = sum(v.nbytes for v in tr.data.batch(0).values())
    overhead = up - (2 * n_params_bytes + 40 * batch_bytes)
    assert overhead < n_params_bytes + 65536, "params re-uploaded every step?"


def test_trainer_defaults_to_the_card():
    """Without a card, a Trainer that names no device refuses to start (it
    never falls back to the host)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default tier is usable")
    _, run = _runs("tinyllama-1.1b", 16, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(run)


def test_cli_trains_the_reduced_config_on_the_host():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "tinyllama-1.1b", "--reduced", "--device", "cpu", "--steps", "20"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "step    19 loss" in res.stdout
    assert "'offloads': 20" in res.stdout
