"""The port's checkpointer (``repro_torch.checkpoint``): the cases of
``tests/test_checkpoint.py``, its keys against the JAX checkpointer's for
the same tree, bfloat16 leaves, the host copy taken at ``save``, a
``Trainer`` resumed from a checkpoint bit-identical to an uninterrupted
run, and the elastic restore: a tree sharded over (pod 2) on two gloo
processes, saved, restored onto (data 2) with the fsdp placements and
onto one process, every full tensor bitwise the saved one."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro_torch import _tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
from repro_torch.launch.train import Trainer
from repro_torch.parallel.sharding import Mesh


def tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones((4,))},
            "step": torch.tensor(7, dtype=torch.int32)}


def _meta(t):
    return _tree.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                                device="meta"), t)


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = tree()
    ck.save("m", 10, t, topology={"mesh": [1]})
    restored, meta = ck.restore("m", _meta(t))
    assert meta["step"] == 10 and meta["topology"] == {"mesh": [1]}
    for a, b in zip(_tree.tree_leaves(restored), _tree.tree_leaves(t)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_tracking(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save("m", 5, tree(), topology={})
    ck.save("m", 9, tree(), topology={})
    assert ck.latest_step("m") == 9


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save("m", 1, tree(), topology={})
    ck.wait()
    restored, _ = ck.restore("m", _meta(tree()))
    assert torch.equal(restored["params"]["w"],
                       torch.arange(12.0).reshape(3, 4))


def test_async_save_copies_at_save(tmp_path):
    """The host copy is taken in ``save``: writing the tensors afterwards
    does not reach the file the background thread writes."""
    ck = Checkpointer(str(tmp_path), async_save=True)
    t = tree()
    ck.save("m", 1, t, topology={})
    t["params"]["w"].fill_(-1.0)
    restored, _ = ck.restore("m", _meta(t))     # restore waits for the write
    assert torch.equal(restored["params"]["w"],
                       torch.arange(12.0).reshape(3, 4))


def test_partial_file_never_visible(tmp_path):
    """Atomic rename: no *.npz file exists until fully written."""
    ck = Checkpointer(str(tmp_path))
    ck.save("m", 1, tree(), topology={})
    assert not any(f.endswith(".tmp.npz") for f in os.listdir(tmp_path))


def test_shape_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save("m", 1, tree(), topology={})
    bad = {"params": {"w": torch.zeros((2, 2)), "b": torch.zeros((4,))},
           "step": torch.tensor(0, dtype=torch.int32)}
    with pytest.raises(ValueError):
        ck.restore("m", _meta(bad))


def test_latest_is_published_through_mdss(tmp_path):
    from repro_torch.core import CostModel, MDSS, default_tiers
    tiers = default_tiers(cloud_device="cpu")
    mdss = MDSS(tiers, cost_model=CostModel(tiers))
    ck = Checkpointer(str(tmp_path), mdss=mdss)
    ck.save("m", 3, tree(), topology={})
    got = mdss.get("ckpt://m/latest", "local")
    assert got["step"] == 3 and os.path.exists(got["path"])


def test_bf16_leaves_roundtrip_bitwise(tmp_path):
    g = torch.Generator().manual_seed(0)
    t = {"w": torch.randn((5, 3), generator=g).to(torch.bfloat16),
         "s": torch.randn((4,), generator=g)}
    ck = Checkpointer(str(tmp_path))
    ck.save("m", 1, t, topology={})
    restored, _ = ck.restore("m", _meta(t))
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16),
                       t["w"].view(torch.int16))
    assert torch.equal(restored["s"], t["s"])


def test_keys_equal_the_reference_checkpointers(tmp_path):
    """The same tree saved by both checkpointers: the same npz keys (the
    reference's ``jax.tree`` paths) and the same values."""
    nested = {"params": {"stage_0": {"pos_0": {"attn": {
        "wq": np.arange(24.0, dtype=np.float32).reshape(2, 3, 4)}}},
        "embed": {"embedding": np.ones((6, 2), np.float32)}},
        "opt_state": {"mu": {"x": np.zeros(3, np.float32)},
                      "step": np.int32(4)}}
    JCheckpointer(str(tmp_path / "j")).save(
        "m", 1, {k: _np_tree(v, jnp.asarray) for k, v in nested.items()},
        topology={})
    Checkpointer(str(tmp_path / "t")).save(
        "m", 1, _np_tree(nested, torch.as_tensor), topology={})
    with np.load(tmp_path / "j" / "m-00000001.npz") as zj, \
            np.load(tmp_path / "t" / "m-00000001.npz") as zt:
        assert set(zj.files) == set(zt.files)
        assert "params/stage_0/pos_0/attn/wq" in zt.files
        for k in zj.files:
            if k != "__meta__":
                np.testing.assert_array_equal(zt[k], zj[k])


def _np_tree(t, fn):
    if isinstance(t, dict):
        return {k: _np_tree(v, fn) for k, v in t.items()}
    return fn(t)


def test_trainer_resume_bit_identical(tmp_path):
    """Train 6 steps; vs train 3, checkpoint, restart, 3 more: the same
    losses and the same params, bit for bit."""
    cfg = reduced(get_config("tinyllama-1.1b"), n_layers=2)
    run = RunConfig(model=cfg, shape=ShapeProfile("t", 32, 2, "train"),
                    remat="none")

    def trainer(d):
        return Trainer(run, ckpt_dir=str(tmp_path / d), ckpt_every=3,
                       async_ckpt=False, device="cpu")

    t1 = trainer("a")
    h1 = t1.fit(6, log_every=0)
    p1 = t1.mdss.get("params", "local")
    t1.close()
    t2 = trainer("b")
    t2.fit(3, log_every=0)
    t2.close()
    t3 = trainer("b")
    h3 = t3.fit(3, resume=True, log_every=0)
    p3 = t3.mdss.get("params", "local")
    t3.close()
    assert [m["step"] for m in h3] == [3, 4, 5]
    assert [m["loss"] for m in h3] == [m["loss"] for m in h1[3:]]
    for a, b in zip(_tree.tree_leaves(p1), _tree.tree_leaves(p3)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Elastic restore across meshes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    from repro_torch.models.model_zoo import Model
    from tests._torch_ranks import run_ranks
    cfg = reduced(get_config("tinyllama-1.1b"), n_layers=2,
                  param_dtype="bfloat16")
    run = RunConfig(model=cfg, shape=ShapeProfile("t", 8, 2, "train"))
    model = Model(run)
    params = model.init_params(torch.Generator().manual_seed(0))
    d = tmp_path_factory.mktemp("elastic")
    ranks = run_ranks("checkpoint", 2, d / "ranks",
                      {"cfg": cfg, "params": params, "dir": str(d / "ck")})
    return model, params, str(d / "ck"), ranks


def _bitwise(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_restore_from_pod_onto_data_sharding(elastic):
    model, params, _, ranks = elastic
    leaves = _tree.tree_leaves(params)
    specs = _tree.tree_leaves(model.param_pspecs(
        Mesh({"pod": 1, "data": 2, "model": 1})),
        is_leaf=lambda x: isinstance(x, tuple))
    assert any(s for s in specs), "the fsdp rules shard some leaf over data"
    for r in ranks:
        # the file is in place on every process when save returns
        assert r["saved"] == 3
        assert r["meta"]["step"] == 3
        assert r["meta"]["topology"] == {"mesh": {"pod": 2, "data": 1,
                                                  "model": 1}}
        assert all(_bitwise(a, b) for a, b in zip(r["full"], leaves))
        assert any(t.dtype == torch.bfloat16 for t in r["full"])
        # saved: each pod held half of every stage's layers
        for x, shp, name in zip(leaves, r["saved_local_shapes"],
                                _tree.tree_leaves(_names(params))):
            want = (x.shape[0] // 2,) + tuple(x.shape[1:]) \
                if name.startswith("stage_") else tuple(x.shape)
            assert shp == want, name
        # restored: each data shard holds half of its split dim
        for x, shp, spec in zip(leaves, r["local_shapes"], specs):
            want = [d // 2 if i < len(spec) and spec[i] == "data" else d
                    for i, d in enumerate(x.shape)]
            assert list(shp) == want, spec


def test_restore_onto_one_process(elastic):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    model, params, ck_dir, _ = elastic
    try:
        mesh = make_host_mesh("cpu")
        tree, meta = Checkpointer(ck_dir).restore(
            "m", model.abstract_params(),
            shardings=model.param_shardings(mesh))
        full = [t.full_tensor() for t in _tree.tree_leaves(tree)]
    finally:
        dist.destroy_process_group()
    assert meta["step"] == 3
    assert all(_bitwise(a, b) for a, b in zip(full,
                                              _tree.tree_leaves(params)))


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _names(v, prefix or k) for k, v in tree.items()}
    return prefix
