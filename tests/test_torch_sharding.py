"""The port's sharding rules (``repro_torch.parallel.sharding``), meshes
(``repro_torch.launch.mesh``) and ``Model``'s pspec methods held to the
reference's, exactly: the reference is called with a mesh stand-in that
has only ``shape`` (its ``resolve`` reads nothing else), so production
mesh sizes need no devices. Also the cases of ``tests/test_sharding.py``
and the invariants of ``tests/test_sharding_props.py`` on the port, the
DTensor placements, and ``constrain``.
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeProfile as JShape
from repro.data import pipeline as jpipe
from repro.launch import mesh as jmesh
from repro.models.model_zoo import Model as JModel
from repro.optim.optimizers import opt_state_axes as j_opt_state_axes
from repro.parallel import sharding as JS
from repro_torch import _tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import RunConfig, ShapeProfile
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.model_zoo import Model
from repro_torch.optim.optimizers import opt_state_axes
from repro_torch.parallel import sharding as S
from repro_torch.parallel.sharding import (DP_TP_RULES, FSDP_RULES, PRESETS,
                                           Mesh, get_rules, resolve)

MESH = Mesh({"data": 16, "model": 16})
MESH_POD = Mesh({"pod": 2, "data": 16, "model": 16})
MESH_SHAPES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
               {"data": 1, "model": 1}, {"pod": 2, "data": 2, "model": 2}]
SHAPE = ("train", 2048, 256, "train")


def _ref_leaves(tree):
    """{key path: entries} of the reference's PartitionSpec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in flat}


def _port_leaves(tree, prefix=()):
    """{key path: PSpec} of the port's tree (dicts of PSpec tuples)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _port_leaves(sub, prefix + (key,)).items()}
    return {"/".join(prefix): tree}


def _ref_axes(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=S.is_axes)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): ax
            for path, ax in flat}


def _pair(arch, preset, optimizer):
    jrun = JRunConfig(model=jget_config(arch), shape=JShape(*SHAPE),
                      sharding_preset=preset, optimizer=optimizer)
    run = RunConfig(model=get_config(arch), shape=ShapeProfile(*SHAPE),
                    sharding_preset=preset, optimizer=optimizer)
    return JModel(jrun), Model(run)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pspecs_equal_the_reference(arch):
    """params, optimizer state (AdamW and Adafactor), batch and decode
    caches, for the three presets on four meshes: every leaf's spec equal
    to the reference's."""
    n = 0
    for preset in PRESETS:
        for optimizer in ("adamw", "adafactor"):
            jm, m = _pair(arch, preset, optimizer)
            jval, jaxes = jm.cache_spec()
            for shape in MESH_SHAPES:
                fake, mesh = types.SimpleNamespace(shape=shape), Mesh(shape)
                pairs = [
                    (jm.param_pspecs(fake), m.param_pspecs(mesh)),
                    (JS.tree_pspecs(jm.rules, jm.opt_axes(),
                                    jm.abstract_opt_state(), fake),
                     m.opt_pspecs(mesh)),
                    (JS.tree_pspecs(
                        jm.rules, jpipe.batch_logical_axes(jm.cfg,
                                                           jm.run.shape),
                        jm.abstract_batch(), fake), m.batch_pspecs(mesh)),
                    (JS.tree_pspecs(jm.rules, jaxes, jval, fake),
                     m.cache_pspecs(mesh))]
                for ref, port in pairs:
                    assert _port_leaves(port) == _ref_leaves(ref), \
                        (preset, optimizer, shape)
                    n += len(_ref_leaves(ref))
    assert n > 500


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_and_batch_specs_equal_the_reference(arch):
    """``logical_axes``, ``opt_state_axes`` (AdamW, Adafactor's factored
    leaves), ``batch_logical_axes``, ``make_batch_specs`` and the cache
    axes: equal to the reference's."""
    jm, m = _pair(arch, "fsdp", "adamw")
    assert _port_leaves(m.param_axes) == _ref_axes(jm.param_axes)
    for opt in ("adamw", "adafactor"):
        assert _port_leaves(opt_state_axes(opt, m.param_axes)) == \
            _ref_axes(j_opt_state_axes(opt, jm.param_axes))
    sp = ShapeProfile(*SHAPE)
    assert tpipe.batch_logical_axes(m.cfg, sp) == \
        jpipe.batch_logical_axes(jm.cfg, jm.run.shape)
    specs = tpipe.make_batch_specs(m.cfg, sp)
    jspecs = jpipe.make_batch_specs(jm.cfg, jm.run.shape)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."),
                v.device.type) for k, v in specs.items()} == \
        {k: (tuple(v.shape), str(v.dtype), "meta") for k, v in jspecs.items()}
    val, axes = m.cache_spec()
    jval, jaxes = jm.cache_spec()
    assert _port_leaves(axes) == _ref_axes(jaxes)
    assert {k: tuple(v.shape) for k, v in _port_leaves(val).items()} == \
        {k: tuple(v.shape) for k, v in _ref_axes(jval).items()}


def test_production_meshes_equal_the_reference(monkeypatch):
    """The reference builds them with ``jax.make_mesh`` over 256/512
    devices; its arguments are caught here, as the shapes and names."""
    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes, **_:
                        types.SimpleNamespace(shape=dict(zip(axes, shape))))
    for multi_pod in (False, True):
        ref = jmesh.make_production_mesh(multi_pod=multi_pod)
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.shape == ref.shape
        assert list(mesh.shape.items()) == list(ref.shape.items())
        assert mesh.device_mesh is None
    assert make_production_mesh(multi_pod=True).axis_names == \
        ("pod", "data", "model")


def test_presets_equal_the_reference():
    assert PRESETS == JS.PRESETS
    for preset in PRESETS:
        over = (("act_batch", ("pod", "data", "model")), ("embed", ()))
        assert get_rules(preset, over) == JS.get_rules(preset, over)


# ---------------------------------------------------------------------------
# tests/test_sharding.py on the port
# ---------------------------------------------------------------------------

def test_basic_tp_resolution():
    spec = resolve(DP_TP_RULES, ("embed", "ff"), (1024, 4096), MESH)
    assert spec == (None, "model")


def test_batch_over_pod_and_data():
    spec = resolve(DP_TP_RULES, ("act_batch", None, None), (256, 4, 4),
                   MESH_POD)
    assert spec == (("pod", "data"),)


def test_batch_partial_when_pod_absent():
    spec = resolve(DP_TP_RULES, ("act_batch",), (256,), MESH)
    assert spec == ("data",)


def test_divisibility_fallback_replicates():
    rules = dict(DP_TP_RULES, kv_heads=("model",))
    spec = resolve(rules, ("embed", "kv_heads", None), (1024, 8, 128), MESH)
    assert spec == ()


def test_divisibility_fallback_keeps_other_dims():
    rules = dict(DP_TP_RULES, kv_heads=("model",))
    spec = resolve(rules, ("kv_heads", "ff"), (8, 4096), MESH)
    assert spec == (None, "model")


def test_each_mesh_axis_used_once():
    spec = resolve(DP_TP_RULES, ("ff", "vocab"), (4096, 32000), MESH)
    assert spec == ("model",)           # trailing None trimmed


def test_fsdp_shards_embed_over_data():
    spec = resolve(FSDP_RULES, ("embed", "ff"), (4096, 8192), MESH)
    assert spec == ("data", "model")


def test_batch_not_divisible_replicates():
    spec = resolve(FSDP_RULES, ("act_batch", "act_kv_seq"), (1, 524288),
                   MESH)
    assert spec == (None, "model")


def test_overrides():
    rules = get_rules("fsdp", overrides=(("act_batch",
                                          ("pod", "data", "model")),))
    spec = resolve(rules, ("act_batch", None), (256, 4), MESH)
    assert spec == (("data", "model"),)


def test_override_removal():
    rules = get_rules("fsdp", overrides=(("embed", ()),))
    spec = resolve(rules, ("embed", "ff"), (4096, 8192), MESH)
    assert spec == (None, "model")


def test_multi_axis_dim():
    rules = {"act_batch": ("pod", "data")}
    assert resolve(rules, ("act_batch",), (64,), MESH_POD) == \
        (("pod", "data"),)
    # 2*16=32 divides 64; with batch 2 only 'pod' fits
    assert resolve(rules, ("act_batch",), (2,), MESH_POD) == ("pod",)


# ---------------------------------------------------------------------------
# tests/test_sharding_props.py on the port (seeded draws; each also equal to
# the reference's resolve)
# ---------------------------------------------------------------------------

LOGICAL = [None, "embed", "ff", "vocab", "heads", "kv_heads", "experts",
           "act_batch", "act_ff", "act_kv_seq", "ssm_inner", "moe_ff"]
PROP_MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
               {"data": 4, "model": 2}]


def test_resolve_invariants():
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(1, 6))
        axes = tuple(LOGICAL[i] for i in rng.integers(0, len(LOGICAL), n))
        shape = tuple(int(s) for s in rng.integers(1, 8193, n))
        # small dims divide more often: half the draws from powers of two
        if rng.random() < 0.5:
            shape = tuple(int(2 ** rng.integers(0, 14)) for _ in range(n))
        preset = list(PRESETS)[int(rng.integers(0, len(PRESETS)))]
        mshape = PROP_MESHES[int(rng.integers(0, len(PROP_MESHES)))]
        mesh = Mesh(mshape)
        spec = resolve(PRESETS[preset], axes, shape, mesh)
        assert spec == tuple(JS.resolve(JS.PRESETS[preset], axes, shape,
                                        types.SimpleNamespace(shape=mshape)))
        # 1. spec rank never exceeds tensor rank
        assert len(spec) <= len(shape)
        used = []
        for i, entry in enumerate(spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            prod = 1
            for nm in names:
                assert nm in mesh.shape          # 2. only real mesh axes
                used.append(nm)
                prod *= mesh.shape[nm]
            # 3. divisibility always holds
            assert shape[i] % prod == 0, (axes, shape, spec)
        # 4. each mesh axis used at most once
        assert len(used) == len(set(used))


# ---------------------------------------------------------------------------
# Placements, constrain, a live mesh of one process
# ---------------------------------------------------------------------------

def test_placements_nest_shards_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    mesh = Mesh({"pod": 2, "data": 2, "model": 2})
    assert S.placements(("data", "model"), mesh) == \
        (Replicate(), Shard(0), Shard(1))
    assert S.placements((("pod", "data"),), mesh) == \
        (Shard(0), Shard(0), Replicate())
    # model major over data: the earlier mesh axis strides
    assert S.placements((("model", "data"),), mesh) == \
        (Replicate(), _StridedShard(0, split_factor=2), Shard(0))


def test_constrain_is_a_noop_on_model_one_and_refuses_tensor_parallelism(
        tmp_path):
    """A plain tensor passes through, with or without a mesh (a model
    axis above 1 is no longer refused); a DTensor on a (data 1, model 2)
    mesh of 2 gloo processes is redistributed to the placements the rules
    resolve: (act_batch, act_ff) splits its rows over data (size 1) and
    its columns over model, each process keeping its half, and
    (act_batch, None) gathers the columns back."""
    from torch.distributed.tensor import Replicate, Shard
    from tests._torch_ranks import run_ranks
    x = torch.ones(4, 8)
    assert S.constrain(x, FSDP_RULES, "act_batch", "act_ff") is x
    with S.use_mesh(Mesh({"pod": 2, "data": 2, "model": 1})):
        assert S.constrain(x, FSDP_RULES, "act_batch", "act_ff") is x
    with S.use_mesh(Mesh({"data": 2, "model": 2})):
        assert S.constrain(x, FSDP_RULES, "act_batch", "act_ff") is x
    assert S.get_mesh() is None
    full = torch.arange(32.0).reshape(4, 8)
    for r, out in enumerate(run_ranks("constrain", 2, tmp_path)):
        pl, local = out["y"]
        assert tuple(pl) == (Shard(0), Shard(1))
        assert torch.equal(local, full[:, 4 * r:4 * r + 4])
        pl, local = out["z"]
        assert tuple(pl) == (Shard(0), Replicate())
        assert torch.equal(local, full)


def test_host_mesh_shardings_place_a_tree():
    """A live 1x1 CPU mesh (a world-1 gloo group): ``param_shardings``
    places every leaf and the DTensors hold the same values."""
    import torch.distributed as dist
    from repro_torch.configs.base import reduced
    run = RunConfig(model=reduced(get_config("tinyllama-1.1b"), n_layers=2),
                    shape=ShapeProfile("t", 8, 2, "train"))
    m = Model(run)
    params = m.init_params(torch.Generator().manual_seed(0))
    try:
        mesh = make_host_mesh("cpu")
        assert mesh.shape == {"data": 1, "model": 1}
        sh = m.param_shardings(mesh)
        placed = S.distribute_tree(params, sh)
        for a, b in zip(_tree.tree_leaves(placed), _tree.tree_leaves(params)):
            assert torch.equal(a.full_tensor(), b)
        from torch.distributed.tensor import Shard
        assert any(isinstance(pl, Shard) for s in _tree.tree_leaves(sh)
                   for pl in s.placements)
    finally:
        dist.destroy_process_group()


def test_placements_lay_shards_out_as_the_pspec_says(tmp_path):
    """On 4 gloo processes, (pod 2, data 2): each process's DTensor shard
    of a 16 x 4 tensor is the block the PSpec names, axes major first,
    also where the PSpec's order is not the mesh's (``_StridedShard``)."""
    from tests._torch_ranks import run_ranks
    specs = [(("pod", "data"),), (("data", "pod"),), ("pod", "data"),
             ("data",)]
    ranks = run_ranks("layout", 4, tmp_path, {"specs": specs})
    x = torch.arange(64.0).reshape(16, 4)
    for r in ranks:
        p, d = r["coord"]["pod"], r["coord"]["data"]
        want = {specs[0]: x[4 * (2 * p + d):][:4],
                specs[1]: x[4 * (2 * d + p):][:4],
                specs[2]: x[8 * p:8 * p + 8, 2 * d:2 * d + 2],
                specs[3]: x[8 * d:8 * d + 8]}
        for spec, w in want.items():
            assert torch.equal(r[spec], w), (spec, p, d)
