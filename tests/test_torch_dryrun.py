"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: reduced
cells (2 layers, narrow widths, short sequences) traced on fake tensors
over fake process groups of (data 2, model 2) and (pod 2, data 2, model
2) ranks, ``device="cpu"``.

Held: every cell ``ok`` with the reference's record keys; ``input_specs``
equal to the shapes and dtypes the reference's ``Model.abstract_*`` give
(the reference's ``input_specs`` is not imported: ``repro.launch.dryrun``
sets ``XLA_FLAGS`` for 512 host devices at import); the argument bytes
the local shards the pspecs imply; per-device FLOPs on a pure data mesh
the one-device count over the chips; on a (data 2, model 1) fsdp mesh the
all-gather and reduce-scatter bytes the data-split parameters imply; the
recorder's memory by storage (views, a checkpointed chain) and the same
counts whatever ran before in the process; the recorder counting an
all-to-all as the all-to-all the program asked for.
"""
import math

import numpy as np
import pytest
import torch

from repro.configs import make_run as jmake_run
from repro.models.model_zoo import Model as JModel
from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeProfile, reduced
from repro_torch.launch import dryrun
from repro_torch.models.model_zoo import Model
from repro_torch.parallel.sharding import Mesh

SMALL = {"single": {"data": 2, "model": 2},
         "multi": {"pod": 2, "data": 2, "model": 2}}
KEYS = {"memory", "per_device", "stages", "chips", "roofline",
        "model_flops", "hlo_flops_global", "model_vs_hlo", "ok", "wall_s"}


def _overrides(arch, shape, **kw):
    return dict(model=reduced(get_config(arch), n_layers=2),
                shape=ShapeProfile(shape, 32, 8, dryrun.SHAPES[shape].kind),
                **kw)


def _cell(arch, shape, mesh_kind, mesh_shape=None, **kw):
    rec = dryrun.run_cell(arch, shape, mesh_kind, device="cpu",
                          run_overrides=_overrides(arch, shape, **kw),
                          mesh_shape=mesh_shape or SMALL[mesh_kind])
    assert rec["ok"], rec.get("traceback")
    return rec


CELLS = [("tinyllama-1.1b", s, m) for s in ("train_4k", "prefill_32k",
                                            "decode_32k")
         for m in ("single", "multi")] + [
    ("falcon-mamba-7b", "train_4k", "multi"),
    ("falcon-mamba-7b", "decode_32k", "single"),
    ("qwen2-moe-a2.7b", "train_4k", "multi"),
    ("qwen2-moe-a2.7b", "prefill_32k", "single")]


@pytest.mark.parametrize("arch,shape,mesh_kind", CELLS)
def test_reduced_cells_are_ok(arch, shape, mesh_kind):
    rec = _cell(arch, shape, mesh_kind)
    assert KEYS <= set(rec) and not rec.get("error")
    chips = math.prod(SMALL[mesh_kind].values())
    assert rec["chips"] == chips
    pd = rec["per_device"]
    assert pd["flops"] > 0 and pd["bytes"] > 0 and pd["collective_bytes"] > 0
    assert rec["hlo_flops_global"] == pd["flops"] * chips
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    span = rec["collective_span"]
    assert np.isclose(span["intra"] + span["cross"], pd["collective_bytes"])
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0 and mem["fits"]
    # every repeat of every stage ran under its key
    assert set(rec["stages"]) == set(dryrun.stage_plan(
        dryrun._make_run(arch, shape, _overrides(arch, shape))))
    assert all(st["flops"] > 0 for st in rec["stages"].values())


def test_long_500k_on_full_attention_is_skipped():
    rec = dryrun.run_cell("tinyllama-1.1b", "long_500k", "single",
                          device="cpu")
    assert rec["skipped"] and not rec["ok"] and "sub-quadratic" in \
        rec["reason"]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "falcon-mamba-7b",
                                  "qwen2-moe-a2.7b", "seamless-m4t-medium"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_equal_the_reference(arch, shape):
    """Shapes and dtypes of every input leaf, full configs (meta tensors
    on the port's side, ShapeDtypeStructs on the reference's)."""
    jm = JModel(jmake_run(arch, shape))
    kind = jm.run.shape.kind
    if kind == "train":
        want = {"params": jm.abstract_params(),
                "opt_state": jm.abstract_opt_state(),
                "batch": jm.abstract_batch()}
    elif kind == "prefill":
        b = jm.abstract_batch()
        b.pop("labels", None)
        want = {"params": jm.abstract_params(), "batch": b,
                "cache": jm.abstract_cache()}
    else:
        want = {"params": jm.abstract_params(),
                "tokens": (jm.run.shape.global_batch,),
                "cache": jm.abstract_cache()}
    import jax
    got = dryrun.input_specs(arch, shape)
    assert set(got) == set(want)
    for k in want:
        if k == "tokens":
            assert tuple(got[k].shape) == want[k]
            assert got[k].dtype == torch.int32
            continue
        flat = jax.tree_util.tree_flatten_with_path(want[k])[0]
        assert len(flat) == len(_tree.tree_leaves(got[k]))
        for path, leaf in flat:
            t = got[k]
            for p in path:
                t = t[p.key]
            assert tuple(t.shape) == tuple(leaf.shape), (k, path)
            assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)


def _local_bytes(pspecs, abstract, sizes):
    total = 0
    for t, spec in zip(_tree.tree_leaves(abstract), _tree.tree_leaves(
            pspecs, is_leaf=lambda x: isinstance(x, tuple))):
        shape = list(t.shape)
        for d, entry in enumerate(spec):
            names = (entry,) if isinstance(entry, str) else entry or ()
            shape[d] //= math.prod(sizes[a] for a in names)
        total += math.prod(shape) * t.element_size()
    return total


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_argument_bytes_are_the_local_shards(mesh_kind):
    ov = _overrides("tinyllama-1.1b", "train_4k")
    rec = _cell("tinyllama-1.1b", "train_4k", mesh_kind)
    m = Model(dryrun._make_run("tinyllama-1.1b", "train_4k", ov))
    sizes = SMALL[mesh_kind]
    mesh = Mesh(sizes)
    want = (_local_bytes(m.param_pspecs(mesh), m.abstract_params(), sizes)
            + _local_bytes(m.opt_pspecs(mesh), m.abstract_opt_state(),
                           sizes)
            + _local_bytes(m.batch_pspecs(mesh), m.abstract_batch(), sizes))
    assert rec["memory"]["argument_bytes"] == want
    assert want < sum(t.numel() * t.element_size() for tree in (
        m.abstract_params(), m.abstract_opt_state(), m.abstract_batch())
        for t in _tree.tree_leaves(tree))


def test_flops_per_device_on_a_pure_data_mesh():
    """dp_tp on (data 4, model 1): each device's FLOPs are the
    one-device count over 4 (the batch split four ways)."""
    one = _cell("tinyllama-1.1b", "train_4k", "single",
                {"data": 1, "model": 1}, sharding_preset="dp_tp")
    four = _cell("tinyllama-1.1b", "train_4k", "single",
                 {"data": 4, "model": 1}, sharding_preset="dp_tp")
    assert four["per_device"]["flops"] * 4 == one["per_device"]["flops"]
    assert four["hlo_flops_global"] == one["hlo_flops_global"]
    assert one["per_device"]["collective_bytes"] == 0


def test_mamba_channels_split_over_model():
    """falcon-mamba dp_tp on (data 1, model 4): in_proj's x and z halves,
    the conv and the scan each run a quarter of the channels on each
    device, so the per-device FLOPs are the one-device count over 4 and
    the temporaries more than 3 times smaller (were the x half gathered
    whole, the scan would run every channel on each device)."""
    one, four = (_cell("falcon-mamba-7b", "train_4k", "single",
                       {"data": 1, "model": m}, sharding_preset="dp_tp")
                 for m in (1, 4))
    assert four["per_device"]["flops"] * 4 == one["per_device"]["flops"]
    assert 3 * four["memory"]["temp_bytes"] < one["memory"]["temp_bytes"]


def _paths(tree, prefix=()):
    """(path, leaf) of a nested dict of tensors, in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _paths(tree[k],
                                                         prefix + (k,))]
    return [(prefix, tree)]


def test_fsdp_gathers_and_reduce_scatters_the_split_params():
    """fsdp on (data 2, model 1), remat none: every parameter split over
    data is gathered once in the forward (each layer's slice of a stacked
    leaf at its use) and its gradient reduce-scattered once, its shard's
    bytes moved each time (ring, g = 2: (g-1)/g of the whole, (g-1) x
    the shard). The norms' scales are gathered once more in the
    backward: they enter an elementwise product through DTensor's own
    redistribution, which autograd does not keep, where the products with
    the weight matrices gather them explicitly (``sharding.einsum``) and
    keep the gathered weight. Nothing else is gathered or scattered."""
    sizes = {"data": 2, "model": 1}
    ov = _overrides("tinyllama-1.1b", "train_4k", remat="none")
    rec = _cell("tinyllama-1.1b", "train_4k", "single", sizes, remat="none")
    m = Model(dryrun._make_run("tinyllama-1.1b", "train_4k", ov))
    specs = _tree.tree_leaves(m.param_pspecs(Mesh(sizes)),
                              is_leaf=lambda x: isinstance(x, tuple))
    split = [(path, t) for (path, t), s in zip(_paths(m.abstract_params()),
                                               specs) if "data" in str(s)]
    assert len(split) >= 10
    shard_bytes = sum(t.numel() * t.element_size() // 2 for _, t in split)
    scale_bytes = sum(t.numel() * t.element_size() // 2 for path, t in split
                      if path[-1] == "scale")
    assert scale_bytes > 0
    assert rec["collectives"]["reduce-scatter"] == shard_bytes * (2 - 1)
    assert rec["collectives"]["all-gather"] == shard_bytes + scale_bytes


def test_recorder_counts_storages_not_tensor_objects():
    """A tensor whose object dies while views of its storage live is
    still held; an output that shares an earlier output's storage
    (``_unsafe_view``, not a view op) is not counted twice."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.comm_analysis import Recorder
    fake = FakeTensorMode()
    rec = Recorder([], fake)
    n = 64 * 64 * 4
    with fake:
        a = torch.empty(64, 64)
        with rec:
            x = a + a
            v, w = x.view(-1), x.t()
            del x
            y = a * 2
            z = torch.ops.aten._unsafe_view(y, (4096,))
            assert rec.live == 2 * n
            del v, w
            q = a - a
            assert rec.peak == 2 * n and rec.live == 2 * n
    del y, z, q


def _chain_peak(n_layers, remat, N=256, D=64):
    """The recorder's peak over a chain of ``n_layers`` layers ``x + relu(x
    @ w)`` and the input's gradient of the sum, on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.checkpoint import checkpoint
    from repro_torch.launch.comm_analysis import Recorder
    layer = lambda x, w: x + torch.relu(x @ w)
    fake = FakeTensorMode()
    rec = Recorder([], fake)
    with fake:
        x0 = torch.empty(N, D, requires_grad=True)
        ws = [torch.empty(D, D) for _ in range(n_layers)]
        with rec:
            x = x0
            for w in ws:
                x = checkpoint(layer, x, w, use_reentrant=False) if remat \
                    else layer(x, w)
            torch.autograd.grad(x.sum(), x0)
    return rec.peak


@pytest.mark.parametrize("remat", [True, False])
def test_recorder_memory_of_a_layer_chain(remat):
    """Each layer adds one (N, D) activation to the peak: the input a
    checkpoint keeps (remat) or the relu's output autograd keeps; the
    rest is one layer's working set in the backward, at most three
    activations and the loss."""
    act = 256 * 64 * 4
    peaks = [_chain_peak(n, remat) for n in (1, 2, 3, 4)]
    assert [b - a for a, b in zip(peaks, peaks[1:])] == [act] * 3
    assert act < peaks[0] <= 3 * act + 8


def test_cell_counts_do_not_depend_on_what_ran_before():
    """A cell run twice in one process gives the same memory, FLOPs,
    bytes and collectives: DTensor's shape inference (run on global
    shapes the first time an op's layout is seen, then cached) is not
    counted. A shape no other test here uses, so the first run is the
    first this process sees."""
    ov = dict(model=reduced(get_config("tinyllama-1.1b"), n_layers=2,
                            d_model=96),
              shape=ShapeProfile("train_4k", 24, 8, "train"))
    recs = [dryrun.run_cell("tinyllama-1.1b", "train_4k", "single",
                            device="cpu", run_overrides=ov,
                            mesh_shape=SMALL["single"]) for _ in range(2)]
    assert all(r["ok"] for r in recs), recs[0].get("traceback")
    for key in ("memory", "per_device", "collectives", "stages"):
        assert recs[0][key] == recs[1][key], key


def test_recorder_counts_the_all_to_all_asked_for():
    """The fake CPU group runs an all-to-all as an all-gather and a chunk;
    the recorder keeps one all-to-all, of the result's shape, over the
    mesh dim's groups."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.comm_analysis import Recorder
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        fake = FakeTensorMode()
        rec = Recorder([mesh.device_mesh], fake)
        with fake:
            x = DTensor.from_local(torch.empty(8, 8), mesh.device_mesh,
                                   [Replicate(), Shard(0)], run_check=False,
                                   shape=torch.Size([16, 8]), stride=(8, 1))
            with rec:
                y = x.redistribute(mesh.device_mesh, [Replicate(), Shard(1)])
        assert tuple(y.to_local().shape) == (16, 4)
        assert [c.kind for c in rec.collectives] == ["all-to-all"]
        c = rec.collectives[0]
        assert c.groups == ((0, 1), (2, 3)) and c.dtype == "float32"
    finally:
        dist.destroy_process_group()


def test_recorder_counts_the_manual_collectives():
    """``parallel._collectives``' calls (``torch.distributed``'s c10d
    ops) are recorded too, with the mesh dim's groups."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.comm_analysis import Recorder, collective_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import _collectives as coll
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        rec = Recorder([mesh.device_mesh])
        x = torch.ones(8)
        with rec:
            coll.psum(x, "model", mesh)
            coll.all_gather(x, "data", mesh)
            coll.combine(x, "max", [mesh.group("model")])
        assert [(c.kind, c.shape, c.groups) for c in rec.collectives] == [
            ("all-reduce", (8,), ((0, 1), (2, 3))),
            ("all-gather", (16,), ((0, 2), (1, 3))),
            ("all-reduce", (8,), ((0, 1), (2, 3)))]
        assert collective_bytes(rec.collectives) == {
            "all-reduce": 2 * (2 * 32 / 2), "all-gather": 64 / 2,
            "total": 64.0 + 32.0}
    finally:
        dist.destroy_process_group()
