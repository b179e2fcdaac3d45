"""The port's roofline and collective accounting
(``repro_torch.launch.{roofline,comm_analysis}``) held to the reference's
(``repro.launch.{roofline,hlo_analysis}``).

Every case of ``tests/test_roofline.py`` and ``tests/test_hlo_span.py``:
the port has no HLO, so each crafted collective those tests parse is
built as the record the port's recorder keeps (kind, result shape,
dtype, replica groups), with the same expected bytes; the roofline terms
on the H100's constants. The analytic FLOP functions equal the
reference's exactly over all ten ``ARCH_IDS`` and four ``SHAPES``.
"""
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import roofline as jrf
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import roofline as rf
from repro_torch.launch.comm_analysis import (Collective, collective_bytes,
                                              collective_bytes_by_span)
from repro_torch.launch.roofline import (attention_flops,
                                         matmul_param_counts, model_flops,
                                         roofline_terms)


def iota_groups(dims, perm, size):
    """XLA's iota replica groups ``[n, size]<=[dims]T(perm)``, as the
    reference's ``_expand_groups`` reads them."""
    arr = np.arange(int(np.prod(dims))).reshape(dims)
    if perm is not None:
        arr = arr.transpose(list(perm))
    return arr.reshape(-1, size)


def _groups(arr):
    return tuple(tuple(int(v) for v in row) for row in np.asarray(arr))


def test_shape_bytes():
    assert Collective("all-gather", (16, 256), "float32").nbytes == \
        16 * 256 * 4
    assert Collective("all-gather", (8,), "bfloat16").nbytes == 16
    # a tuple result (f32[4,4], bf16[2,2]) is two records
    assert sum(Collective("all-reduce", s, d).nbytes for s, d in
               (((4, 4), "float32"), ((2, 2), "bfloat16"))) == 64 + 8
    assert Collective("all-gather", (10,), "bool").nbytes == 10


# the reference's crafted HLO, as records
RECORDS = [
    # ag f32[1024,256], replica_groups=[16,16]<=[16,16]T(1,0)
    Collective("all-gather", (1024, 256), "float32",
               _groups(iota_groups((16, 16), (1, 0), 16))),
    # ar bf16[128], replica_groups=[4,64]<=[256]
    Collective("all-reduce", (128,), "bfloat16",
               _groups(iota_groups((256,), None, 64))),
    # rs f32[64], replica_groups={{0,1,2,3}}
    Collective("reduce-scatter", (64,), "float32", ((0, 1, 2, 3),)),
    # a2a f32[32,32], replica_groups=[2,8]<=[16]
    Collective("all-to-all", (32, 32), "float32",
               _groups(iota_groups((16,), None, 8))),
    # cp f32[16], source_target_pairs={{0,1}}
    Collective("collective-permute", (16,), "float32", pairs=((0, 1),)),
]


def test_collective_parser():
    """The -done line and the dot of the reference's text are no
    records: the recorder keeps collectives, once each (it does not
    count ``wait_tensor``)."""
    out = collective_bytes(RECORDS)
    g = 16
    assert np.isclose(out["all-gather"], 1024 * 256 * 4 * (g - 1) / g)
    assert np.isclose(out["all-reduce"], 2 * 128 * 2 * 63 / 64)
    assert np.isclose(out["reduce-scatter"], 64 * 4 * 3)     # (g-1)*result
    assert np.isclose(out["all-to-all"], 32 * 32 * 4 * 7 / 8)
    assert np.isclose(out["collective-permute"], 16 * 4)
    assert out["total"] == sum(v for k, v in out.items() if k != "total")


def test_collective_parser_start_counted_once():
    # all-reduce-start f32[8], replica_groups=[2,2]<=[4], and its -done
    out = collective_bytes([Collective("all-reduce", (8,), "float32",
                                       _groups(iota_groups((4,), None, 2)))])
    assert np.isclose(out["all-reduce"], 2 * 32 * 1 / 2)


def test_roofline_terms_dominance():
    t = roofline_terms(989e12, 335e8, 50e7)     # 1s compute, 0.01s others
    assert t["dominant"] == "compute_s"
    assert np.isclose(t["compute_s"], 1.0)
    assert np.isclose(t["memory_s"], 0.01)
    t2 = roofline_terms(1, 1, 50e9)
    assert t2["dominant"] == "collective_s" and np.isclose(t2["collective_s"],
                                                           1.0)
    assert t2["bound_s"] == t2["collective_s"]


def test_h100_constants():
    """The datasheet figures the module states (H100 SXM5 80 GB): dense
    bf16, HBM3, NVLink 4 one way, one 400 Gb/s NIC per card."""
    assert (rf.PEAK_FLOPS, rf.HBM_BW, rf.NVLINK_BW, rf.LINK_BW,
            rf.NODE_SIZE) == (989e12, 3.35e12, 450e9, 400e9 / 8, 8)


def test_param_counts_sane():
    total, active = matmul_param_counts(get_config("tinyllama-1.1b"))
    assert 0.9e9 < total < 1.3e9
    assert total == active                      # dense: all params active
    t_moe, a_moe = matmul_param_counts(get_config("deepseek-v3-671b"))
    assert 600e9 < t_moe < 750e9
    assert 25e9 < a_moe < 50e9                  # ~37B active


def test_model_flops_train_scale():
    cfg = get_config("tinyllama-1.1b")
    mf = model_flops(cfg, SHAPES["train_4k"])
    # 6*N*D with N~1.1e9, D=1.05e6 -> ~6.9e15 plus attention
    assert 6e15 < mf < 1.1e16


def test_model_flops_decode_much_smaller():
    cfg = get_config("tinyllama-1.1b")
    mf_d = model_flops(cfg, SHAPES["decode_32k"])
    mf_t = model_flops(cfg, SHAPES["train_4k"])
    assert mf_d < mf_t / 1000


def test_attention_flops_quadratic_in_seq():
    cfg = get_config("llama3.2-3b")
    f1 = attention_flops(cfg, 1, 1024, "train")
    f2 = attention_flops(cfg, 1, 2048, "train")
    assert np.isclose(f2 / f1, 4.0, rtol=0.01)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_flop_functions_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert matmul_param_counts(cfg) == jrf.matmul_param_counts(jcfg)
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        assert model_flops(cfg, shape) == jrf.model_flops(jcfg, jshape)
        for kind in ("train", "prefill", "decode"):
            B, S = shape.global_batch, shape.seq_len
            assert attention_flops(cfg, B, S, kind) == \
                jrf.attention_flops(jcfg, B, S, kind)


# ---------------------------------------------------------------------------
# tests/test_hlo_span.py
# ---------------------------------------------------------------------------

def test_expand_iota_groups():
    """The recorder's replica groups of a mesh dim (``mesh_groups``, read
    from the device mesh of a fake 512-rank world) are XLA's iota groups
    with that dim moved last."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.comm_analysis import mesh_groups
    from repro_torch.launch.mesh import make_mesh
    # replica_groups=[16,32]<=[2,16,16]T(1,0,2)
    g = iota_groups((2, 16, 16), (1, 0, 2), 32)
    assert g.shape == (16, 32)
    # T(1,0,2) on arange(512).reshape(2,16,16): row 0 mixes both pods
    assert set(np.unique(g[0] // 256)) == {0, 1}
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        dm = make_mesh((2, 16, 16), ("pod", "data", "model"),
                       "cpu").device_mesh
        groups = mesh_groups(dm)
        for d, perm in enumerate(((1, 2, 0), (0, 2, 1), (0, 1, 2))):
            want = iota_groups((2, 16, 16), perm, (2, 16, 16)[d])
            got = np.asarray(groups[dm.get_group(d).group_name])
            assert np.array_equal(got, want), d
    finally:
        dist.destroy_process_group()


def test_expand_list_groups():
    # replica_groups={{0,1,2},{3,4,5}}
    c = Collective("all-reduce", (4,), "float32", ((0, 1, 2), (3, 4, 5)))
    assert np.asarray(c.groups).tolist() == [[0, 1, 2], [3, 4, 5]]
    assert c.group_size == 3


def test_span_classification_intra_vs_cross():
    recs = [
        # group {0..15}: inside pod 0 (pod_size 256)
        Collective("all-reduce", (256,), "float32", (tuple(range(16)),)),
        # group {0, 256}: spans pods
        Collective("all-reduce", (256,), "float32", ((0, 256),)),
        # permute 0 -> 256 crosses; 1 -> 2 doesn't
        Collective("collective-permute", (64,), "float32",
                   pairs=((0, 256),)),
        Collective("collective-permute", (64,), "float32", pairs=((1, 2),)),
    ]
    out = collective_bytes_by_span(recs, span=256)
    intra = 2 * 1024 * 15 / 16 + 256      # AR ring + permute d
    cross = 2 * 1024 * 1 / 2 + 256        # AR {0,256} + permute c
    assert np.isclose(out["intra"], intra)
    assert np.isclose(out["cross"], cross)


def test_span_totals_match_plain_parser():
    recs = [
        # bf16[128,64] all-gather, replica_groups=[32,16]<=[512]
        Collective("all-gather", (128, 64), "bfloat16",
                   _groups(iota_groups((512,), None, 16))),
        # f32[32] reduce-scatter, replica_groups={{0,1,2,3}}
        Collective("reduce-scatter", (32,), "float32", ((0, 1, 2, 3),)),
    ]
    total = collective_bytes(recs)["total"]
    for span in (256, 8):
        out = collective_bytes_by_span(recs, span=span)
        assert np.isclose(total, out["intra"] + out["cross"])


def test_node_span_splits_the_production_axes():
    """On the production (pod 2, data 16, model 16) mesh with nodes of 8
    ranks: a model group (16 consecutive ranks) spans two nodes, a data
    group (stride 16) sixteen, and a group of 8 consecutive ranks one."""
    mesh = np.arange(512).reshape(2, 16, 16)
    model = _groups(np.moveaxis(mesh, 2, -1).reshape(-1, 16))
    data = _groups(np.moveaxis(mesh, 1, -1).reshape(-1, 16))
    for groups, cross in ((model, True), (data, True),
                          (tuple(tuple(range(i, i + 8))
                                 for i in range(0, 512, 8)), False)):
        out = collective_bytes_by_span(
            [Collective("all-reduce", (1024,), "float32", groups)])
        assert (out["cross"] > 0) == cross and (out["intra"] > 0) != cross
