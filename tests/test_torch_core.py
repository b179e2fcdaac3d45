"""The port's runtime (``repro_torch.core`` on ``default_tiers(cloud_device=
"cpu")``) held against the JAX runtime on the same workflows: the same
outputs, event kinds, offload counts and MDSS bytes moved."""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.cloud import wire as jwire
from repro_torch.analysis import verify
from repro_torch.cloud import wire as twire
from repro_torch.core import tiers as ttiers


class _Side:
    """What differs between the two packages in these scenarios."""

    def __init__(self, name):
        self.name = name
        self.core = jcore if name == "jax" else tcore
        # the reference's steps are jax steps; the port's run on the device
        self.device_kw = "jax_step" if name == "jax" else "device_step"

    def tiers(self):
        return self.core.default_tiers() if self.name == "jax" \
            else self.core.default_tiers(cloud_device="cpu")

    def manager(self):
        tiers = self.tiers()
        cm = self.core.CostModel(tiers)
        mdss = self.core.MDSS(tiers, cost_model=cm)
        return self.core.MigrationManager(tiers, mdss, cm)

    def array(self, a):
        return jnp.asarray(a) if self.name == "jax" else torch.from_numpy(a)


SIDES = [_Side("jax"), _Side("torch")]


def _diamond(side):
    mgr = side.manager()
    core = side.core
    wf = core.Workflow("diamond")
    wf.var("x")
    wf.step("src", lambda x: {"a": x + 1}, inputs=("x",), outputs=("a",))
    wf.step("l", lambda a: {"b": a * 2}, inputs=("a",), outputs=("b",),
            remotable=True)
    wf.step("r", lambda a: {"c": a * 3}, inputs=("a",), outputs=("c",),
            remotable=True)
    wf.step("sink", lambda b, c: {"y": b + c}, inputs=("b", "c"),
            outputs=("y",))
    ex = core.EmeraldExecutor(core.partition(wf), mgr)
    out = ex.run({"x": side.array(np.arange(6, dtype=np.float32))})
    a_moves = [e for e in mgr.mdss.sync_events
               if e[0] == "a" and e[2] == "cloud"]
    kinds = collections.Counter(e.kind for e in ex.events
                                if e.kind != "prefetch")
    offloads = sorted(e.step for e in ex.events if e.kind == "offload")
    return {"y": np.asarray(out["y"]).tolist(), "a_moves": len(a_moves),
            "kinds": dict(kinds), "offloads": offloads,
            "bytes_moved": dict(mgr.mdss.bytes_moved)}


def test_diamond_matches_reference():
    got = {s.name: _diamond(s) for s in SIDES}
    assert got["torch"] == got["jax"]
    assert got["torch"]["y"] == [2 * (x + 1) + 3 * (x + 1) for x in range(6)]
    # both branches offloaded; 'a' moved to the cloud exactly once
    assert got["torch"]["a_moves"] == 1
    assert got["torch"]["offloads"] == ["l", "r"]


def _warm_resubmission(side):
    mgr = side.manager()
    big = side.array(np.ones((64, 1024), np.float32))

    def build():
        wf = side.core.Workflow("warmjob")
        wf.var("params")
        wf.step("use", lambda params: {"out": params.sum()},
                inputs=("params",), outputs=("out",), remotable=True,
                **{side.device_kw: True})
        return wf

    with side.core.EmeraldRuntime(mgr) as rt:
        rt.publish("params", big)
        h1 = rt.submit(build(), {})
        out1 = float(h1.result(30)["out"])
        moved1 = mgr.mdss.namespace_bytes(rt.shared_namespace)
        hits = mgr.compile_cache_hits
        h2 = rt.submit(build(), {})
        out2 = float(h2.result(30)["out"])
        return {"out": (out1, out2), "moved": (
            moved1, mgr.mdss.namespace_bytes(rt.shared_namespace)),
            "code_only": [e.info["code_only"] for h in (h1, h2)
                          for e in h.events if e.kind == "offload"],
            "cache_hit": mgr.compile_cache_hits > hits,
            "bytes_moved": dict(mgr.mdss.bytes_moved)}


def test_repeat_offload_is_code_only_as_in_reference():
    got = {s.name: _warm_resubmission(s) for s in SIDES}
    assert got["torch"] == got["jax"]
    assert got["torch"]["code_only"] == [False, True]
    assert got["torch"]["moved"] == (64 * 1024 * 4, 64 * 1024 * 4)


def _fences(side):
    m = side.manager().mdss
    arr = side.array(np.arange(4, dtype=np.int32))
    out = [m.put("u", arr, tier="local"),
           m.put("u", arr, tier="cloud", expect_version=0),   # stale: refused
           m.put("u", arr + 1, tier="cloud", expect_version=1),
           m.put_many({"u": arr, "v": arr}, expect_versions={"u": 1}),
           m.put_many({"u": arr, "v": arr}, expect_versions={"u": 2, "v": 0})]
    m.synchronize("u")
    return {"versions": out, "fenced": m.fenced_puts,
            "u": np.asarray(m.get("u", "local")).tolist(),
            "bytes_moved": dict(m.bytes_moved)}


def test_fenced_puts_match_reference():
    got = {s.name: _fences(s) for s in SIDES}
    assert got["torch"] == got["jax"]
    assert got["torch"]["versions"][1] is None
    assert got["torch"]["fenced"] == 2


def test_default_tiers_put_the_cloud_on_the_card():
    if torch.cuda.is_available():
        assert tcore.default_tiers()["cloud"].device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcore.default_tiers()
    tiers = tcore.default_tiers(cloud_device="cpu")
    assert tiers["local"].device.type == "cpu"
    assert tiers["cloud"].chips == 1
    assert tiers["cloud"].peak_flops == ttiers.H100_PEAK_BF16_FLOPS


def test_transport_moves_tensors_to_the_destination_device():
    tiers = tcore.default_tiers(cloud_device="meta")
    value = {"w": torch.ones(3), "n": 7, "a": np.zeros(2)}
    moved = tcore.Transport(tiers).transfer(value, "local", "cloud")
    assert moved["w"].device.type == "meta"
    assert moved["n"] == 7 and moved["a"] is value["a"]
    back = tcore.Transport(tiers).transfer({"w": torch.ones(3)}, "cloud",
                                           "local")
    assert back["w"].device.type == "cpu"


def test_manifest_chunks_match_reference_wire():
    a = np.random.default_rng(0).normal(size=(300, 1024)).astype(np.float32)
    tree = {"p": a, "q": [a[:7], np.arange(5, dtype=np.int32)]}
    ttree = {"p": torch.from_numpy(a),
             "q": [torch.from_numpy(a[:7]), torch.arange(5, dtype=torch.int32)]}
    assert twire.manifest_of(ttree)[1] == jwire.manifest_of(tree)[1]
    assert len(twire.manifest_of(ttree)[1]) == 4       # 1.2 MB -> 2 chunks
    # bfloat16 is hashed by its bits and tagged: never equal to int16 bits
    b = torch.randn(8, dtype=torch.bfloat16)
    assert twire.manifest_of(b)[1] == twire.manifest_of(b.view(torch.int16))[1]
    assert twire.content_digest(b) != twire.content_digest(b.view(torch.int16))


def test_verifier_flags_captured_device_tensors():
    dev = torch.ones(2, device="meta")
    host = torch.ones(2)
    wf = tcore.Workflow("w")
    wf.var("x")
    wf.step("on_dev", lambda x: {"y": x + dev}, inputs=("x",), outputs=("y",),
            remotable=True)
    wf.step("on_host", lambda y: {"z": y + host}, inputs=("y",),
            outputs=("z",), remotable=True)
    w021 = [f for f in verify(wf, provided={"x"}) if f.rule == "W021"]
    assert [f.steps for f in w021] == [("on_dev",)]
