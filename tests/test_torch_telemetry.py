"""The port's telemetry on the CPU: MDSS's hashing spans (``mdss.hash``
with its ``mdss.to_host`` and ``mdss.sha256`` children), the run's
``submit`` span, each FrontDoor request's ``frontdoor.request`` /
``frontdoor.wait`` spans and their link to the fused run, the
``telemetry`` switch of ``Trainer`` and of a ``Server``'s runtime, the coalescer's
bounded event ring, and the program's spans as user annotations in a
``torch.profiler`` trace.
"""
import collections
import hashlib
import json
import pickle
import threading

import numpy as np
import pytest
import torch

from repro_torch.cloud import wire
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig, ShapeProfile, reduced
from repro_torch.core import (CostModel, EmeraldRuntime, MDSS,
                              MigrationManager, Workflow, default_tiers)
from repro_torch.core import batching
from repro_torch.core.batching import BatchCoalescer
from repro_torch.launch.serve import FrontDoor, Server
from repro_torch.launch.train import Trainer
from repro_torch.obs.tracing import Tracer

Pair = collections.namedtuple("Pair", "a b")


def manager():
    tiers = default_tiers(cloud_device="cpu")
    cm = CostModel(tiers)
    return MigrationManager(tiers, MDSS(tiers, cost_model=cm), cm)


def trainer(telemetry=True):
    cfg = reduced(get_config("falcon-mamba-7b"), n_layers=2)
    run = RunConfig(model=cfg, shape=ShapeProfile("t", 16, 2, "train"),
                    remat="none")
    return Trainer(run, device="cpu", telemetry=telemetry)


def by_id(spans):
    return {s.span_id: s for s in spans}


def children(spans, parent, name):
    return [s for s in spans if s.parent_id == parent.span_id
            and s.name == name]


def nbytes(value):
    return sum(b.nbytes for b in wire.host_buffers(value)[1])


# ------------------------------------------------------------- hashing
def test_hash_spans_nest_under_install_with_bytes_and_counters():
    tr = trainer()
    try:
        tr.fit(2, log_every=0)
        spans = tr.runtime.tracer.spans()
        params = tr.mdss.peek_latest("params")[0]
        opt = tr.mdss.peek_latest("opt_state")[0]
    finally:
        tr.close()
    installs = [s for s in spans if s.name == "install"
                and s.attrs.get("step") == "train_step"]
    assert len(installs) == 2
    for ins in installs:
        hashes = {s.attrs["uri"].rsplit("/", 1)[-1]: s
                  for s in children(spans, ins, "mdss.hash")}
        assert set(hashes) == {"params", "opt_state", "metrics"}
        sha_bytes = {}
        for uri, h in hashes.items():
            assert "step" not in h.attrs
            (copy,) = children(spans, h, "mdss.to_host")
            (sha,) = children(spans, h, "mdss.sha256")
            assert copy.attrs["bytes"] == 0          # nothing on a device
            sha_bytes[uri] = sha.attrs["bytes"]
            assert h.t0_wall <= copy.t0_wall
            assert copy.t0_wall + copy.dur_s <= sha.t0_wall + 1e-6
            assert sha.t0_wall + sha.dur_s <= h.t0_wall + h.dur_s + 1e-6
        assert sha_bytes["params"] == nbytes(params)
        assert sha_bytes["opt_state"] == nbytes(opt)
    # each step's batch, and the first step's params and state, are
    # hashed in that run's submit span
    submits = [s for s in spans if s.name == "submit"]
    assert len(submits) == 2
    first = {by_id(spans)[s.parent_id].attrs["uri"].rsplit("/", 1)[-1]
             for s in spans if s.name == "mdss.to_host"
             and by_id(spans)[s.parent_id].parent_id == submits[0].span_id}
    assert first == {"params", "opt_state", "batch"}


def _manifest_before_split(value, chunk_bytes=wire.CHUNK_BYTES):
    """``wire.manifest_of`` as it was written before the copy to the host
    and the digests were split apart."""
    buffers = []
    skeleton = wire._strip(value, buffers)
    h = hashlib.sha256(pickle.dumps(skeleton,
                                    protocol=pickle.HIGHEST_PROTOCOL))
    chunks = []
    for mv in buffers:
        for off in range(0, mv.nbytes, chunk_bytes):
            d = wire.digest_of(mv[off:off + chunk_bytes])
            chunks.append((d, len(mv[off:off + chunk_bytes])))
            h.update(d)
    return h.digest()[:wire.DIGEST_BYTES], chunks


VALUES = {
    "bf16": torch.arange(3 * (1 << 19), dtype=torch.float32)
    .reshape(3, -1).to(torch.bfloat16),
    "f32": torch.linspace(-1, 1, 1000).reshape(10, 100),
    "int": torch.arange(70000, dtype=torch.int64),
    "numpy": np.arange(12, dtype=np.int32).reshape(3, 4),
    "strided": torch.arange(64.0).reshape(8, 8).t(),
    "nested": {"w": [torch.ones(4, dtype=torch.bfloat16), np.float32(2.0)],
               "t": (torch.zeros(2, 3), {"k": np.arange(5)}),
               "p": Pair(torch.arange(6, dtype=torch.int32), "tag"),
               "none": None, "scalar": 7},
}


@pytest.mark.parametrize("name", list(VALUES))
def test_hash_helper_matches_manifest_of(name):
    value = VALUES[name]
    want = _manifest_before_split(value)
    assert wire.manifest_of(value) == want
    store = MDSS(default_tiers(cloud_device="cpu"))
    assert store._hash("x", value) == want           # telemetry off
    store.tracer = Tracer()
    assert store._hash("x", value) == want           # telemetry on
    spans = store.tracer.spans()
    (h,) = [s for s in spans if s.name == "mdss.hash"]
    assert h.attrs == {"uri": "x"}
    (sha,) = children(spans, h, "mdss.sha256")
    assert sha.attrs == {"bytes": nbytes(value)}


class _OnDevice(torch.Tensor):
    """A host tensor that reports itself off the host."""

    @property
    def is_cpu(self):
        return False


def test_to_host_counts_only_device_bytes():
    dev = torch.ones(100, dtype=torch.float32).as_subclass(_OnDevice)
    value = {"dev": dev, "host": torch.ones(50), "np": np.ones(10)}
    skeleton, buffers, moved = wire.host_buffers(value)
    assert moved == 400
    assert sum(b.nbytes for b in buffers) == 400 + 200 + 80
    assert wire.digest_buffers(skeleton, buffers) == wire.manifest_of(value)


@pytest.mark.cuda
def test_to_host_bytes_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    store = MDSS(default_tiers(cloud_device="cpu"))
    store.tracer = Tracer()
    value = {"dev": torch.ones(256, device="cuda"), "host": torch.ones(8)}
    store._hash("x", value)
    (copy,) = [s for s in store.tracer.spans() if s.name == "mdss.to_host"]
    assert copy.attrs["bytes"] == 1024


def test_submit_span_in_the_runs_trace():
    wf = Workflow("double")
    wf.var("x")
    wf.step("s", lambda x: {"y": x * 2}, inputs=("x",), outputs=("y",),
            remotable=False, device_step=False)
    with EmeraldRuntime(manager(), max_workers=2) as rt:
        h = rt.submit(wf, {"x": np.arange(8.0)})
        h.result(30)
        spans = rt.tracer.spans(h.trace_id)
    (run,) = [s for s in spans if s.name == "run"]
    (sub,) = [s for s in spans if s.name == "submit"]
    assert sub.parent_id == run.span_id and run.parent_id == 0
    assert run.t0_wall <= sub.t0_wall
    (h,) = children(spans, sub, "mdss.hash")
    assert h.attrs["uri"].endswith("x")
    (sha,) = children(spans, h, "mdss.sha256")
    assert sha.attrs["bytes"] == 64


# ------------------------------------------------------------ FrontDoor
def _decode_fn(tokens):
    return np.asarray(tokens, dtype=np.float64) * 2.0


def _serve(rt, groups):
    fd = FrontDoor(rt, _decode_fn, window_s=0.2, max_batch=4)
    try:
        rows = []
        for group in groups:
            tickets = [fd.decode(np.full(3, i)) for i in group]
            rows += [t.result(30) for t in tickets]
        return rows
    finally:
        fd.close()


def test_each_request_leads_to_its_fused_run():
    with EmeraldRuntime(manager(), max_workers=2) as rt:
        rows = _serve(rt, [range(4), range(4, 6)])
        spans = rt.tracer.spans()
    for i, row in enumerate(rows):
        np.testing.assert_array_equal(row, np.full(3, 2.0 * i))
    ids = by_id(spans)
    reqs = [s for s in spans if s.name == "frontdoor.request"]
    waits = [s for s in spans if s.name == "frontdoor.wait"]
    assert len(reqs) == len(waits) == 6
    assert len({s.trace_id for s in reqs}) == 6
    batches = set()
    for w in waits:
        req = ids[w.parent_id]
        assert req.name == "frontdoor.request"
        assert req.trace_id == w.trace_id
        assert "step" not in req.attrs and "step" not in w.attrs
        assert req.t0_wall == w.t0_wall and w.dur_s <= req.dur_s
        fused = ids[w.attrs["batch_span"]]
        assert fused.name == "fused_batch"
        assert w.t0_wall + w.dur_s == pytest.approx(fused.t0_wall, abs=1e-6)
        run = {s.name for s in spans if s.trace_id == fused.trace_id}
        assert {"run", "submit", "ship", "exec", "install"} <= run
        batches.add(fused.span_id)
    assert sorted(ids[b].attrs["batch"] for b in batches) == [2, 4]


def test_tracer_off_records_nothing():
    with EmeraldRuntime(manager(), max_workers=2, telemetry=False) as rt:
        _serve(rt, [range(4)])
        assert rt.tracer.spans() == []
        assert rt.metrics.snapshot() == {}
        assert rt.mdss.tracer is rt.tracer          # MDSS's spans are off too
        assert "frontdoor.flushes" not in rt.metrics.names()


def test_trainer_telemetry_switch():
    losses = {}
    for on in (True, False):
        tr = trainer(telemetry=on)
        try:
            losses[on] = [h["loss"] for h in tr.fit(3, log_every=0)]
            spans = tr.runtime.tracer.spans()
            snap = tr.runtime.metrics.snapshot()
        finally:
            tr.close()
        assert bool(spans) == on
        assert any(s.name == "mdss.sha256" for s in spans) == on
        assert bool(snap) == on
    assert losses[True] == losses[False]


def test_server_telemetry_switch():
    cfg = reduced(get_config("falcon-mamba-7b"), n_layers=2)
    run = RunConfig(model=cfg, shape=ShapeProfile("s", 32, 2, "decode"),
                    remat="none")
    for on in (True, False):
        with EmeraldRuntime(manager(), name="serve", telemetry=on) as rt:
            srv = Server(run, {}, runtime=rt)
            assert srv.runtime is rt and srv.mdss is rt.mdss
            assert srv.runtime.tracer.enabled is on
            assert srv.mdss.tracer is rt.tracer
            assert srv.runtime.metrics.enabled is on


def test_coalescer_events_are_a_ring(monkeypatch):
    monkeypatch.setattr(batching, "EVENTS_CAP", 3)
    c = BatchCoalescer(lambda key, stacked, k: stacked, window_s=0.001,
                       max_batch=1)
    try:
        for i in range(5):
            c.submit("k", np.float64(i)).result(5.0)
        assert c.flushes == 5
        assert [e.kind for e in c.events] == ["flush"] * 3
    finally:
        c.close()


# ------------------------------------------------------------- profiler
def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("all_threads", [False, True])
def test_program_span_is_a_profiler_annotation(tmp_path, all_threads):
    from torch.profiler import ProfilerActivity, profile
    tracer = Tracer()
    kw = {}
    if all_threads:
        kw["experimental_config"] = \
            torch._C._profiler._ExperimentalConfig(profile_all_threads=True)

    def lane():
        with tracer.span("emerald.lane"):
            torch.ones(4).sum()

    with tracer.span("emerald.before"):
        pass
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        with tracer.span("emerald.phase"):
            torch.ones(4).sum()
        if all_threads:
            t = threading.Thread(target=lane)
            t.start()
            t.join()
    with tracer.span("emerald.after"):
        pass
    got = _annotations(prof, tmp_path)
    assert "emerald.phase" in got
    assert ("emerald.lane" in got) == all_threads
    assert "emerald.before" not in got and "emerald.after" not in got
    assert [s.name for s in tracer.spans()] == \
        ["emerald.before", "emerald.phase"] \
        + (["emerald.lane"] if all_threads else []) + ["emerald.after"]
