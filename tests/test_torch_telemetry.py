"""The port's telemetry on the CPU: MDSS's hashing spans (``mdss.hash``
with its ``mdss.to_host`` and ``mdss.sha256`` children), MDSS's choice
between hashing a value's device leaves on the host and on the card
(``CARD_HASH_CHUNKS``, through tensors that report themselves off the
host) and the SHA-256 kernel wrapper's chunk table, the run's
``submit`` span, each FrontDoor request's ``frontdoor.request`` /
``frontdoor.wait`` spans and their link to the fused run, the
``telemetry`` switch of ``Trainer`` and of a ``Server``'s runtime, the coalescer's
bounded event ring, and the program's spans as user annotations in a
``torch.profiler`` trace.
"""
import collections
import ctypes
import hashlib
import json
import os
import pathlib
import pickle
import subprocess
import sys
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
from repro_torch.core import mdss as mdss_mod
from repro_torch.core.batching import BatchCoalescer
from repro_torch.kernels.sha256 import kernel as sha_kernel
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
    assert sha.attrs == {"bytes": nbytes(value), "card_bytes": 0}


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


# ------------------------------------------------- hashing on the card
K = mdss_mod.CARD_HASH_CHUNKS
MiB = wire.CHUNK_BYTES


def _dev(nbytes, dtype=torch.uint8):
    """A host tensor of ``nbytes`` seeded bytes that reports itself off
    the host."""
    g = torch.Generator().manual_seed(nbytes)
    raw = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, generator=g)
    return raw.view(dtype).as_subclass(_OnDevice)


def _stand_in(tables):
    """The kernel's contract on host memory: each (src, len, out) row's
    truncated SHA-256 written to ``out``; the rows kept in ``tables``."""
    def launch(table, n):
        rows = table.tolist()
        assert len(rows) == n
        for src, ln, out in rows:
            assert src % 16 == 0 and out % 16 == 0
            d = wire.digest_of(ctypes.string_at(src, ln))
            ctypes.memmove(out, d, len(d))
        tables.append(rows)
    return launch


@pytest.mark.parametrize("leaves,on_card", [
    ([(K - 1) * MiB], False),
    ([(K - 1) * MiB + 1], True),
    ([MiB] * (K - 1) + [1], True),
    ([1] * K, True),
    ([1] * (K - 1), False),
])
def test_card_routing_at_the_chunk_threshold(leaves, on_card):
    value = {"dev": [_dev(n) for n in leaves],
             "host": torch.ones(3 * MiB, dtype=torch.uint8),
             "np": np.ones(2 * MiB, dtype=np.uint8)}
    dev_bytes = sum(leaves)
    assert mdss_mod.hashes_on_card(value) is on_card
    store = MDSS(default_tiers(cloud_device="cpu"))
    store.tracer = Tracer()
    assert store._hash("x", value) == wire.manifest_of(value)
    spans = store.tracer.spans()
    (copy,) = [s for s in spans if s.name == "mdss.to_host"]
    (sha,) = [s for s in spans if s.name == "mdss.sha256"]
    assert copy.attrs["bytes"] == (0 if on_card else dev_bytes)
    assert sha.attrs == {"bytes": dev_bytes + 5 * MiB,
                         "card_bytes": dev_bytes if on_card else 0}


def test_host_leaves_do_not_count_toward_the_card():
    value = [_dev((K - 1) * MiB), torch.ones(K * MiB, dtype=torch.uint8),
             np.ones(K * MiB, dtype=np.uint8)]
    assert not mdss_mod.hashes_on_card(value)
    assert mdss_mod.hashes_on_card(value + [_dev(1)])


def _mixed():
    base = torch.arange(3000, dtype=torch.float32)
    return {
        "w": [_dev(2 * MiB + 3, torch.uint8), np.float32(2.0),
              torch.arange(9, dtype=torch.float32),
              _dev(2 * 4099, torch.bfloat16)],
        "t": (_dev(8 * 700, torch.int64), {"k": np.arange(5)},
              _dev(301, torch.bool)),
        "p": Pair(_dev(4, torch.float32).reshape(()), "tag"),
        "empty": _dev(0, torch.float32).reshape(0, 3),
        "strided": base.reshape(60, 50).t().as_subclass(_OnDevice),
        "odd": base[1:].as_subclass(_OnDevice),
        "host": torch.ones(7, dtype=torch.bfloat16),
        "none": None, "scalar": 7,
    }


@pytest.mark.parametrize("chunk_bytes", [80, 4096, wire.CHUNK_BYTES])
def test_card_path_keeps_the_skeleton_order_and_chunks(chunk_bytes):
    value = _mixed()
    skeleton, buffers, _ = wire.host_buffers(value)
    kskel, kept, moved = wire.host_buffers(value, leave_on_device=True)
    assert kskel == skeleton and moved == 0
    assert len(kept) == len(buffers)
    devs = [i for i, b in enumerate(kept) if isinstance(b, torch.Tensor)]
    assert len(devs) == 8
    assert all(isinstance(kept[i], memoryview) for i in range(len(kept))
               if i not in devs)
    tables = []
    got = sha_kernel._run([kept[i] for i in devs], chunk_bytes,
                          _stand_in(tables))
    (rows,) = tables
    want = wire.digest_buffers(skeleton, buffers, chunk_bytes)
    at = 0
    for i, ds in zip(devs, got):
        n = buffers[i].nbytes
        bounds = [(off, min(chunk_bytes, n - off))
                  for off in range(0, n, chunk_bytes)]
        mine = rows[at:at + len(bounds)]
        assert [(src - mine[0][0], ln) for src, ln, _ in mine] == bounds
        assert ds == [wire.digest_of(buffers[i][o:o + ln])
                      for o, ln in bounds]
        at += len(bounds)
    assert at == len(rows)
    assert wire.digest_buffers(kskel, kept, chunk_bytes,
                               dict(zip(devs, got))) == want
    if chunk_bytes == wire.CHUNK_BYTES:
        assert mdss_mod._digests(kskel, kept) == wire.manifest_of(value)


LENGTHS = [0, 1, 55, 56, 63, 64, 65, 119, MiB - 1, MiB, MiB + 1,
           7 * MiB // 2]


@pytest.mark.parametrize("n", LENGTHS)
def test_chunk_table_digests_match_digest_of(n):
    t = _dev(n).as_subclass(torch.Tensor)
    want = [wire.digest_of(bytes(t.numpy()[o:o + MiB]))
            for o in range(0, n, MiB)]
    assert sha_kernel.chunk_digests([t]) == [want]
    assert sha_kernel._run([t], MiB, _stand_in([])) == [want]


def test_chunk_digests_refuse_what_they_cannot_hash():
    with pytest.raises(ValueError, match="meta"):
        sha_kernel.chunk_digests([torch.empty(4, device="meta")])


_WIRE_WITHOUT_TORCH = r"""
import sys
sys.modules["torch"] = None        # any `import torch` now raises
import numpy as np
from repro_torch.cloud import wire
value = {"a": np.arange(70000, dtype=np.int64),
         "b": [np.float32(2.0), np.ones((3, 4), dtype=np.bool_)]}
print(wire.manifest_of(value)[0].hex())
"""


def test_wire_imports_and_hashes_without_torch():
    """The wire format, which fabric workers load, keeps no import of
    torch: a value's manifest is the one this process computes."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, "-c", _WIRE_WITHOUT_TORCH],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    value = {"a": np.arange(70000, dtype=np.int64),
             "b": [np.float32(2.0), np.ones((3, 4), dtype=np.bool_)]}
    assert res.stdout.split()[-1] == wire.manifest_of(value)[0].hex()


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
