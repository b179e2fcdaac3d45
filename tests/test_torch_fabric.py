"""The port's offload fabric (``repro_torch.cloud``) with real worker
subprocesses on the CPU: the counterparts of ``tests/test_fabric.py``, the
fabric cases of ``tests/test_executor_faults.py`` and
``tests/test_runtime.py``, and the wire and dedup cases of
``tests/test_dataplane.py``; plus what only the port has — tensors on the
wire, bfloat16 through a worker that holds no torch, decoded values placed
on the destination tier's device, and the adjoint-tomography workflow with
the fabric behind the cloud tier.

Every test that waits on a worker runs under ``deadline``: a hang fails
that test instead of stalling the suite.
"""
import functools
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.apps import adjoint_tomography as tat
from repro_torch.cloud import (Autoscaler, AutoscalerConfig, BF16Bits, Fabric,
                               FabricError, RemoteStepError, ShipTimeout,
                               WorkerLostError, attach)
from repro_torch.cloud.wire import (CHUNK_BYTES, ChannelStore, WireError,
                                    decode, encode, manifest_of, recv_msg,
                                    send_msg)
from repro_torch.core import (CostModel, EmeraldExecutor, EmeraldRuntime,
                              MDSS, MigrationManager, Workflow, default_tiers,
                              partition)


def deadline(seconds):
    """Fail the test when its body outlives ``seconds``: the body runs on
    a daemon thread joined with that timeout."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:      # re-raised on the caller
                    box["err"] = e

            t = threading.Thread(target=body, daemon=True, name=fn.__name__)
            t.start()
            t.join(seconds)
            if t.is_alive():
                pytest.fail(f"{fn.__name__} still running after {seconds} s")
            if "err" in box:
                raise box["err"]
        return run
    return wrap


def cpu_tiers(cloud_device="cpu"):
    tiers = default_tiers(cloud_device=cloud_device)
    cm = CostModel(tiers)
    return tiers, cm, MDSS(tiers, cost_model=cm)


# --------------------------------------------------------------- wire format
def nested_value():
    return {
        "params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                   "b": np.zeros(4, dtype=np.float64)},
        "meta": ("adam", 3, 0.1, None, b"blob"),
        "history": [np.int32(7), {"nested": [np.ones((2, 2, 2))]}],
        "flag": True,
        "name": "step-0",
    }


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b) and type(a) is type(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_wire_roundtrip_nested_pytree():
    val = nested_value()
    data = encode(val)
    assert len(data) > sum(a.nbytes for a in (val["params"]["w"],
                                              val["params"]["b"]))
    assert_trees_equal(decode(data), val)


def test_wire_roundtrip_tensors_become_numpy():
    out = decode(encode({"x": torch.arange(8.0), "s": torch.tensor(2.0)}))
    assert isinstance(out["x"], np.ndarray)
    np.testing.assert_array_equal(out["x"], np.arange(8.0))
    assert out["s"].shape == () and float(out["s"]) == 2.0
    # a 0-d array stays 0-d through a second crossing (the JAX package's
    # wire makes it 1-d)
    assert decode(encode(out))["s"].shape == ()


def test_wire_bfloat16_tensor_decodes_as_tagged_bits():
    t = torch.randn(5, 3).to(torch.bfloat16)
    got = decode(encode({"t": t}))["t"]
    assert isinstance(got, BF16Bits) and got.dtype == np.int16
    np.testing.assert_array_equal(got.view(np.ndarray),
                                  t.view(torch.int16).numpy())
    # the tag survives a second crossing: same bytes, same digests
    assert encode({"t": got}) == encode({"t": t})
    assert manifest_of(got) == manifest_of(t)
    # and never collides with an int16 array of the same bits
    assert manifest_of(t)[0] != manifest_of(t.view(torch.int16).numpy())[0]


def test_wire_framing_over_socket():
    a, b = socket.socketpair()
    msgs = [{"op": "x", "v": np.arange(1000)}, {"op": "y"}, [1, 2, 3]]
    sent = []

    def writer():
        for m in msgs:
            sent.append(send_msg(a, m))

    t = threading.Thread(target=writer)
    t.start()
    received = [recv_msg(b) for _ in msgs]
    t.join(30)
    assert not t.is_alive()
    assert len(sent) == len(msgs)
    for m, n, (got, nread) in zip(msgs, sent, received):
        assert_trees_equal(got, m)
        assert nread == n
    a.close()
    b.close()


@pytest.mark.parametrize("value", [{}, [], (), None, {"a": {}, "b": []}])
def test_wire_empty_pytrees(value):
    got = decode(encode(value))
    assert got == value and type(got) is type(value)


def test_wire_zero_length_buffers():
    val = {"z": np.empty((0, 3), np.float32), "w": torch.zeros(0),
           "ok": np.arange(2)}
    got = decode(encode(val))
    assert got["z"].shape == (0, 3) and got["z"].dtype == np.float32
    assert got["w"].shape == (0,)
    np.testing.assert_array_equal(got["ok"], np.arange(2))


def test_wire_multi_chunk_frame():
    big = {"x": torch.rand((3 * CHUNK_BYTES) // 8 + 17, dtype=torch.float64)}
    _, chunks = manifest_of(big["x"])
    assert len(chunks) == 4
    got = decode(encode(big))
    np.testing.assert_array_equal(got["x"], big["x"].numpy())
    got["x"][0] = -1.0                       # decoded arrays are writable


def test_wire_corrupted_digest_raises_not_hangs():
    data = bytearray(encode({"x": np.random.rand(4096)}, ChannelStore()))
    data[-3] ^= 0xFF                         # flip a payload byte
    with pytest.raises(WireError, match="digest mismatch"):
        decode(bytes(data), ChannelStore())


def test_wire_unknown_reference_raises():
    tx = ChannelStore()
    encode({"x": np.ones(4096)}, tx)         # primes the sender mirror
    ref_frame = encode({"x": np.ones(4096)}, tx)   # all references
    with pytest.raises(WireError, match="unknown chunk digest"):
        decode(ref_frame, ChannelStore())    # receiver never saw them


def test_wire_bad_magic_raises():
    with pytest.raises(WireError, match="magic"):
        decode(b"NOPE" + b"\x00" * 32)


def test_socket_dedup_second_send_is_metadata_only():
    a, b = socket.socketpair()
    sa, sb = ChannelStore(), ChannelStore()
    big = {"x": torch.rand(1 << 18, dtype=torch.float64)}     # 2 MiB
    sizes = []

    def writer():
        sizes.append(send_msg(a, big, sa))
        sizes.append(send_msg(a, big, sa))

    t = threading.Thread(target=writer)
    t.start()
    v1, n1 = recv_msg(b, sb)
    v2, n2 = recv_msg(b, sb)
    t.join(30)
    a.close(), b.close()
    assert sizes == [n1, n2]
    np.testing.assert_array_equal(v2["x"], big["x"].numpy())
    assert n1 > big["x"].nbytes and n2 < 4096
    assert sa.saved_bytes >= big["x"].nbytes


# ------------------------------------------------------------ shared fabric
@pytest.fixture(scope="module")
def fabric():
    with Fabric(workers=2) as f:
        yield f


def _maps(pid):
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


@deadline(60)
def test_step_runs_in_separate_process_without_torch(fabric):
    out = fabric.broker.submit(step="pid").result(30)
    pid = int(out["pid"])
    assert pid != os.getpid()
    assert pid in fabric.broker.worker_pids()
    # a worker that had imported torch would map its shared libraries;
    # the driver, which has, does
    assert "libtorch" in _maps(os.getpid())
    assert "libtorch" not in _maps(pid)


@deadline(60)
def test_ship_moves_real_bytes(fabric):
    val = {"a": np.random.rand(1 << 12).astype(np.float32)}
    task = fabric.ship(val)
    np.testing.assert_array_equal(task.value["a"], val["a"])
    assert task.bytes_sent > val["a"].nbytes
    # the echo direction dedups against the request's own chunks
    assert task.bytes_received < 4096
    assert task.seconds > 0


@deadline(60)
def test_bfloat16_tensor_round_trips_a_torch_free_worker(fabric):
    """A bf16 tensor crosses into a worker that has no torch and comes
    back as the same bits; RPCTransport rebuilds it as a bf16 tensor."""
    from repro_torch.cloud.rpc_transport import _rebuild
    t = torch.randn(64, 33).to(torch.bfloat16)
    task = fabric.ship({"t": t})
    back = task.value["t"]
    assert isinstance(back, BF16Bits)
    got = _rebuild(task.value, {"t": t}, torch.device("cpu"))["t"]
    assert got.dtype == torch.bfloat16 and got.shape == t.shape
    assert torch.equal(got.view(torch.int16), t.view(torch.int16))
    # through a registry step too: the worker's echo returns the tagged
    # array untouched
    echoed = fabric.broker.submit(step="echo", kwargs={"p": t}).result(30)
    assert isinstance(echoed["p"], BF16Bits)
    np.testing.assert_array_equal(echoed["p"].view(np.ndarray),
                                  t.view(torch.int16).numpy())


@deadline(60)
def test_ship_timeout_cancels_queued_task():
    with Fabric(workers=1) as fabric:
        blocker = fabric.broker.submit(step="sleep",
                                       kwargs={"seconds": 0.5})
        time.sleep(0.05)                     # the only worker is busy
        with pytest.raises(ShipTimeout) as ei:
            fabric.ship({"a": np.arange(4)}, timeout=0.05)
        t = ei.value.task
        assert fabric.broker.queue_depth() == 0
        assert fabric.broker.tasks_cancelled == 1
        with pytest.raises(FabricError, match="cancelled"):
            t.result(1)
        blocker.result(30)
        assert fabric.broker.tasks_done == 1


@deadline(90)
def test_ship_timeout_inflight_task_stays_harvestable():
    with Fabric(workers=1) as fabric:
        val = {"a": np.random.rand(1 << 22).astype(np.float64)}   # 32 MiB
        with pytest.raises(ShipTimeout) as ei:
            fabric.ship(val, timeout=0.005)
        t = ei.value.task
        if fabric.broker.tasks_cancelled:
            pytest.skip("dispatcher lost the 5 ms race on a loaded box; "
                        "the queued branch is covered above")
        out = t.result(30)
        np.testing.assert_array_equal(out["a"], val["a"])
        assert fabric.broker.tasks_cancelled == 0


@deadline(60)
def test_remote_exception_keeps_worker_alive(fabric, tmp_path):
    n_before = fabric.broker.num_workers()
    t = fabric.broker.submit(step="fail_n_times", kwargs={
        "counter_file": str(tmp_path / "fails"), "n_fails": 99, "x": 0.0})
    with pytest.raises(RemoteStepError, match="injected step failure"):
        t.result(30)
    assert fabric.broker.num_workers() == n_before


@deadline(90)
def test_worker_crash_requeues_task(fabric, tmp_path):
    before = fabric.broker.tasks_requeued
    t = fabric.broker.submit(step="crash_n_times", kwargs={
        "counter_file": str(tmp_path / "crashes"), "n_crashes": 1, "x": 5.0})
    out = t.result(60)
    assert float(out["y"]) == 6.0
    assert fabric.broker.tasks_requeued == before + 1
    assert fabric.broker.workers_lost >= 1


@deadline(90)
def test_requeue_budget_exhaustion_raises(fabric, tmp_path):
    t = fabric.broker.submit(step="crash_n_times", max_attempts=1, kwargs={
        "counter_file": str(tmp_path / "always"), "n_crashes": 99, "x": 0.0})
    with pytest.raises(WorkerLostError):
        t.result(60)


# ---------------------------------------------------- MDSS / RPC transport
@deadline(60)
def test_rpc_transport_accounts_real_movement(fabric):
    tiers, cm, mdss = cpu_tiers()
    transport = attach(tiers, fabric, mdss=mdss, cost_model=cm)
    val = {"w": torch.rand(256, 16)}
    mdss.put("params", val, tier="local")
    assert mdss.stale_bytes(["params"], "cloud") == val["w"].nbytes
    moved = mdss.ensure(["params"], "cloud")
    assert moved == val["w"].nbytes
    got = mdss.get("params", "cloud")["w"]
    assert isinstance(got, torch.Tensor) and torch.equal(got, val["w"])
    assert transport.total_bytes_shipped() > val["w"].nbytes
    assert cm.measured_bw[("local", "cloud")] > 0
    assert mdss.ensure(["params"], "cloud") == 0


@deadline(60)
def test_decoded_values_land_on_the_destination_device(fabric):
    """The worker's numpy reply becomes tensors of the shipped dtypes on
    the destination tier's device (here the ``meta`` device stands in for
    the card); leaves that were numpy stay numpy. A metadata-only ship
    places the driver's own value on that device too."""
    tiers, cm, mdss = cpu_tiers(cloud_device="meta")
    transport = attach(tiers, fabric, mdss=mdss, cost_model=cm)
    val = {"f": torch.rand(8, 4), "h": torch.randn(3).to(torch.bfloat16),
           "i": torch.arange(5, dtype=torch.int32), "n": np.arange(3.0)}
    out, owed = transport.transfer_ex(val, "local", "cloud")
    assert owed == sum(int(v.nbytes) for v in val.values())
    for k in ("f", "h", "i"):
        assert out[k].device.type == "meta" and out[k].dtype == val[k].dtype
        assert out[k].shape == val[k].shape
    assert isinstance(out["n"], np.ndarray)
    _, chunks = manifest_of(val)
    out2, owed2 = transport.transfer_ex(val, "local", "cloud", chunks=chunks,
                                        missing_bytes=0)
    assert owed2 == 0 and transport.metadata_only_ships == 1
    assert out2["f"].device.type == "meta"


def test_cost_model_uses_observed_bandwidth():
    tiers = default_tiers(cloud_device="cpu")
    cm = CostModel(tiers)
    static = cm.transfer_time(1e6, "local", "cloud")
    cm.observe_bandwidth("local", "cloud", 1e6, 0.01)   # 100 MB/s observed
    observed = cm.transfer_time(1e6, "local", "cloud")
    assert observed != static
    assert abs(observed - (tiers["local"].link_latency_s + 0.01)) < 1e-6


@deadline(90)
def test_fabric_warm_reship_and_task_kwargs_dedup():
    val = {"w": torch.rand(1 << 18, dtype=torch.float64)}     # 2 MiB
    with Fabric(workers=1) as f:
        t1 = f.ship(val)
        t2 = f.ship(val)
        np.testing.assert_array_equal(t2.value["w"], val["w"].numpy())
        assert t1.bytes_sent > val["w"].nbytes
        assert t2.bytes_sent < 4096          # warm re-ship: metadata only
        k1 = f.broker.submit(step="echo", kwargs={"p": val["w"]})
        k1.result(30)
        assert k1.bytes_sent < 4096          # chunks crossed in the ships


@deadline(90)
def test_fabric_dedup_off_ships_everything():
    val = {"w": np.random.rand(1 << 16)}     # 512 KiB
    with Fabric(workers=1, dedup=False) as f:
        f.ship(val)
        t2 = f.ship(val)
        assert t2.bytes_sent > val["w"].nbytes
        assert t2.bytes_received > val["w"].nbytes


@deadline(90)
def test_fabric_feeds_per_direction_bandwidth():
    tiers, cm, mdss = cpu_tiers()
    with Fabric(workers=1, dedup=False) as fabric:
        attach(tiers, fabric, mdss=mdss, cost_model=cm)
        mdss.put("big", torch.rand(1 << 20, dtype=torch.float64),
                 tier="local")                                    # 8 MiB
        mdss.ensure(["big"], "cloud")
    assert cm.measured_bw.get(("local", "cloud"), 0) > 0
    assert cm.measured_bw.get(("cloud", "local"), 0) > 0


# --------------------------------------------------- workflow through fabric
@deadline(60)
def test_workflow_offload_executes_in_worker(fabric):
    tiers, cm, mdss = cpu_tiers()
    attach(tiers, fabric, mdss=mdss, cost_model=cm)
    mgr = MigrationManager(tiers, mdss, cm)
    wf = Workflow("fab")
    wf.var("x")
    wf.step("grow", None, inputs=("x",), outputs=("y",), remotable=True,
            device_step=False, remote_impl="add_one")
    wf.step("sq", lambda y: {"z": y * y}, inputs=("y",), outputs=("z",))
    ex = EmeraldExecutor(partition(wf), mgr)
    out = ex.run({"x": np.float64(4.0)})
    assert float(out["z"]) == 25.0
    off = [e for e in ex.events if e.kind == "offload"][0]
    assert off.info["remote"] is True
    assert off.info["worker_pid"] not in (0, os.getpid())
    assert off.info["bytes_in"] > 0 and off.info["bytes_out"] > 0


@deadline(90)
def test_workflow_survives_worker_crash(fabric, tmp_path):
    tiers, cm, mdss = cpu_tiers()
    attach(tiers, fabric, mdss=mdss, cost_model=cm)
    mgr = MigrationManager(tiers, mdss, cm)
    wf = Workflow("crashy")
    wf.var("x")
    wf.var("counter_file")
    wf.step("s", None, inputs=("counter_file", "x"), outputs=("y",),
            remotable=True, device_step=False, remote_impl="crash_n_times")
    before = fabric.broker.tasks_requeued
    ex = EmeraldExecutor(partition(wf), mgr)
    out = ex.run({"x": np.float64(1.0),
                  "counter_file": str(tmp_path / "wfcrash")})
    assert float(out["y"]) == 2.0
    assert fabric.broker.tasks_requeued == before + 1
    off = [e for e in ex.events if e.kind == "offload"][0]
    assert off.info["remote"] is True and off.info["attempt"] == 0


def _event_kinds(ex, step):
    return [(e.kind, e.tier) for e in ex.events
            if e.step == step and e.kind in ("suspend", "retry", "offload",
                                             "speculate", "resume")]


@deadline(90)
def test_worker_killed_mid_task_falls_back_to_local():
    """A worker is hard-killed while running the step; with no requeue
    budget the executor's tier fallback finishes the workflow in-process
    with the registry's own function."""
    tiers, cm, mdss = cpu_tiers()
    with Fabric(workers=1, max_attempts=1, replace_dead=False) as fabric:
        tiers["cloud"].worker_pool = fabric
        mgr = MigrationManager(tiers, mdss, cm)
        wf = Workflow("killed")
        wf.var("x")
        wf.step("s", None, inputs=("x",), outputs=("y",), remotable=True,
                device_step=False, retries=1, remote_impl="crash_in_worker")
        ex = EmeraldExecutor(partition(wf), mgr)
        out = ex.run({"x": np.float64(7.0)})
        assert float(out["y"]) == 70.0
        assert fabric.broker.workers_lost >= 1
    assert _event_kinds(ex, "s") == [
        ("suspend", ""), ("retry", "cloud"), ("offload", "local"),
        ("resume", "")]


def _at_run(obs, fabric=None, iters=2):
    """Adjoint tomography at test size, steps 2-4 on the cloud tier: the
    first iteration hands in model and obs, later ones read MDSS."""
    cfg = tat.ATConfig(nx=32, ny=12, nz=12, nt=80)
    tiers, cm, mdss = cpu_tiers()
    transport = attach(tiers, fabric, mdss=mdss, cost_model=cm) \
        if fabric is not None else None
    mgr = MigrationManager(tiers, mdss, cm)
    ex = EmeraldExecutor(partition(tat.build_workflow(cfg)), mgr,
                         policy="annotate")
    init = {"model": tat.starting_model(cfg, "cpu"), "obs": obs}
    chis = []
    for _ in range(iters):
        res = ex.run(init)
        init = {}
        chis.append(res["chi"])
    return chis, res["model"], mdss, transport, ex


@deadline(120)
def test_at_with_fabric_behind_the_cloud_equals_in_process(fabric):
    """The device steps stay in-process; only MDSS staging crosses worker
    processes. Results are bitwise those of the run without the fabric,
    and MDSS accounts the same bytes."""
    obs = tat.make_observations(tat.ATConfig(nx=32, ny=12, nz=12, nt=80),
                                "cpu")
    chis, model, mdss, _, _ = _at_run(obs)
    fchis, fmodel, fmdss, transport, ex = _at_run(obs, fabric)
    assert all(torch.equal(a, b) for a, b in zip(chis, fchis))
    assert torch.equal(model, fmodel)
    assert dict(mdss.bytes_moved) == dict(fmdss.bytes_moved)
    assert transport.total_bytes_shipped() > 0
    offl = [e for e in ex.events if e.kind == "offload"]
    assert len(offl) == 2 * 3 and not any(e.info["remote"] for e in offl)


# --------------------------------------------------------------- autoscaler
@deadline(120)
def test_autoscaler_scales_up_down_and_reuses_warm_workers():
    cfg = AutoscalerConfig(min_workers=1, max_workers=3, queue_high=1.0,
                           idle_scale_down_s=0.05, warm_ttl_s=60.0)
    with Fabric(workers=1, autoscaler=cfg) as f:
        a = f.autoscaler
        assert f.broker.num_workers() == 1
        tasks = [f.broker.submit(step="sleep", kwargs={"seconds": 0.2})
                 for _ in range(6)]
        act = a.tick()
        assert act["added"] >= 1 and f.broker.num_workers() > 1
        for t in tasks:
            t.result(30)
        pids_at_peak = set(f.broker.worker_pids())
        end = time.monotonic() + 10
        while f.broker.num_workers() > 1 and time.monotonic() < end:
            time.sleep(0.06)
            a.tick()
        assert f.broker.num_workers() == 1
        assert f.broker.num_workers(include_warm=True) > 1
        hits = f.broker.warm_hits
        f.broker.add_worker()
        assert f.broker.warm_hits == hits + 1
        assert set(f.broker.worker_pids()) <= pids_at_peak
        assert f.broker.reap_warm(0.0) >= 0
        assert f.broker.num_workers(include_warm=True) == \
            f.broker.num_workers()


@deadline(60)
def test_autoscaler_desired_workers_uses_task_duration():
    with Fabric(workers=1) as f:
        cfg = AutoscalerConfig(min_workers=1, max_workers=8, queue_high=100.0,
                               target_drain_s=0.5)
        a = Autoscaler(f.broker, cfg)
        f.broker.submit(step="sleep", kwargs={"seconds": 0.25}).result(30)
        assert f.broker.avg_task_seconds() is not None
        for _ in range(8):
            f.broker.submit(step="sleep", kwargs={"seconds": 0.25})
        assert a.desired_workers() >= 3


# ------------------------------------------------------- runtime + fabric
def _emerald():
    tiers, cm, mdss = cpu_tiers()
    return MigrationManager(tiers, mdss, cm)


@deadline(60)
def test_broker_priority_classes():
    order = []
    with Fabric(workers=1) as fabric:
        blocker = fabric.broker.submit(step="spin",
                                       kwargs={"seconds": 0.3})
        time.sleep(0.05)           # ensure the worker is busy on blocker
        low = fabric.broker.submit(step="spin", kwargs={"seconds": 0.01})
        high = fabric.broker.submit(step="spin", kwargs={"seconds": 0.01},
                                    priority=1)
        low.add_done_callback(lambda t: order.append("low"))
        high.add_done_callback(lambda t: order.append("high"))
        blocker.result(30)
        low.result(30)
        high.result(30)
    assert order == ["high", "low"]


def test_autoscaler_sees_runtime_backlog():
    class StubBroker:
        def queue_depth(self):
            return 0

        def num_workers(self, include_warm=False):
            return 1

        def avg_task_seconds(self):
            return None

    cfg = AutoscalerConfig(min_workers=1, max_workers=4, queue_high=2.0)
    sc = Autoscaler(StubBroker(), cfg)
    assert sc.desired_workers() == 1
    sc.backlog_fn = lambda: 10
    assert sc.desired_workers() == 4


@deadline(90)
def test_runtime_attach_fabric_wires_autoscaler_and_telemetry():
    """``attach_fabric`` backs the cloud tier, swaps in the RPCTransport,
    points the autoscaler at the runtime's backlog and the store's churn,
    and registers the fabric's counters; a registry step submitted
    through the runtime then runs in a worker."""
    cfg = AutoscalerConfig(min_workers=1, max_workers=2)
    with EmeraldRuntime(_emerald(), max_workers=2) as rt, \
            Fabric(workers=1, autoscaler=cfg) as fabric:
        transport = rt.attach_fabric(fabric)
        assert rt.manager.tiers["cloud"].worker_pool is fabric
        assert rt.mdss.transport is transport
        assert fabric.autoscaler.backlog_fn() == rt.offload_backlog()
        assert fabric.autoscaler.churn_fn() == rt.mdss.eviction_bytes
        assert fabric.broker.tracer is rt.tracer
        wf = Workflow("rt-fab")
        wf.var("x")
        wf.step("grow", None, inputs=("x",), outputs=("y",), remotable=True,
                device_step=False, remote_impl="add_one")
        h = rt.submit(wf, {"x": np.float64(1.0)})
        assert float(h.result(30)["y"]) == 2.0
        (off,) = [e for e in h.events if e.kind == "offload"]
        assert off.info["remote"] is True
        snap = rt.metrics.snapshot()
        assert any(k.startswith("broker.") for k in snap)
        assert any(k.startswith("pool.") for k in snap)
        assert rt.introspect()["workers"]["pids"] == \
            fabric.broker.worker_pids()


# ---------------------------------------------- held against repro.cloud
# The same numpy inputs through the port's fabric and the JAX package's.
# A frame's header pickles the skeleton, whose array placeholders are
# instances of each wire module's own ``_Buf``; so the two frames differ
# in that class's module path and in nothing else. ``_as_frame_of``
# renames the class in a frame's header, which lets each side decode the
# other's frames and lets the frames be compared byte for byte.
import hashlib  # noqa: E402
import io  # noqa: E402
import pickle  # noqa: E402

import repro.cloud as rcloud  # noqa: E402
import repro.cloud.autoscaler as rauto  # noqa: E402
import repro.cloud.tasklib as rtasklib  # noqa: E402
import repro.cloud.wire as rwire  # noqa: E402
import repro.core as rcore  # noqa: E402
import repro_torch.cloud.autoscaler as pauto  # noqa: E402
import repro_torch.cloud.tasklib as ptasklib  # noqa: E402
import repro_torch.cloud.wire as pwire  # noqa: E402


class _Renaming(pickle.Unpickler):
    def __init__(self, data, buf_cls):
        super().__init__(io.BytesIO(data))
        self.buf_cls = buf_cls

    def find_class(self, module, name):
        if name == "_Buf" and module in (rwire.__name__, pwire.__name__):
            return self.buf_cls
        return super().find_class(module, name)


def _as_frame_of(frame, src, dst):
    """``frame``, made by wire module ``src``, with its header's
    placeholder class renamed to ``dst``'s."""
    magic, hlen = src._HEAD.unpack_from(frame)
    start = src._HEAD.size
    skel = _Renaming(frame[start:start + hlen], dst._Buf).load()
    header = pickle.dumps(skel, protocol=pickle.HIGHEST_PROTOCOL)
    return dst._HEAD.pack(magic, len(header)) + header + frame[start + hlen:]


def _wire_values():
    rng = np.random.default_rng(7)
    return {
        "nested": nested_value(),
        "dtypes": {k: rng.standard_normal((5, 3)).astype(k)
                   for k in ("float16", "float32", "float64")}
        | {"i8": np.arange(-4, 4, dtype=np.int8),
           "u64": np.arange(6, dtype=np.uint64).reshape(2, 3),
           "b": rng.standard_normal(7) > 0,
           "fortran": np.asfortranarray(rng.standard_normal((4, 6))),
           "strided": rng.standard_normal((6, 8))[::2, 1::3]},
        "multi_chunk": {"x": rng.standard_normal(3 * 1024 + 17),
                        "z": np.zeros(2048, np.float32)},   # equal chunks
        "empty": {"e": np.empty((0, 3), np.float32), "k": [], "n": None},
    }


WIRE_CASES = sorted(_wire_values())


@pytest.mark.parametrize("case", WIRE_CASES)
@pytest.mark.parametrize("dedup", [False, True])
def test_wire_frames_equal_the_reference(case, dedup):
    """Same frames as the JAX package's wire, byte for byte once the
    placeholder class is renamed, with and without a ChannelStore; the
    second send of a value is all digest references on both sides, and
    the stores account alike. Each side decodes the other's frames."""
    val = _wire_values()[case]
    ps, rs = (pwire.ChannelStore(), rwire.ChannelStore()) if dedup \
        else (None, None)
    for _ in range(2):
        pf = pwire.encode(val, ps, chunk_bytes=1024)
        rf = rwire.encode(val, rs, chunk_bytes=1024)
        assert _as_frame_of(pf, pwire, rwire) == rf
        assert _as_frame_of(rf, rwire, pwire) == pf
        # decoders hold a mirror of the sender's store
        pd, rd = (pwire.ChannelStore(), rwire.ChannelStore()) if dedup \
            else (None, None)
        if dedup:       # prime the mirrors with everything sent so far
            for (d, data) in ps.sent._chunks.items():
                pd.received.add(d, data)
                rd.received.add(d, data)
        assert_trees_equal(rwire.decode(_as_frame_of(pf, pwire, rwire), rd),
                           val if case != "dtypes" else
                           {k: np.ascontiguousarray(v) for k, v in val.items()})
        assert_trees_equal(pwire.decode(_as_frame_of(rf, rwire, pwire), pd),
                           rwire.decode(rf, rd))
    if dedup:
        assert ps.stats() == rs.stats()
        assert ps.saved_bytes > 0 or case == "empty"


@pytest.mark.parametrize("case", WIRE_CASES)
def test_plan_msg_accounts_like_the_reference(case):
    """``plan_msg`` plans the same chunk frames and the same dedup
    savings; ``nbytes`` and ``payload_bytes`` differ from the reference's
    only by the header's length, which differs by the module path."""
    val = _wire_values()[case]
    ps, rs = pwire.ChannelStore(), rwire.ChannelStore()
    for _ in range(2):
        p = pwire.plan_msg(val, ps, chunk_bytes=1024)
        r = rwire.plan_msg(val, rs, chunk_bytes=1024)
        hdiff = len(p.parts[1]) - len(r.parts[1])
        names_buf = b"_Buf" in bytes(r.parts[1])
        assert hdiff == (len(pwire.__name__) - len(rwire.__name__)
                         if names_buf else 0)
        assert p.nbytes - r.nbytes == hdiff
        assert p.payload_bytes - r.payload_bytes == hdiff
        assert p.saved_bytes == r.saved_bytes
        assert [bytes(x) for x in p.parts[2:]] == \
            [bytes(x) for x in r.parts[2:]]
    # the content digest hashes the skeleton's pickle, which names the
    # placeholder class: the reference's skeleton, renamed, gives the
    # port's digest
    pdig, pchunks = pwire.manifest_of(val)
    rdig, rchunks = rwire.manifest_of(val)
    assert pchunks == rchunks
    skel = pickle.dumps(rwire._strip(val, []), protocol=pickle.HIGHEST_PROTOCOL)
    h = hashlib.sha256(pickle.dumps(_Renaming(skel, pwire._Buf).load(),
                                    protocol=pickle.HIGHEST_PROTOCOL))
    for d, _ in rchunks:
        h.update(d)
    assert pdig == h.digest()[:pwire.DIGEST_BYTES] != rdig or \
        b"_Buf" not in skel


def test_zero_d_leaf_differs_from_the_reference_only_in_shape():
    """The port keeps a 0-d array 0-d; the reference's wire makes it 1-d.
    The bytes on the wire are the same."""
    val = {"s": np.array(2.5, np.float32)}
    pp, rp = pwire.plan_msg(val), rwire.plan_msg(val)
    assert [bytes(x) for x in pp.parts[2:]] == [bytes(x) for x in rp.parts[2:]]
    assert pwire.decode(pwire.encode(val))["s"].shape == ()
    assert rwire.decode(rwire.encode(val))["s"].shape == (1,)


class _ScriptedBroker:
    """The broker surface an autoscaler reads, driven by a script; records
    what the autoscaler asks of it."""

    def __init__(self):
        self.workers, self.queue, self.busy, self.task_s = 1, 0, 0, None
        self.calls = []

    def queue_depth(self):
        return self.queue

    def num_workers(self, include_warm=False):
        return self.workers

    def inflight(self):
        return self.busy

    def avg_task_seconds(self):
        return self.task_s

    def add_worker(self):
        self.workers += 1
        self.calls.append("add")
        return f"w{self.workers}"

    def retire_worker(self):
        self.workers -= 1
        self.calls.append("retire")
        return f"w{self.workers + 1}"

    def reap_warm(self, ttl_s):
        self.calls.append(("reap", ttl_s))
        return 0


# (now, queue, busy, avg task s, backlog, cumulative evicted bytes)
AUTOSCALE_SCRIPT = [
    (0.0, 0, 0, None, 0, 0), (0.5, 9, 1, None, 0, 0),
    (1.0, 3, 2, 0.4, 0, 0), (1.5, 1, 1, 0.4, 6, 0),
    (2.0, 0, 0, 0.4, 0, 5e7), (2.5, 0, 0, 0.4, 0, 5e7),
    (3.0, 0, 0, 0.4, 0, 5e7), (5.5, 0, 0, 0.4, 0, 5e7),
    (6.0, 0, 0, 0.4, 0, 7e7), (8.5, 0, 0, None, 0, 7e7),
    (9.0, 40, 3, 2.0, 0, 7e7), (11.0, 0, 0, 2.0, 0, 7e7),
    (13.5, 0, 0, 2.0, 0, 7e7),
]


@pytest.mark.parametrize("cfg", [
    {}, {"min_workers": 2, "max_workers": 6, "queue_high": 1.0},
    {"max_workers": 3, "target_drain_s": 0.2, "idle_scale_down_s": 0.4,
     "churn_high_bytes_per_s": 1e6}])
def test_autoscaler_decides_like_the_reference(cfg):
    """Both autoscalers, each over its own scripted broker, make the same
    decision at every tick: desired workers, the action summary, and the
    calls made on the broker."""
    runs = []
    for mod in (pauto, rauto):
        b = _ScriptedBroker()
        feed = {"backlog": 0, "evicted": 0}
        a = mod.Autoscaler(b, mod.AutoscalerConfig(**cfg),
                           backlog_fn=lambda: feed["backlog"],
                           churn_fn=lambda: feed["evicted"])
        trace = []
        for now, q, busy, task_s, backlog, evicted in AUTOSCALE_SCRIPT:
            b.queue, b.busy, b.task_s = q, busy, task_s
            feed.update(backlog=backlog, evicted=evicted)
            trace.append((a.desired_workers(), a.tick(now=now)))
        runs.append((trace, b.calls, a.scale_ups, a.scale_downs, a.ticks))
    assert runs[0] == runs[1]
    assert runs[0][2] > 0 and runs[0][3] > 0


TASK_KWARGS = {
    "echo": {"a": np.arange(3), "s": "x"},
    "add_one": {"x": np.float64(1.5)},
    "matmul": {"a": np.arange(6.0).reshape(2, 3),
               "b": np.arange(12.0).reshape(3, 4)},
    "sleep": {"seconds": 0.001},
    "spin": {"seconds": 0.001},
    "crash_in_worker": {"x": np.float64(3.0)},
}


@pytest.mark.parametrize("step", sorted(TASK_KWARGS))
def test_tasklib_step_gives_the_reference_result(step):
    assert sorted(ptasklib.STEP_REGISTRY) == sorted(rtasklib.STEP_REGISTRY)
    assert_trees_equal(ptasklib.resolve(step)(**TASK_KWARGS[step]),
                       rtasklib.resolve(step)(**TASK_KWARGS[step]))


@pytest.mark.parametrize("step", ["fail_n_times", "crash_n_times"])
def test_tasklib_fault_step_gives_the_reference_result(step, tmp_path):
    """Past its schedule of faults, a fault-injecting step returns what
    the reference's does (in-process, where the schedule is spent)."""
    n = "n_fails" if step == "fail_n_times" else "n_crashes"
    got = [m.resolve(step)(counter_file=str(tmp_path / m.__name__),
                           **{n: 0, "x": np.float64(4.0)})
           for m in (ptasklib, rtasklib)]
    assert_trees_equal(*got)


def _fault_run(cloud, core, tmp_path, kw):
    """Worker crash (requeued) and a remote failure through ``cloud``'s
    Fabric; then a worker killed mid-task behind ``core``'s executor with
    no requeue budget. Returns what each scenario observed."""
    tag = cloud.__name__
    out = {}
    with cloud.Fabric(workers=1) as f:
        t = f.broker.submit(step="crash_n_times", kwargs={
            "counter_file": str(tmp_path / f"{tag}.crash"), "n_crashes": 1,
            "x": np.float64(5.0)})
        y = t.result(60)
        t2 = f.broker.submit(step="fail_n_times", kwargs={
            "counter_file": str(tmp_path / f"{tag}.fail"), "n_fails": 99})
        with pytest.raises(cloud.RemoteStepError) as ei:
            t2.result(30)
        out["broker"] = (y, t.attempts, t2.attempts, f.broker.tasks_requeued,
                         f.broker.workers_lost, f.broker.tasks_done,
                         f.broker.num_workers(), str(ei.value).splitlines()[0])
    tiers = core.default_tiers(**kw)
    cm = core.CostModel(tiers)
    mdss = core.MDSS(tiers, cost_model=cm)
    with cloud.Fabric(workers=1, max_attempts=1, replace_dead=False) as f:
        tiers["cloud"].worker_pool = f
        wf = core.Workflow("killed")
        wf.var("x")
        flag = "device_step" if core is not rcore else "jax_step"
        wf.step("s", None, inputs=("x",), outputs=("y",), remotable=True,
                retries=1, remote_impl="crash_in_worker", **{flag: False})
        ex = core.EmeraldExecutor(partition(wf) if core is not rcore
                                  else rcore.partition(wf),
                                  core.MigrationManager(tiers, mdss, cm))
        res = ex.run({"x": np.float64(7.0)})
        out["executor"] = (
            float(res["y"]), f.broker.workers_lost,
            [(e.kind, e.tier, e.info.get("remote"), e.info.get("attempt"))
             for e in ex.events if e.step == "s" and e.kind in (
                 "suspend", "retry", "offload", "speculate", "resume")])
    return out


@deadline(150)
def test_retry_and_requeue_match_the_reference(tmp_path):
    """One requeue-on-crash, one remote failure, and one executor tier
    fallback after a killed worker: the port's Fabric and the reference's
    give the same results, counters, attempts and event sequence."""
    import repro_torch.cloud as pcloud
    import repro_torch.core as pcore
    ours = _fault_run(pcloud, pcore, tmp_path, {"cloud_device": "cpu"})
    ref = _fault_run(rcloud, rcore, tmp_path, {})
    assert ours["broker"][1:] == ref["broker"][1:]
    assert_trees_equal(ours["broker"][0], ref["broker"][0])
    assert ours["executor"] == ref["executor"]
    assert ours["broker"][3] == 1 and ours["executor"][0] == 70.0
