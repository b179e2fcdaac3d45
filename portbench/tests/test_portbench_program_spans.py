"""The readers of the program's MDSS and batching spans: on a synthetic
run, each value, FrontDoor's cut at the traced stretch, and None where
the run holds no such span (as a program without them gives); then on
each cell's driver run at a tiny size on the CPU."""
import types

import pytest

from portbench.lib import harness
from portbench.tests.test_portbench_cells import run_driver

TRAIN = ["mdss.to_host_s.train", "mdss.sha256_s.train", "mdss.hashed_gb.train"]
FRONTDOOR = ["batching.wait_ms.frontdoor", "batching.service_ms.frontdoor"]


def reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               "t_spans_" + name.replace(".", "_"))


def run_of(spans, window=(10.0, 20.0), units=2, stretch_t0=None):
    cell = {"entry": {"chips": 1}, "spec": {"traffic": {}}, "config": {},
            "end_to_end": [], "per_layer": [], "readers": {}}
    r = harness.Run(types.SimpleNamespace(seed=1, seconds=10, trace=1), cell,
                    device="cpu")
    r.t_window = window
    r.units = [{"tokens": 1}] * units
    r.program_spans = lambda: spans
    if stretch_t0 is not None:
        r._stretch = types.SimpleNamespace(t0=stretch_t0)
    return r


def span(label, t0, t1, **attrs):
    return (label, t0, t1, dict(attrs, name=label.split(":")[0]))


def test_train_readers_sum_per_window_step():
    spans = [
        span("install:train_step", 11.0, 15.0, step="train_step"),
        span("mdss.to_host", 11.0, 12.0, bytes=6),
        span("mdss.sha256", 12.0, 14.5, bytes=4_000_000_000),
        span("mdss.to_host", 16.0, 17.0, bytes=6),
        span("mdss.sha256", 17.0, 18.5, bytes=5_000_000_000),
        # set-up's hashing, before the window opens, is left out
        span("mdss.to_host", 5.0, 9.0, bytes=6),
        span("mdss.sha256", 5.0, 9.0, bytes=9_000_000_000),
    ]
    r = run_of(spans)
    assert reader("mdss.to_host_s.train").read(r) == pytest.approx(1.0)
    assert reader("mdss.sha256_s.train").read(r) == pytest.approx(2.0)
    assert reader("mdss.hashed_gb.train").read(r) == pytest.approx(4.5)


def _requests(tag, n, t_start, gap, wait, service):
    out = []
    for i in range(n):
        t0 = t_start + i * gap
        trace = f"{tag}{i}"
        out.append(span("frontdoor.request", t0, t0 + wait + service,
                        trace=trace))
        out.append(span("frontdoor.wait", t0, t0 + wait, trace=trace))
    return out


def test_frontdoor_readers_cut_at_the_stretch():
    # 20 requests before the stretch opens at 14 s: waits 1..20 ms,
    # service 100 ms; those after it piled up behind the profiler
    spans = []
    for i in range(20):
        spans += _requests(f"early{i}.", 1, 10.0 + 0.1 * i, 0,
                           (i + 1) * 1e-3, 0.1)
    spans += _requests("late", 30, 14.5, 0.01, 2.0, 3.0)
    spans += _requests("warm", 5, 9.0, 0.01, 5.0, 5.0)   # the warm-up's
    r = run_of(spans, stretch_t0=14.0)
    assert reader("batching.wait_ms.frontdoor").read(r) == pytest.approx(19.0)
    assert reader("batching.service_ms.frontdoor").read(r) == \
        pytest.approx(100.0)
    # without a stretch, every request of the window counts
    r = run_of(spans)
    assert reader("batching.wait_ms.frontdoor").read(r) == \
        pytest.approx(2000.0)


@pytest.mark.parametrize("name", TRAIN + FRONTDOOR)
def test_none_without_the_programs_spans(name):
    spans = [span("install:train_step", 11.0, 15.0, step="train_step"),
             span("exec:decode", 11.0, 12.0, step="decode")]
    assert reader(name).read(run_of(spans, stretch_t0=15.0)) is None
    assert reader(name).read(run_of([], stretch_t0=15.0)) is None


def test_train_cell_reads_its_hashing():
    r = run_driver("train")
    got = {n: reader(n).read(r) for n in TRAIN}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert got["mdss.sha256_s.train"] > 0 and got["mdss.hashed_gb.train"] > 0


def test_frontdoor_cell_reads_its_requests():
    r = run_driver("frontdoor")
    got = {n: reader(n).read(r) for n in FRONTDOOR}
    assert all(v is not None and v > 0 for v in got.values()), got
