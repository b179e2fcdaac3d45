"""The port's analysis package against ``repro.analysis``.

  * the seeded defect corpus (``tests/defects/``, read-only): for every
    rule id the port reports the same set of rule ids as the reference,
    on the defective artifact and on its clean twin; ``verify`` cases are
    rebuilt as port Workflows (same vars, steps, fns and attributes),
    the other kinds feed the same data to both packages;
  * W004 with no ``registry`` argument falls back to the port's fabric
    step registry, as the reference's falls back to its own, both from
    ``verify`` and at admission;
  * ``submit(validate=...)`` admission semantics on the port's runtime,
    kinded dependency edges, duplicate-definition errors, and a
    fabric-backed run replayed clean by ``record_submissions``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from defects import CASES
import repro.analysis as ra
import repro.core as rcore
from repro.analysis.selfcheck import check_snippet as ref_check_snippet
from repro.core import partitioner as rpart
import repro_torch.core as tcore
from repro_torch.analysis import (ERROR, RULES, WorkflowRejected, explorer,
                                  sanitizer, verify)
from repro_torch.analysis.selfcheck import check_snippet
from repro_torch.core import partitioner as tpart
from repro_torch.core import runtime as truntime
from repro_torch.core import workflow as tw
from repro_torch.core.workflow import Workflow, WorkflowError


def emerald():
    tiers = tcore.default_tiers(cloud_device="cpu")
    cm = tcore.CostModel(tiers)
    mdss = tcore.MDSS(tiers, cost_model=cm)
    return tcore.MigrationManager(tiers, mdss, cm)


# ------------------------------------------------- the corpus, both sides
def _port_fn(fn):
    """The port's counterpart of a reference partitioner function."""
    if fn is not None and getattr(fn, "__module__", "") == rpart.__name__:
        return getattr(tpart, fn.__name__)
    return fn


def port_workflow(wf):
    """A port Workflow with the reference workflow's vars, steps, fns
    and attributes (``jax_step`` read as ``device_step``)."""
    out = Workflow(wf.name)
    for name, v in wf.variables.items():
        out.variables[name] = tw.Variable(**dataclasses.asdict(v))
    for name in wf.order:
        s = wf.steps[name]
        kw = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
        kw["device_step"] = kw.pop("jax_step")
        if s.fanout is not None:
            fo = s.fanout
            kw["fanout"] = tw.Fanout(fo.shards, fo.scatter,
                                     _port_fn(fo.partition_fn),
                                     _port_fn(fo.combine_fn))
        out.steps[name] = tw.Step(**kw)
    out.order = list(wf.order)
    return out


def _w021_port(fn_capture):
    def fn(x):
        return {"y": x * fn_capture}
    wf = Workflow("devcap")
    wf.var("x")
    wf.step("s", fn, inputs=("x",), outputs=("y",), remotable=True)
    return {"wf": wf, "provided": {"x"}}


# W021's artifact is a captured device array: a jax.Array for the
# reference, a tensor off the host for the port
PORT_W021 = (lambda: _w021_port(torch.ones(4, device="meta")),
             lambda: _w021_port(2.0))


def port_kwargs(kind, kwargs):
    kwargs = dict(kwargs)
    if kind == "verify":
        kwargs["wf"] = port_workflow(kwargs["wf"])
        if "tiers" in kwargs:
            kwargs["tiers"] = tcore.default_tiers(cloud_device="cpu")
    elif kind == "events":
        kwargs["events"] = [truntime.Event(**dataclasses.asdict(e))
                            for e in kwargs["events"]]
    return kwargs


def run_port(kind, kwargs):
    if kind == "verify":
        return verify(kwargs.pop("wf"), **kwargs)
    if kind == "events":
        return sanitizer.check(kwargs["events"],
                               completed_run=kwargs.get("completed_run", True))
    if kind == "store":
        return sanitizer.check_store(kwargs["installs"], kwargs["evictions"])
    if kind == "trace":
        return explorer.check_trace(kwargs)
    if kind == "source":
        return check_snippet(kwargs["text"])
    raise AssertionError(f"unknown case kind {kind}")


def run_ref(kind, kwargs):
    kwargs = dict(kwargs)
    if kind == "verify":
        return ra.verify(kwargs.pop("wf"), **kwargs)
    if kind == "events":
        return ra.sanitizer.check(
            kwargs["events"], completed_run=kwargs.get("completed_run", True))
    if kind == "store":
        return ra.sanitizer.check_store(kwargs["installs"],
                                        kwargs["evictions"])
    if kind == "trace":
        return ra.explorer.check_trace(kwargs)
    if kind == "source":
        return ref_check_snippet(kwargs["text"])
    raise AssertionError(f"unknown case kind {kind}")


@pytest.mark.parametrize("rule", sorted(CASES))
def test_defect_corpus_rule_ids_match_reference(rule):
    kind, make_defective, make_clean = CASES[rule]
    port_makers = PORT_W021 if rule == "W021" else (
        lambda: port_kwargs(kind, make_defective()),
        lambda: port_kwargs(kind, make_clean()))
    for make_ref, make_port, fires in ((make_defective, port_makers[0], True),
                                       (make_clean, port_makers[1], False)):
        want = {f.rule for f in run_ref(kind, make_ref())}
        got = {f.rule for f in run_port(kind, make_port())}
        assert got == want, (rule, "defective" if fires else "clean")
        assert (rule in got) == fires


def test_corpus_covers_every_port_rule():
    # L001/L002 are exercised by the drift canaries in
    # test_torch_selfcheck.py; every other rule has a seeded defect
    assert set(RULES) == set(ra.RULES)
    assert set(CASES) == {r for r in RULES if r not in ("L001", "L002")}
    for rid, info in RULES.items():
        ref = ra.RULES[rid]
        assert (info.severity, info.title) == (ref.severity, ref.title)


def test_findings_carry_metadata():
    kind, make_defective, _ = CASES["W001"]
    (f,) = [x for x in run_port(kind, port_kwargs(kind, make_defective()))
            if x.rule == "W001"]
    assert f.severity == ERROR
    assert f.steps and f.hint
    assert "W001" in str(f) and "->" in f.message  # witness path


# --------------------------------------- W004 without a registry argument
def _unregistered(pkg):
    wf = pkg.Workflow("unknownimpl")
    wf.var("x")
    wf.step("s", None, inputs=("x",), outputs=("y",),
            remote_impl="nope_not_registered", remotable=True)
    return wf


def test_unregistered_remote_impl_warns_w004_without_registry():
    """With no ``registry`` given, both verifiers fall back to their
    fabric's step registry; before the port did, it reported nothing."""
    want = sorted(f.rule for f in ra.verify(_unregistered(rcore),
                                            provided={"x"}))
    got = sorted(f.rule for f in verify(_unregistered(tcore),
                                        provided={"x"}))
    assert got == want and "W004" in got
    # a name the port's registry holds is clean, as in the reference
    wf = Workflow("registered")
    wf.var("x")
    wf.step("s", None, inputs=("x",), outputs=("y",),
            remote_impl="add_one", remotable=True)
    assert verify(wf, provided={"x"}) == []


def test_admission_attaches_w004_as_the_reference_does():
    findings = {}
    for name, pkg, make in (
            ("ref", rcore, lambda: rcore.EmeraldRuntime(
                max_workers=2, telemetry=False)),
            ("port", tcore, lambda: tcore.EmeraldRuntime(
                emerald(), max_workers=2, telemetry=False))):
        rt = make()
        try:
            # W004 is a warning: admitted, attached, never warned about
            h = rt.submit(_unregistered(pkg), {"x": np.float64(1.0)},
                          validate="warn")
            findings[name] = sorted(f.rule for f in h.findings)
            h.wait(30)
        finally:
            rt.close()
    assert findings["port"] == findings["ref"] and "W004" in findings["port"]


# ------------------------------------------------- submit(validate=...)
def _racy_wf():
    """Two blind writers of one URI — a W010 warning, no errors."""
    wf = Workflow("racy")
    wf.var("x")
    wf.step("w1", lambda x: {"r": x}, inputs=("x",), outputs=("r",),
            device_step=False)
    wf.step("w2", lambda x: {"r": x + 1}, inputs=("x",), outputs=("r",),
            device_step=False)
    wf.step("read", lambda r: {"out": r}, inputs=("r",), outputs=("out",),
            device_step=False)
    return wf


def _broken_wf():
    wf = Workflow("broken")
    wf.var("obs")
    wf.step("fit", lambda obs: {"chi": obs}, inputs=("obs",),
            outputs=("chi",), device_step=False)
    return wf  # submitted with no init_vars -> W002 unbound-input


def test_submit_validate_error_rejects_and_names_rules():
    rt = tcore.EmeraldRuntime(emerald(), max_workers=2, telemetry=False)
    try:
        with pytest.raises(WorkflowRejected) as ei:
            rt.submit(_broken_wf(), {})
        assert "W002" in str(ei.value)
        assert any(f.rule == "W002" for f in ei.value.findings)
        # the rejected run must not leak into the scheduler
        h = rt.submit(_broken_wf(), {"obs": np.float64(1.0)})
        assert float(h.result()["chi"]) == 1.0
    finally:
        rt.close()


def test_submit_validate_warn_admits_and_attaches_findings():
    rt = tcore.EmeraldRuntime(emerald(), max_workers=2, telemetry=False)
    try:
        with pytest.warns(UserWarning, match="W002"):
            h = rt.submit(_broken_wf(), {}, validate="warn")
        assert any(f.rule == "W002" for f in h.findings)
        with pytest.raises(Exception):
            h.result()  # it was genuinely broken — the lint was right
    finally:
        rt.close()


def test_submit_validate_off_skips_analysis():
    rt = tcore.EmeraldRuntime(emerald(), max_workers=2, telemetry=False)
    try:
        h = rt.submit(_broken_wf(), {}, validate="off")
        assert h.findings == []
        with pytest.raises(Exception):
            h.result()
    finally:
        rt.close()


def test_submit_warnings_do_not_block():
    rt = tcore.EmeraldRuntime(emerald(), max_workers=2, telemetry=False)
    try:
        h = rt.submit(_racy_wf(), {"x": np.float64(1.0)})
        assert h.result()["out"] is not None
        assert any(f.rule == "W010" for f in h.findings)
    finally:
        rt.close()


def test_submit_validate_rejects_unknown_mode():
    rt = tcore.EmeraldRuntime(emerald(), max_workers=2, telemetry=False)
    try:
        with pytest.raises(ValueError, match="validate"):
            rt.submit(_racy_wf(), {"x": np.float64(1.0)}, validate="maybe")
    finally:
        rt.close()


def test_resident_uris_count_as_provided():
    """Warm resubmission into a namespace whose inputs are already
    resident must not trip W002."""
    rt = tcore.EmeraldRuntime(emerald(), max_workers=2, telemetry=False)
    try:
        h1 = rt.submit(_broken_wf(), {"obs": np.float64(2.0)},
                       namespace="warm")
        assert float(h1.result()["chi"]) == 2.0
        h2 = rt.submit(_broken_wf(), {}, namespace="warm")
        assert float(h2.result()["chi"]) == 2.0
    finally:
        rt.close()


# ------------------------------------------------------- kinded edges
def test_dependencies_kinds():
    wf = Workflow("kinds")
    wf.var("x")
    wf.step("w1", lambda **kw: {}, inputs=("x",), outputs=("v",))
    wf.step("read", lambda **kw: {}, inputs=("v",), outputs=("out",))
    wf.step("w2", lambda **kw: {}, inputs=("x",), outputs=("v",))
    kd = wf.dependencies(kinds=True)
    assert kd["read"]["w1"] == frozenset({"RAW"})
    assert "WW" in kd["w2"]["w1"]
    assert "WAR" in kd["w2"]["read"]
    # legacy shape is the kinded graph with kinds erased
    plain = wf.dependencies()
    assert plain == {n: set(e) for n, e in kd.items()}


def test_duplicate_step_name_names_both_sites():
    wf = Workflow("dup")
    wf.step("s", lambda **kw: {}, outputs=("a",))
    with pytest.raises(WorkflowError) as ei:
        wf.step("s", lambda **kw: {}, outputs=("b",))
    msg = str(ei.value)
    assert "redefined at" in msg and "first defined at" in msg
    assert msg.count("test_torch_analysis.py") == 2


def test_duplicate_variable_names_both_sites():
    wf = Workflow("dupvar")
    wf.var("x")
    with pytest.raises(WorkflowError, match="first declared at"):
        wf.var("x")


def test_duplicate_output_uri_rejected():
    wf = Workflow("dupout")
    with pytest.raises(WorkflowError, match="more than once"):
        wf.step("s", lambda **kw: {}, outputs=("a", "a"))


# ------------------------------------------------------ real-run replay
def test_fabric_backed_run_replays_clean_through_sanitizer():
    """Two registry steps run in worker processes, a host step after
    them in-process: the run's event log and the store's replica log
    replay clean, through ``check_runtime`` and ``record_submissions``."""
    from repro_torch.cloud import Fabric, attach
    tiers = tcore.default_tiers(cloud_device="cpu")
    cm = tcore.CostModel(tiers)
    mdss = tcore.MDSS(tiers, cost_model=cm)
    with Fabric(workers=2) as fabric:
        attach(tiers, fabric, mdss=mdss, cost_model=cm)
        mgr = tcore.MigrationManager(tiers, mdss, cm)
        rt = tcore.EmeraldRuntime(mgr, max_workers=4, telemetry=False)
        try:
            wf = Workflow("clean-run")
            wf.var("x")
            wf.step("a", None, inputs=("x",), outputs=("pid",),
                    remotable=True, device_step=False, remote_impl="pid")
            wf.step("b", None, inputs=("x",), outputs=("y",),
                    remotable=True, device_step=False, remote_impl="add_one")
            wf.step("c", lambda pid, y: {"out": y * 2}, inputs=("pid", "y"),
                    outputs=("out",), device_step=False)
            with sanitizer.record_submissions() as rec:
                h = rt.submit(wf, {"x": np.float64(3.0)})
                assert float(h.result()["out"]) == 8.0
            offloads = [e for e in h.events if e.kind == "offload"]
            assert len(offloads) == 2
            assert all(e.info["remote"] for e in offloads)
            assert sanitizer.check(h.events, completed_run=True) == []
            assert sanitizer.check_store(rt.mdss) == []
            assert sanitizer.check_runtime(rt, [h]) == []
        finally:
            rt.close()
    assert rec.findings == [] and rec.skipped == 0
    assert [r.state for r in rec.runs] == ["done"]
    assert rec.events == rec.distinct_events == len(h.events)
    assert rec.stores == [rt.mdss]
    logged, total = rec.install_log()
    assert 0 < logged == total


def test_record_submissions_replays_settled_runs_and_catches_hazards():
    """The recorder keeps a settled run's state and a copy of its events,
    skips a run still going at exit, and reports a planted duplicate
    completion (H101) in a recorded log."""
    import threading
    gate = threading.Event()
    submit = tcore.EmeraldRuntime.submit
    rt = tcore.EmeraldRuntime(emerald(), max_workers=2, telemetry=False)
    try:
        slow = Workflow("slow")
        slow.var("x")
        slow.step("wait", lambda x: {"y": x if gate.wait(30) else x},
                  inputs=("x",), outputs=("y",), device_step=False)
        with sanitizer.record_submissions() as rec:
            h = rt.submit(_racy_wf(), {"x": np.float64(1.0)})
            h.result()
            h.events.append(truntime.Event("step_done", "read", "local",
                                           h.events[-1].t + 1.0))
            running = rt.submit(slow, {"x": np.float64(1.0)})
        gate.set()
        running.result(30)
    finally:
        rt.close()
    assert tcore.EmeraldRuntime.submit is submit       # unwrapped on exit
    assert rec.skipped == 1 and [r.state for r in rec.runs] == ["done"]
    assert "W010" in rec.runs[0].admission_rules
    assert {f.rule for f in rec.findings} == {"H101"}


def test_dispatch_events_emitted_per_step():
    rt = tcore.EmeraldRuntime(emerald(), max_workers=2, telemetry=False)
    try:
        h = rt.submit(_racy_wf(), {"x": np.float64(1.0)})
        h.result()
        dispatched = [e.step for e in h.events if e.kind == "dispatch"]
        assert sorted(dispatched) == ["read", "w1", "w2"]
        lanes = {e.info.get("lane") for e in h.events
                 if e.kind == "dispatch"}
        assert lanes <= {"local", "offload"}
    finally:
        rt.close()


def test_record_submissions_counts_a_shared_log_per_run():
    """An executor's runs append to one log: each run replays all of it
    (H103 pairs by count), and the copy and distinct count are shared."""
    mgr = emerald()
    ex = tcore.EmeraldExecutor(tcore.partition(_racy_wf()), mgr)
    with sanitizer.record_submissions() as rec:
        for _ in range(2):
            ex.run({"x": np.float64(1.0)})
    assert rec.findings == [] and len(rec.runs) == 2
    assert rec.runs[0].events is rec.runs[1].events
    assert rec.distinct_events == len(ex.events)
    assert rec.events == 2 * len(ex.events)
