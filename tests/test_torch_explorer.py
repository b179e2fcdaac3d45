"""The port's schedule-space explorer against ``repro.analysis.explorer``.

  * for every model in ``MODELS``, clean and with each bug flag its
    scenario plants, ``explore`` and ``sample(seed=...)`` give the
    reference's results: schedules, decisions, dedup and POR counts,
    coverage, the hazardous schedules and their findings;
  * a minimised reproducer saved by either package is byte-identical and
    replays on the other;
  * the reference's own explorer cases on the port: determinism, strict
    replay, fault injection, the resume check, the runtime's
    ``dispatch_hook`` seam, the broker's lost shutdown wakeup, and the
    four FrontDoor model cases.
"""
import numpy as np
import pytest

import repro.analysis.explorer as rex
import repro_torch.core as tcore
from repro_torch.analysis import explorer, sanitizer
from repro_torch.analysis.explorer import (build_model, check_resume, explore,
                                           load_reproducer, minimize,
                                           model_diamond, replay,
                                           replay_reproducer, run_benign,
                                           sample, save_reproducer)
from repro_torch.cloud.broker import Broker
from repro_torch.core import EmeraldRuntime, Workflow


def emerald():
    tiers = tcore.default_tiers(cloud_device="cpu")
    cm = tcore.CostModel(tiers)
    return tcore.MigrationManager(tiers, tcore.MDSS(tiers, cost_model=cm), cm)


def summary(res):
    """Everything an explore/sample result says, comparable across the
    two packages (findings by their text)."""
    return (res.schedules, res.decisions, res.deduped, res.por_pruned,
            res.truncated, res.hazard_count, sorted(res.coverage),
            [(list(s), [str(f) for f in fs]) for s, fs in res.hazards])


# ------------------------------------------- parity with the reference
# (model, bugs, the rule the planted bug must raise, explore kwargs):
# every model clean and with each bug flag its scenario plants, at the
# budgets the reference's tests use; a clean model raises nothing
PARITY = [
    ("diamond", (), None, {}),
    ("diamond", ("duplicate_done",), "H101", {"max_schedules": 500,
                                              "max_hazards": 1}),
    ("two_tenant", (), None, {"max_schedules": 300}),
    ("two_tenant", ("unfair",), "H122", {"max_schedules": 300}),
    ("memo_pair", (), None, {"max_schedules": 4000}),
    ("memo_pair", ("memo_no_guard",), "H121", {"max_schedules": 4000,
                                               "max_hazards": 1}),
    ("budget", (), None, {"max_schedules": 4000}),
    ("budget", ("no_evict",), "H123", {"max_schedules": 4000,
                                       "max_hazards": 1}),
    ("resubmit", (), None, {"max_schedules": 4000}),
    ("resubmit", ("stale_install",), "H120", {"max_schedules": 4000,
                                              "max_hazards": 1}),
    ("ckpt_chain", (), None, {"max_schedules": 4000, "resume_check": True}),
    ("ckpt_chain", ("ckpt_lost_step",), "H124", {"max_schedules": 4000,
                                                 "max_hazards": 1,
                                                 "resume_check": True}),
    ("frontdoor", (), None, {}),
    ("frontdoor", ("parked_starved",), "H125", {"max_hazards": 1}),
    ("frontdoor", ("preempt_lost_step",), "H126", {"max_hazards": 1}),
]


def _id(case):
    return case[0] + ("+" + "+".join(case[1]) if case[1] else "")


def test_models_and_bugs_match_reference():
    assert explorer.BUGS == rex.BUGS
    assert list(explorer.MODELS) == list(rex.MODELS)
    assert {c[0] for c in PARITY} == set(explorer.MODELS)
    assert {b for c in PARITY for b in c[1]} == set(explorer.BUGS)


@pytest.mark.parametrize("name,bugs,rule,kw", PARITY,
                         ids=[_id(c) for c in PARITY])
def test_explore_and_sample_match_reference(name, bugs, rule, kw):
    got = explore(build_model(name, bugs=bugs), **kw)
    want = rex.explore(rex.build_model(name, bugs=bugs), **kw)
    assert summary(got) == summary(want)
    if rule is None:
        assert got.hazard_count == 0, got.hazard_rules()
    else:
        assert rule in got.hazard_rules(), got.hazard_rules()
    resume = kw.get("resume_check", False)
    got = sample(build_model(name, bugs=bugs), schedules=40, seed=7,
                 resume_check=resume)
    want = rex.sample(rex.build_model(name, bugs=bugs), schedules=40, seed=7,
                      resume_check=resume)
    assert summary(got) == summary(want)


@pytest.mark.parametrize("name,bug", [("diamond", "duplicate_done"),
                                      ("frontdoor", "parked_starved")])
def test_reproducers_are_byte_identical_and_replay_across(tmp_path, name,
                                                          bug):
    paths = {}
    for pkg, ex in (("port", explorer), ("ref", rex)):
        model = ex.build_model(name, bugs=[bug])
        res = ex.explore(model, max_schedules=500, max_hazards=1)
        sched, findings = res.hazards[0]
        small = ex.minimize(model, sched)
        paths[pkg] = tmp_path / f"{pkg}.json"
        ex.save_reproducer(str(paths[pkg]), model, small, findings)
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    # each package replays the other's file to the same verdict
    for ex, other in ((explorer, "ref"), (rex, "port")):
        doc = ex.load_reproducer(str(paths[other]))
        found, ok = ex.replay_reproducer(doc)
        assert ok and set(doc["hazards"]) <= {f.rule for f in found}
    got, _ = explorer.replay_reproducer(load_reproducer(str(paths["ref"])))
    want, _ = rex.replay_reproducer(rex.load_reproducer(str(paths["port"])))
    assert [str(f) for f in got] == [str(f) for f in want]


# ------------------------------------------------------------ exhaustive
def test_diamond_exhausts_clean():
    res = explore(model_diamond())
    assert res.exhaustive
    assert res.hazard_count == 0 and res.hazards == []
    # every complete interleaving reaches a distinct recorded terminal
    assert res.schedules == len(res.coverage)
    assert res.schedules > 1000          # the space is genuinely explored
    assert res.por_pruned > 0            # POR found commuting completions
    assert res.deduped > 0               # dedup cut revisited states


def test_explore_is_deterministic():
    a = explore(model_diamond())
    b = explore(model_diamond())
    assert summary(a) == summary(b)


def test_sample_is_seed_deterministic():
    m = build_model("two_tenant", bugs=("unfair",))
    a = sample(m, schedules=40, seed=7)
    b = sample(m, schedules=40, seed=7)
    assert summary(a) == summary(b)


def test_unfair_scheduler_starves_within_sampled_budget():
    res = sample(build_model("two_tenant", bugs=("unfair",)),
                 schedules=120, seed=0)
    assert "H122" in res.hazard_rules()
    clean = sample(build_model("two_tenant"), schedules=120, seed=0)
    assert clean.hazard_count == 0, clean.hazard_rules()


# ------------------------------------- planted race: find/minimize/replay
def test_duplicate_done_found_minimized_and_replayable(tmp_path):
    model = model_diamond(bugs=("duplicate_done",))
    res = explore(model, max_schedules=500, max_hazards=1)
    assert res.hazard_count >= 1          # found within K=500 schedules
    schedule, findings = res.hazards[0]
    assert "H101" in {f.rule for f in findings}

    small = minimize(model, schedule)
    assert len(small) <= len(schedule)
    assert any(d.startswith("ghost:") for d in small)
    # 1-minimality: dropping any single decision loses the hazard
    for i in range(len(small)):
        probe = small[:i] + small[i + 1:]
        sim = replay(model, probe, strict=False)
        run_benign(sim)
        rules = {f.rule for f in explorer.check_trace(sim.trace())}
        assert "H101" not in rules, f"decision {small[i]} was removable"

    path = tmp_path / "repro.json"
    save_reproducer(str(path), model, small, findings)
    first = path.read_bytes()
    save_reproducer(str(path), model, small, findings)
    assert path.read_bytes() == first     # byte-identical serialization

    doc = load_reproducer(str(path))
    assert doc["emcheck_version"] == explorer.EMCHECK_VERSION
    assert doc["model"] == {"name": "diamond", "params": {},
                            "bugs": ["duplicate_done"]}
    got, ok = replay_reproducer(doc)      # model rebuilt from registry
    assert ok and "H101" in {f.rule for f in got}
    got2, ok2 = replay_reproducer(doc)
    assert ok2 and [str(f) for f in got2] == [str(f) for f in got]


def test_replay_strict_rejects_infeasible_decision():
    with pytest.raises(ValueError, match="not enabled"):
        replay(model_diamond(), ["complete:A:src"])


def test_fault_injection_stays_hazard_free():
    # crashes burn retries and may fail runs, but a correct model must
    # never turn a fault into a hazard verdict
    m = model_diamond()
    m.max_crashes = 2
    res = sample(m, schedules=80, seed=3)
    assert res.hazard_count == 0, res.hazard_rules()
    ref = rex.model_diamond()
    ref.max_crashes = 2
    assert summary(res) == summary(rex.sample(ref, schedules=80, seed=3))


def test_resume_check_clean_on_correct_checkpointing():
    m = build_model("ckpt_chain")
    sim = explorer.Simulation(m)
    run_benign(sim)
    assert check_resume(m, sim.schedule) == []


# --------------------------------------------------- runtime dispatch seam
def test_dispatch_hook_drives_real_runtime():
    seen = []

    def hook(lane, run_ids):
        seen.append((lane, tuple(run_ids)))
        return run_ids[-1]                # force last-submitted-first

    rt = EmeraldRuntime(emerald(), max_workers=2, telemetry=False,
                        dispatch_hook=hook)
    try:
        with sanitizer.record_submissions() as rec:
            handles = []
            for i in range(3):
                wf = Workflow(f"hooked{i}")
                wf.var("x")
                wf.step("a", lambda x: {"u": x * 2}, inputs=("x",),
                        outputs=("u",), device_step=False)
                wf.step("b", lambda u: {"out": u + 1}, inputs=("u",),
                        outputs=("out",), device_step=False)
                handles.append(rt.submit(wf, {"x": np.float64(i)}))
            for i, h in enumerate(handles):
                assert float(h.result()["out"]) == 2.0 * i + 1.0
                assert sanitizer.check(h.events, completed_run=True) == []
        assert seen and all(lane in ("local", "offload")
                            for lane, _ in seen)
    finally:
        rt.close()
    assert len(rec.runs) == 3 and rec.findings == []


def test_dispatch_hook_none_defers_to_fair_share():
    rt = EmeraldRuntime(emerald(), max_workers=2, telemetry=False,
                        dispatch_hook=lambda lane, run_ids: None)
    try:
        wf = Workflow("deferred")
        wf.var("x")
        wf.step("a", lambda x: {"out": x + 1}, inputs=("x",),
                outputs=("out",), device_step=False)
        h = rt.submit(wf, {"x": np.float64(1.0)})
        assert float(h.result()["out"]) == 2.0
    finally:
        rt.close()


# ------------------------------------------------- broker shutdown wakeup
class _NullPool:
    def spawn(self):
        raise AssertionError("test broker must not spawn workers")

    def kill(self, h):
        pass

    def close(self):
        pass


def test_broker_shutdown_survives_lost_wakeup(monkeypatch):
    """With no workers the dispatch loop parks in its condition wait.
    Suppress the shutdown notification entirely: the failsafe timed
    wait must still notice ``_closed`` and let the thread exit."""
    monkeypatch.setattr(Broker, "_FAILSAFE_WAKEUP_S", 0.05)
    broker = Broker(_NullPool())
    try:
        assert broker._dispatcher.is_alive()
        monkeypatch.setattr(broker._cond, "notify_all", lambda: None)
        broker.shutdown()
        broker._dispatcher.join(timeout=3.0)
        assert not broker._dispatcher.is_alive()
    finally:
        monkeypatch.undo()
        broker.shutdown()


# ------------------------------------------------- the FrontDoor model
def test_frontdoor_model_clean_is_exhaustively_hazard_free():
    res = explorer.explore(explorer.build_model("frontdoor"))
    assert res.exhaustive and res.hazard_count == 0


def test_frontdoor_model_finds_parked_starvation():
    res = explorer.explore(
        explorer.build_model("frontdoor", bugs=["parked_starved"]),
        max_hazards=1)
    assert "H125" in res.hazard_rules()


def test_frontdoor_model_finds_preemption_burning_progress():
    res = explorer.explore(
        explorer.build_model("frontdoor", bugs=["preempt_lost_step"]),
        max_hazards=1)
    assert "H126" in res.hazard_rules()


def test_frontdoor_reproducer_roundtrip(tmp_path):
    model = explorer.build_model("frontdoor", bugs=["parked_starved"])
    res = explorer.explore(model, max_hazards=1)
    sched, findings = res.hazards[0]
    small = explorer.minimize(model, sched)
    path = str(tmp_path / "repro.json")
    explorer.save_reproducer(path, model, small, findings)
    doc = explorer.load_reproducer(path)
    replayed, retriggered = explorer.replay_reproducer(doc)
    assert retriggered and "H125" in {f.rule for f in replayed}
