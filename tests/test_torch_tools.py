"""``repro_torch.tools`` (emlint, emcheck, emtop) against the reference's
``scripts/emlint.py``, ``scripts/emcheck.py`` and ``scripts/emtop.py``:
the same exit codes and output lines for the same arguments, and the
same rendering of one introspection snapshot.
"""
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro_torch.core as tcore
from repro.obs.introspect import render as ref_render
from repro_torch.tools import emcheck, emlint, emtop

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = {name: _script(name) for name in ("emlint", "emcheck", "emtop")}


def run(main, argv, capsys):
    """(exit code, stdout lines) of one tool's ``main``."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr().out.splitlines()


def both(tool, port, argv, capsys, paths=()):
    """Run the port's tool and the reference script with ``argv``; the
    paths in ``paths`` (per side: (port_path, ref_path)) are read as
    ``<path>`` in the output."""
    def norm(lines, side):
        for p in paths:
            lines = [ln.replace(str(p[side]), "<path>") for ln in lines]
        return lines
    p_rc, p_out = run(port.main, [a if not isinstance(a, tuple) else str(a[0])
                                  for a in argv], capsys)
    r_rc, r_out = run(REF[tool].main, [a if not isinstance(a, tuple)
                                       else str(a[1]) for a in argv], capsys)
    return (p_rc, norm(p_out, 0)), (r_rc, norm(r_out, 1))


# ------------------------------------------------------------------ emlint
def test_emlint_list(capsys):
    (p_rc, p_out), (r_rc, r_out) = both("emlint", emlint, ["--list"], capsys)
    assert p_rc == r_rc == 0
    # the rule lines agree; hints name each package's own modules
    assert [ln for ln in p_out if not ln.strip().startswith("hint:")] == \
           [ln for ln in r_out if not ln.strip().startswith("hint:")]
    assert len(p_out) == len(r_out) == 2 * len(emlint.RULES)


def test_emlint_self_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.tools.emlint",
                          "--self"], env=env, capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.splitlines() == ["emlint --self: 0 finding(s)"]


def test_emlint_without_targets_is_a_usage_error(capsys):
    (p_rc, _), (r_rc, _) = both("emlint", emlint, [], capsys)
    assert p_rc == r_rc == 2


TARGET = '''
from {pkg}.core.workflow import Workflow


def _fn(**kw):
    return {{}}


CYCLE = Workflow("cycle")
CYCLE.step("a", _fn, inputs=("vb",), outputs=("va",))
CYCLE.step("b", _fn, inputs=("va",), outputs=("vb",))


def racy():
    wf = Workflow("racy")
    wf.var("x")
    wf.step("w1", _fn, inputs=("x",), outputs=("r",))
    wf.step("w2", _fn, inputs=("x",), outputs=("r",))
    wf.step("read", _fn, inputs=("r",), outputs=("out",))
    return wf


EMLINT_WORKFLOWS = [racy]
'''


@pytest.fixture
def targets(tmp_path):
    """The same workflow module built on each package: (port, ref)."""
    out = []
    for pkg in ("repro_torch", "repro"):
        d = tmp_path / pkg
        d.mkdir()
        (d / "wfs.py").write_text(TARGET.format(pkg=pkg))
        out.append(d / "wfs.py")
    return tuple(out)


def test_emlint_target_module(targets, capsys):
    (p_rc, p_out), (r_rc, r_out) = both("emlint", emlint, [targets], capsys,
                                        paths=[targets])
    assert p_rc == r_rc == 1             # the cycle is an error
    assert p_out == r_out
    assert any("W001" in ln for ln in p_out)
    assert "emlint <path>/racy: " in "\n".join(p_out)


def test_emlint_strict_blocks_on_warnings(targets, capsys):
    port = (f"{targets[0]}:racy", f"{targets[1]}:racy")
    for argv, want in (([port], 0), ([port, "--strict"], 1)):
        (p_rc, p_out), (r_rc, r_out) = both("emlint", emlint, argv, capsys,
                                            paths=[targets])
        assert p_rc == r_rc == want
        assert p_out == r_out


# ----------------------------------------------------------------- emcheck
def test_emcheck_diamond_exhaustive(capsys):
    (p_rc, p_out), (r_rc, r_out) = both(
        "emcheck", emcheck, ["--model", "diamond", "--exhaustive"], capsys)
    assert p_rc == r_rc == 0
    assert p_out == r_out and "(exhausted)" in p_out[0]


def test_emcheck_minimize_out_then_replay(tmp_path, capsys):
    out = (tmp_path / "port.json", tmp_path / "ref.json")
    argv = ["--model", "diamond", "--bug", "duplicate_done",
            "--max-hazards", "1", "--minimize", "--out", out]
    (p_rc, p_out), (r_rc, r_out) = both("emcheck", emcheck, argv, capsys,
                                        paths=[out])
    assert p_rc == r_rc == 1             # hazards found
    assert p_out == r_out
    assert p_out[-1] == "emcheck: wrote reproducer <path>"
    assert out[0].read_bytes() == out[1].read_bytes()
    # each side replays its own file (and the other's: they are the same)
    (p_rc, p_out), (r_rc, r_out) = both("emcheck", emcheck,
                                        ["--replay", out], capsys,
                                        paths=[out])
    assert p_rc == r_rc == 0             # reproduced
    assert p_out == r_out and "reproduced H101" in p_out[0]


def test_emcheck_replay_that_does_not_reproduce(tmp_path, capsys):
    doc = {"emcheck_version": 1, "hazards": ["H101"], "minimized": True,
           "model": {"name": "diamond", "params": {}, "bugs": []},
           "schedule": []}
    path = tmp_path / "clean.json"
    path.write_text(json.dumps(doc))
    (p_rc, p_out), (r_rc, r_out) = both("emcheck", emcheck,
                                        ["--replay", str(path)], capsys)
    assert p_rc == r_rc == 1
    assert p_out == r_out and "FAILED to reproduce" in p_out[0]


@pytest.mark.parametrize("flag", ["--list-models", "--list-bugs"])
def test_emcheck_lists(flag, capsys):
    (p_rc, p_out), (r_rc, r_out) = both("emcheck", emcheck, [flag], capsys)
    assert p_rc == r_rc == 0
    assert p_out == r_out and p_out


def test_emcheck_module_target_and_sampling(targets, capsys):
    argv = [targets, "--samples", "30", "--seed", "3"]
    (p_rc, p_out), (r_rc, r_out) = both("emcheck", emcheck, argv, capsys,
                                        paths=[targets])
    assert p_rc == r_rc
    assert p_out == r_out
    assert len([ln for ln in p_out if ln.startswith("emcheck: ")]) == 2


def test_emcheck_without_models_is_a_usage_error(capsys):
    (p_rc, _), (r_rc, _) = both("emcheck", emcheck, [], capsys)
    assert p_rc == r_rc == 2


# ------------------------------------------------------------------- emtop
def _chain_wf(name):
    wf = tcore.Workflow(name)
    wf.var("x")
    wf.step("a", lambda x: {"y": x + 1}, inputs=["x"], outputs=["y"],
            device_step=False)
    wf.step("b", lambda y: {"z": y * 2}, inputs=["y"], outputs=["z"],
            device_step=False)
    return wf


def test_emtop_renders_a_port_snapshot_as_the_reference_does(tmp_path,
                                                             capsys,
                                                             monkeypatch):
    tiers = tcore.default_tiers(cloud_device="cpu")
    cm = tcore.CostModel(tiers)
    mgr = tcore.MigrationManager(tiers, tcore.MDSS(tiers, cost_model=cm), cm)
    with tcore.EmeraldRuntime(mgr, max_workers=2, local_workers=2) as rt:
        h1 = rt.submit(_chain_wf("alpha"), {"x": np.float64(1.0)})
        h2 = rt.submit(_chain_wf("beta"), {"x": np.float64(10.0)},
                       weight=2.0)
        live = json.loads(json.dumps(rt.introspect()))
        assert float(h1.result(30)["z"]) == 4.0
        assert float(h2.result(30)["z"]) == 22.0
        final = json.loads(json.dumps(rt.introspect()))
    for snap in (live, final):
        text = emtop.render(snap)
        assert text == ref_render(snap)
        assert "LANES" in text and "METRICS" in text
    assert "alpha" in emtop.render(live)     # the runs were live then
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(final))
    emtop.main([str(path)])
    assert capsys.readouterr().out == ref_render(final) + "\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(json.dumps(live)))
    emtop.main(["-"])
    assert capsys.readouterr().out == ref_render(live) + "\n"


def test_emtop_demo_on_the_host(capsys):
    emtop.main(["--demo", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("emerald runtime") and "RUNS" in out
    with pytest.raises(SystemExit) as ei:
        emtop.main([])
    assert ei.value.code == 2
