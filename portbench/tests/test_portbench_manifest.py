"""BENCHMARK.json against the rules its format keeps (names, units, keys,
sizes), and the harness finding every cell, configuration, driver and
metric reader by name."""
import ast
import json
import re
from pathlib import Path

import pytest

from portbench.lib import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"config": {"name", "source", "file", "reduced", "why"},
        "workload": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
WIDTH = re.compile(r"(hidden_size|intermediate|latent|state_size|proj|head|expand"
                   r"|experts_per_tok|_dim$|_rank$)")
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and \
        isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in paths), w


@pytest.mark.parametrize("kind,entries", [
    ("config", BENCH["configs"]), ("workload", BENCH["workloads"]),
    ("end_to_end", BENCH["end_to_end"]), ("per_layer", BENCH["per_layer"])])
def test_names_units_and_keys(kind, entries):
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert set(e) - {"workloads"} == KEYS[kind], e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert one_line(e[k]), e[k]
        if kind == "workload":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)
        if kind == "config":
            assert len(e["reduced"]) <= 16
            assert all(NAME.match(k) and not WIDTH.search(k)
                       for k in e["reduced"])


def test_metrics_cover_every_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(m["source"] in ("host_clock", "device_trace") and
               0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for cell in CELLS:
        found = harness.find_cell(cell, BENCH)
        names = [m["name"] for m in found["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2
        assert found["per_layer"], cell


@pytest.mark.parametrize("cell", CELLS)
def test_harness_finds_each_cell_by_name(cell):
    found = harness.find_cell(cell, BENCH)
    assert found["driver"].is_file()
    assert all(p.is_file() for p in found["readers"].values())
    spec = found["spec"]
    assert spec["chips"] == found["entry"]["chips"]
    assert set(spec["check"]) and all(v > 0 for v in spec["check"].values())
    conf = next(c for c in BENCH["configs"] if c["name"] == spec["config"])
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["reduced"] == conf["reduced"]
    mod = harness.load_module(found["driver"], "t_driver_" + spec["driver"])
    assert callable(mod.run)
    for name, path in found["readers"].items():
        reader = harness.load_module(path, "t_metric_" + name.replace(".", "_"))
        assert callable(reader.read)


def test_every_config_used_and_files_distinct():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith("portbench/") for f in files)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix() for p in (ROOT / "portbench").rglob("*.py")))
def test_no_jax_and_no_program_in_the_reference(path):
    tops = set(_imports(ROOT / path))
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, (path, tops)
    if path.startswith("portbench/reference/"):
        assert not any(t.startswith("repro") for t in tops), (path, tops)
