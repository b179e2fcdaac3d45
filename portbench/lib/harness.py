"""One run of one cell: finding its files by name, the card check, the
set-up clock, the window, the harness's spans, the comparisons that
decide ``correct``, and the result line.

The drivers (``drivers/<driver>.py``) define ``run(r: Run)``; the metric
readers (``metrics/<metric>.py``) define ``read(r: Run)`` and return a
number, or None when the run holds nothing for them to read.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file of the benchmark by path (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for_cell(entries: List[dict], cell: str, e2e: List[str]) -> List[dict]:
    """Metric entries that this cell reports: those listing it, and those
    without a list whose end-to-end metric the cell reports."""
    out = []
    for m in entries:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif "moves" not in m or m["moves"] in e2e:
            out.append(m)
    return out


def find_cell(name: str, bench: Optional[dict] = None) -> dict:
    """Everything one cell is made of, found by name under ``portbench/``:
    its entry, spec, configuration, driver and metric readers."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = load_json(BENCH / "workloads" / f"{name}.json")
    if spec["config"] != entry["config"] or spec["traffic"]["name"] != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / conf_entry["file"])
    e2e = [m["name"] for m in _for_cell(bench["end_to_end"], name, [])]
    per_layer = _for_cell(bench["per_layer"], name, e2e)
    return {"entry": entry, "spec": spec, "config": config,
            "driver": BENCH / "drivers" / f"{spec['driver']}.py",
            "end_to_end": [m for m in bench["end_to_end"] if m["name"] in e2e],
            "per_layer": per_layer,
            "readers": {m["name"]: BENCH / "metrics" / f"{m['name']}.py"
                        for m in per_layer}}


def require_cards(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device; this benchmark measures "
                         "the port on the card and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} visible")


def cache_env():
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    os.environ.setdefault("USE_FLAX", "0")
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> List[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class Run:
    """The state of one run, handed to the driver and the readers."""

    def __init__(self, args, cell: dict, device: str = "cuda"):
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.cell = cell
        self.spec = cell["spec"]
        self.traffic = cell["spec"]["traffic"]
        self.config = cell["config"]
        self.device = device
        self.t_start = time.perf_counter() - process_age_s()
        self.t_setup_end: Optional[float] = None
        self.t_window: Optional[tuple] = None
        self.spans: List[tuple] = []        # (name, t0, t1, attrs) perf s
        self.program_spans: Callable[[], List[tuple]] = lambda: []
        self.units: List[dict] = []         # one per timed unit
        self.counters: Dict[str, Any] = {}
        self._stretch = None
        self.extra: Dict[str, Any] = {}
        self.compared: Dict[str, dict] = {}
        self.attempted = 0
        self.failed = 0
        self.e2e: Dict[str, float] = {}
        self.memory_peak = 0

    # ------------------------------------------------------------ clocks
    def note(self, what: str):
        """A progress line on standard error, seconds since the start."""
        print(f"portbench: {time.perf_counter() - self.t_start:.3f} s {what}",
              file=sys.stderr, flush=True)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        t0 = time.perf_counter()
        try:
            yield attrs
        finally:
            self.spans.append((name, t0, time.perf_counter(), attrs))

    def open_window(self):
        """The set-up ends and the window starts here. A cell that asks
        for it (``gc_freeze``) first moves the set-up's objects out of the
        collector's reach, so a full collection in the window walks only
        the window's objects instead of stalling every thread for the
        whole heap (hundreds of ms: FrontDoor's generator ran that late)."""
        if self.spec.get("gc_freeze"):
            gc.collect()
            gc.freeze()
        now = time.perf_counter()
        self.t_setup_end = now
        self.t_window = (now, None)

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_window[0]

    def close_window(self):
        self.t_window = (self.t_window[0], time.perf_counter())

    @property
    def window_s(self) -> float:
        a, b = self.t_window
        return b - a

    @property
    def setup_s(self) -> float:
        return self.t_setup_end - self.t_start

    def stretch(self):
        """Profile the block in a traced run (a no-op otherwise); the trace
        is read after the window."""
        if not self.trace or self.device == "cpu":
            return contextlib.nullcontext()
        from portbench.lib.profiling import Stretch
        self._stretch = Stretch(self.all_spans)
        return self._stretch

    @property
    def profile(self) -> Optional[dict]:
        return None if self._stretch is None else self._stretch.read()

    def all_spans(self) -> List[tuple]:
        """(label, t0, t1) of the program's spans and the harness's."""
        out = [(lab, a, b) for lab, a, b, _ in self.program_spans()]
        out += [(f"portbench:{n}", a, b) for n, a, b, _ in self.spans]
        return out

    # ------------------------------------------------------- correctness
    def compare(self, name: str, value: float, limit: float):
        """One number the check compares, with its limit (value <= limit)."""
        self.compared[name] = {"value": float(value), "limit": float(limit)}

    @property
    def correct(self) -> bool:
        return bool(self.compared) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.compared.values())

    def read_peak(self):
        import torch
        if self.device != "cpu":
            torch.cuda.synchronize()
            self.memory_peak = int(torch.cuda.max_memory_allocated())


def device_info(r: Run) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": r.cell["entry"]["chips"],
            "memory_peak_bytes": r.memory_peak}
    if r.trace and r.profile is not None:
        info["busy_s"] = r.profile["busy_s"]
        info["window_s"] = r.profile["window_s"]
    return info


def per_layer_values(r: Run) -> Dict[str, dict]:
    out = {}
    for m in r.cell["per_layer"]:
        mod = load_module(r.cell["readers"][m["name"]],
                          "portbench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(r)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result_line(r: Run) -> dict:
    if r.trace:
        metrics = per_layer_values(r)
    else:
        metrics = {m["name"]: {"value": float(r.e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in r.cell["end_to_end"]}
    line = {"correct": r.correct, "attempted": int(r.attempted),
            "failed": int(r.failed), "metrics": metrics,
            "device": device_info(r)}
    if r.trace and r.profile is not None:
        from portbench.lib.profiling import top
        line["breakdown"] = {"device_ops": top(r.profile["kernel_s"]),
                             "idle_gaps": top(r.profile["gaps"])}
    line["compared"] = r.compared
    return line


def card_line() -> str:
    import subprocess
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"
