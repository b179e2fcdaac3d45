"""The PyTorch port stands alone: it imports neither jax nor the JAX
package ``repro``, so it runs where jax is not installed."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["repro"] = None        # and so does the JAX package
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
assert {"repro_torch.models.moe", "repro_torch.analysis.sanitizer",
        "repro_torch.analysis.explorer", "repro_torch.analysis.selfcheck",
        "repro_torch.cloud.simfabric", "repro_torch.tools.emlint",
        "repro_torch.tools.emcheck", "repro_torch.tools.emtop",
        "repro_torch.parallel.sharding", "repro_torch.parallel.pipeline",
        "repro_torch.optim.grad_compress", "repro_torch.launch.mesh",
        "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
        "repro_torch.launch.comm_analysis"} <= set(names), \
    names
for n in names:
    importlib.import_module(n)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m in ("repro", "jax") or m.startswith(("repro.", "jax."))))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_every_module_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # the whole package was walked, not an empty namespace
    assert int(res.stdout.split()[-1]) >= 30


_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)(?:[.\s,]|$)|from\s+(?:jax|repro)[.\s])",
    re.MULTILINE)


EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def test_sources_import_no_jax_and_no_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
    assert len(files) > 30 and len(EXAMPLES) == 7
    bad = {str(f.relative_to(ROOT)): _FORBIDDEN.findall(f.read_text())
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


_WORKER_WITHOUT_TORCH = r"""
import sys
sys.modules["torch"] = None        # any `import torch` now raises
import numpy as np
import repro_torch.cloud.worker
from repro_torch.cloud import tasklib
from repro_torch.cloud.wire import BF16Bits, decode, encode
out = decode(encode(tasklib.resolve("add_one")(x=np.float64(1.0))))
assert float(out["y"]) == 2.0
bits = np.arange(6, dtype=np.int16).view(BF16Bits)
back = decode(encode({"b": bits}))["b"]
assert isinstance(back, BF16Bits) and (back == bits).all()
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "torch" or m.startswith("torch.")))
assert not leaked, leaked
print("ok")
"""


def test_worker_side_imports_without_torch():
    """What a fabric worker loads (``worker``, ``tasklib`` and the wire
    format) imports no torch, runs a registry step and carries a bfloat16
    buffer through as its tagged 16-bit pattern."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _WORKER_WITHOUT_TORCH],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "ok"


_TOOLS_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["repro"] = None        # and so does the JAX package
from repro_torch.tools import emcheck, emlint
assert emlint.main(["--self"]) == 0
assert emcheck.main(["--model", "frontdoor", "--max-hazards", "1",
                     "--bug", "parked_starved", "-q"]) == 1
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m in ("repro", "jax") or m.startswith(("repro.", "jax."))))
assert not leaked, leaked
print("ok")
"""


def test_analysis_tools_run_without_jax_or_the_reference():
    """``emlint --self`` lints the port and ``emcheck`` finds a planted
    bug with neither jax nor ``repro`` importable."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _TOOLS_WITHOUT_JAX], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[-1] == "ok"


_EXAMPLES_WITHOUT_JAX = r"""
import importlib, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["repro"] = None        # and so does the JAX package
names = sys.argv[1:]
for n in names:
    importlib.import_module(n)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m in ("repro", "jax") or m.startswith(("repro.", "jax."))))
assert not leaked, leaked
print(len(names))
"""


def test_examples_import_without_jax_or_the_reference():
    """Every ``examples/torch_*.py`` imports (its ``main`` not run) with
    neither jax nor ``repro`` importable."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    names = [f"examples.{f.stem}" for f in EXAMPLES]
    res = subprocess.run([sys.executable, "-c", _EXAMPLES_WITHOUT_JAX,
                          *names], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[-1]) == 7
