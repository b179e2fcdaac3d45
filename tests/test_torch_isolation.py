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
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
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


def test_sources_import_no_jax_and_no_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    bad = {str(f.relative_to(ROOT)): _FORBIDDEN.findall(f.read_text())
           for f in files}
    assert not {k: v for k, v in bad.items() if v}
