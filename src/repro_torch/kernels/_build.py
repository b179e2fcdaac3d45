"""Build a kernel's CUDA source into a shared library at first use.

Every Hopper kernel of the port is one ``csrc/*.cu`` file with a plain C
entry point. ``build(source)`` compiles it with ``nvcc`` for ``sm_90a``
into ``build/repro_torch/`` under the checkout, keyed by a hash of the
source and the flags, so a fresh checkout builds from the sources alone
and an edited source builds anew. The kernel modules load the library
with ``ctypes``. Importing this module needs neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "kernels are built from source at first use")
    return found


def library_path(source: Path) -> Path:
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    return BUILD_ROOT / f"{source.stem}_{key}.so"


def build(source: Path) -> Path:
    """Compile ``source`` if this version has not been built yet; returns
    the shared library's path, with ptxas's report (registers, spills)
    beside it as ``.ptxas.txt``. Raises with nvcc's output on failure."""
    out = library_path(source)
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    (out.with_suffix(".ptxas.txt")).write_text(res.stderr)
    return out
