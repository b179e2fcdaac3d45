"""The port's examples (``examples/torch_*.py``), each run as a
subprocess with ``--device cpu`` at small flags, held to their JAX
counterparts (``examples/*.py``, run alike with ``JAX_PLATFORMS=cpu``).

Where an example's inputs come from numpy (quickstart, wide_dag,
fabric_quickstart, adjoint_tomography, and multi_tenant's AT tenant) its
printed results equal the JAX example's: the AT misfit history at
``test_torch_at.py``'s rel 5e-4, the rest at rel 1e-5, each beside the
resolution of the number as printed (one unit in its last digit, since
both sides are rounded to it); event kinds, steps and MDSS bytes exactly.
Where they come from ``jax.random`` (the LMs' params) the structure is
checked: every request served, the tokens counted, the steps taken, a
checkpoint written and resumed, later AT iterations more code-only than
the first.

The runs start together from one module fixture, four at a time, each
with its own timeout.
"""
import os
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 150
AT_FLAGS = ["--iters", "3", "--nx", "32", "--nt", "60"]
MT_FLAGS = ["--at-iters", "3", "--lm-requests", "3", "--nx", "32"]
SERVE_FLAGS = ["--requests", "4", "--max-new", "4"]
TRAIN_FLAGS = ["--reduced", "--seq", "32", "--batch", "2", "--ckpt-every",
               "2"]
NUM = r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?"


def _run(name, args, port=True):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), os.environ.get("PYTHONPATH", "")]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    script = ROOT / "examples" / (f"torch_{name}.py" if port else
                                  f"{name}.py")
    args = ["--device", "cpu"] + list(args) if port else list(args)
    res = subprocess.run([sys.executable, str(script), *args], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert res.returncode == 0, f"{script.name} {args}:\n{res.stdout}\n" \
                                f"{res.stderr[-4000:]}"
    return res.stdout


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ck"))
    jobs = {
        **{(n, side): (n, [], side == "port") for n in
           ("quickstart", "wide_dag", "fabric_quickstart")
           for side in ("port", "jax")},
        ("adjoint_tomography", "port"): ("adjoint_tomography", AT_FLAGS,
                                         True),
        ("adjoint_tomography", "jax"): ("adjoint_tomography", AT_FLAGS,
                                        False),
        ("multi_tenant", "port"): ("multi_tenant", MT_FLAGS, True),
        ("multi_tenant", "jax"): ("multi_tenant", MT_FLAGS, False),
        ("serve_lm", "port"): ("serve_lm", SERVE_FLAGS, True),
        ("serve_lm", "jax"): ("serve_lm", SERVE_FLAGS, False),
    }

    def train():
        first = _run("train_lm", TRAIN_FLAGS + ["--steps", "4",
                                                "--ckpt-dir", ck])
        again = _run("train_lm", TRAIN_FLAGS + ["--steps", "2", "--resume",
                                                "--ckpt-dir", ck])
        return first, again, sorted(os.listdir(ck))

    with ThreadPoolExecutor(4) as pool:
        t = pool.submit(train)
        futs = {k: pool.submit(_run, *v) for k, v in jobs.items()}
        out = {k: f.result() for k, f in futs.items()}
        out["train"] = t.result()
    return out


def _nums(line):
    return [float(x) for x in re.findall(NUM, line)]


def _close(a, b, rtol, text_b):
    """|a - b| within rtol of b plus one unit in the last digit printed
    (``text_b``: b as printed)."""
    mant = text_b.lower().split("e")[0]
    digits = len(mant.split(".")[1]) if "." in mant else 0
    exp = int(text_b.lower().split("e")[1]) if "e" in text_b.lower() else 0
    return abs(a - b) <= rtol * abs(b) + 10.0 ** (exp - digits)


def _line(text, prefix):
    lines = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    assert lines, (prefix, text)
    return lines[0]


def _events(text):
    """The (kind, step, tier) event lines, as a multiset (parallel steps
    interleave in either order)."""
    block = text.split("events:\n")[1].split("\n")
    return sorted(tuple(ln.split()[:3]) for ln in block
                  if ln.startswith("  ") and not ln.startswith("  t="))


def test_quickstart_matches_the_jax_example(outs):
    port, ref = outs[("quickstart", "port")], outs[("quickstart", "jax")]
    assert _line(port, "migration points:") == _line(ref, "migration points:")
    got, want = (_line(t, "summary:") for t in (port, ref))
    texts = re.findall(NUM, want)
    assert len(texts) == 2
    for a, b, tb in zip(_nums(got), _nums(want), texts):
        assert _close(a, b, 1e-5, tb), (got, want)
    assert _events(port) == _events(ref)
    assert _line(port, "bytes moved:") == _line(ref, "bytes moved:")
    assert _line(port, "modeled transfer") == _line(ref, "modeled transfer")


def test_wide_dag_matches_the_jax_example(outs):
    port, ref = outs[("wide_dag", "port")], outs[("wide_dag", "jax")]

    def prio(t):
        return t.split("\n\n")[0]
    assert prio(port) == prio(ref)
    assert len(prio(port).splitlines()) == 12
    # at least the critical path's sleeps (an upper bound would time the
    # host)
    assert _nums(_line(port, "makespan:"))[0] >= 549

    def log(t):
        return sorted(tuple(ln.split()[-2:]) for ln in
                      t.split("event log:\n")[1].splitlines() if ln.strip())
    assert log(port) == log(ref)


def test_fabric_quickstart_matches_the_jax_example(outs):
    port = outs[("fabric_quickstart", "port")]
    ref = outs[("fabric_quickstart", "jax")]
    got, want = (_line(t, "score:") for t in (port, ref))
    assert _close(_nums(got)[0], _nums(want)[0], 1e-5, re.findall(NUM, want)[0])
    assert [e[:2] for e in _events(port)] == [e[:2] for e in _events(ref)]
    assert "remote=True" in port
    assert _line(port, "mdss bytes moved:") == _line(ref, "mdss bytes moved:")
    assert _line(port, "autoscaler after burst:") == \
        _line(ref, "autoscaler after burst:")
    assert _line(port, "workers active=") == _line(ref, "workers active=")


def test_adjoint_tomography_matches_the_jax_example(outs):
    port = outs[("adjoint_tomography", "port")]
    ref = outs[("adjoint_tomography", "jax")]
    assert _line(port, "mesh ") == _line(ref, "mesh ")
    its = [[ln for ln in t.splitlines() if ln.startswith("iter ")]
           for t in (port, ref)]
    assert len(its[0]) == len(its[1]) == 3
    for a, b in zip(*its):
        ta = re.search(r"misfit\s+(\S+)", a).group(1)
        tb = re.search(r"misfit\s+(\S+)", b).group(1)
        assert _close(float(ta), float(tb), 5e-4, tb), (a, b)
        assert a.split("[")[1] == b.split("[")[1]        # MB moved
    got, want = (_line(t, "final model RMS") for t in (port, ref))
    tb = re.search(r"model: (\S+) m/s", want).group(1)
    assert _close(float(re.search(r"model: (\S+) m/s", got).group(1)),
                  float(tb), 1e-5, tb), (got, want)
    assert _line(port, "offloads:") == _line(ref, "offloads:")


def test_multi_tenant_runs_both_tenants(outs):
    port = outs[("multi_tenant", "port")]
    ref = outs[("multi_tenant", "jax")]
    assert _line(port, "3 AT iterations + 3 LM scores")
    # the AT tenant's inputs are numpy's: its misfits are the reference's
    got, want = (_line(t, "AT misfit:") for t in (port, ref))
    for a, b, tb in zip(_nums(got), _nums(want), re.findall(NUM, want)):
        assert _close(a, b, 5e-4, tb), (got, want)
    # the LM tenant: two top tokens per scored batch
    assert len(_nums(_line(port, "LM top tokens (req 0):"))) == 3
    # after the first iteration the model and obs stay resident: later
    # iterations ship only what the host's forward step made
    per_it = [tuple(int(v) for v in m) for m in re.findall(
        r"\((\d+), (\d+)\)", _line(port, "code-only offloads"))]
    assert len(per_it) == 3 and all(n == 3 for _, n in per_it)
    assert all(c > per_it[0][0] for c, _ in per_it[1:]), per_it
    for ns in ("namespace 'shared'", "namespace 'at'"):
        assert _line(port, ns) == _line(ref, ns)


def test_serve_lm_serves_every_request(outs):
    port, ref = outs[("serve_lm", "port")], outs[("serve_lm", "jax")]
    done = [r for ln in port.splitlines() if ln.startswith("batch done:")
            for r in re.findall(r"\d+", ln.split("(")[0])]
    assert sorted(map(int, done)) == [0, 1, 2, 3]
    # the same prompts (numpy's) pack into the same batches
    assert _line(port, "stats:") == _line(ref, "stats:")
    tokens = int(re.search(r"'tokens_out': (\d+)", port).group(1))
    assert tokens > 0 and _line(port, f"4 requests, {tokens} tokens")
    rep = _line(port, "transfers:")
    calls = int(re.search(r"'decode_calls': (\d+)", port).group(1))
    assert f"'decode_offloads': {calls}" in rep


def test_train_lm_checkpoints_and_resumes(outs):
    first, again, files = outs["train"]
    steps = [int(m) for m in re.findall(r"^step\s+(\d+) loss", first, re.M)]
    assert steps == [0, 3]
    assert all(_nums(ln) for ln in first.splitlines()
               if ln.startswith("step "))
    assert "'offloads': 4" in _line(first, "transfer report:")
    # checkpoints every 2 steps, resumed from step 4's
    resumed = [int(m) for m in re.findall(r"^step\s+(\d+) loss", again, re.M)]
    assert resumed == [5]
    assert "'offloads': 2" in _line(again, "transfer report:")
    assert {"train-00000002.npz", "train-00000004.npz",
            "train-00000006.npz"} <= set(files)
