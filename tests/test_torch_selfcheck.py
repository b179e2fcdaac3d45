"""The port's source self-lint against ``repro.analysis.selfcheck``.

The port lints its own tree, ``src/repro_torch``: every ``emit(`` kind
and dotted metric name there is registered in the port's
``EVENT_SCHEMA`` / ``METRIC_CATALOG``, and the lock-discipline pass
finds nothing. Drift canaries and lock snippets give the reference's
rule ids on the same sources.
"""
import pathlib
import textwrap

import pytest

from repro.analysis import selfcheck as ref
from repro_torch.analysis import selfcheck

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def rules(findings):
    return sorted(f.rule for f in findings)


def test_port_sources_lint_clean():
    assert pathlib.Path(selfcheck.default_src_dir()) == PORT
    findings = selfcheck.check_source()
    assert not findings, "\n".join(str(f) for f in findings)
    # the reference's lint, run over the same tree, agrees
    assert ref.check_source(str(PORT)) == []


def test_drift_canary_fires_l001_and_l002(tmp_path):
    """A planted unregistered event kind and metric name: both lints
    report them, so a clean tree above is not a vacuous pass."""
    (tmp_path / "drift.py").write_text('run.emit("bogus_kind", s)\n'
                                       'metrics.inc("bogus.metric")\n')
    got = selfcheck.check_source(str(tmp_path))
    assert rules(got) == ["L001", "L002"]
    assert rules(got) == rules(ref.check_source(str(tmp_path)))


def test_dynamic_metric_names_are_linted(tmp_path):
    """Names built with f-strings or ``+`` are checked as prefix
    patterns against the port's registries."""
    bad = ('def f(metrics, run, k):\n'
           '    metrics.inc(f"nosuch.{k}_total")\n'
           '    run.emit(f"bogus_{k}", object())\n')
    assert rules(selfcheck.check_snippet(bad)) == ["L001", "L002"]
    ok = ('def f(metrics, kind):\n'
          '    metrics.inc(f"emcheck.{kind}")\n'
          '    metrics.inc("fanout." + kind)\n')
    assert selfcheck.check_snippet(ok) == []
    (tmp_path / "dyn.py").write_text(
        'def f(metrics, k):\n'
        '    metrics.observe(f"nosuch.{k}.seconds", 1.0)\n')
    got = selfcheck.check_source(str(tmp_path))
    assert rules(got) == ["L002"]
    assert rules(got) == rules(ref.check_source(str(tmp_path)))


def test_registered_kinds_and_metrics_pass():
    src = ('def f(run, metrics, s):\n'
           '    run.emit("dispatch", s)\n'
           '    metrics.inc("runtime.step_retries")\n'
           '    metrics.observe("emcheck.replays", 1)\n')
    assert selfcheck.check_snippet(src) == []
    assert ref.check_snippet(src) == []


# lock-discipline snippets beyond the defect corpus: each gives the
# reference's rule ids (the rule noted is what the reference reports)
LOCK_SNIPPETS = {
    "timed-wait-under-lock": ("""
        class S:
            def poll(self):
                with self._state_lock:
                    self._evt.wait(0.1)
        """, []),
    "untimed-foreign-wait": ("""
        class S:
            def poll(self):
                with self._state_lock:
                    self._evt.wait()
        """, ["L011"]),
    "pickle-under-lock": ("""
        import pickle

        class S:
            def save(self):
                with self._io_lock:
                    return pickle.dumps(self.state)
        """, ["L011"]),
    "recv-under-lock": ("""
        class S:
            def read(self):
                with self._sock_lock:
                    return self.sock.recv(4096)
        """, ["L011"]),
    "with-pair-declares-order": ("""
        class S:
            def a(self):
                with self._mu_lock, self._io_lock:
                    self.flush()

            def b(self):
                with self._io_lock:
                    with self._mu_lock:
                        self.flush()
        """, ["L010"]),
    "reentrant-same-lock": ("""
        class S:
            def a(self):
                with self._mu_lock:
                    with self._mu_lock:
                        self.flush()
        """, []),
    "same-name-other-class": ("""
        class A:
            def f(self):
                with self._mu_lock:
                    with self._io_lock:
                        pass

        class B:
            def g(self):
                with self._io_lock:
                    with self._mu_lock:
                        pass
        """, []),
    "cond-wait-in-predicate-loop": ("""
        class S:
            def take(self):
                with self._cond:
                    while not self.items:
                        self._cond.wait()
                    return self.items.pop()
        """, []),
}


@pytest.mark.parametrize("name", sorted(LOCK_SNIPPETS))
def test_lock_snippets_match_reference(name):
    src, want = LOCK_SNIPPETS[name]
    src = textwrap.dedent(src)
    got = rules(selfcheck.check_snippet(src))
    assert got == rules(ref.check_snippet(src))
    assert got == want
