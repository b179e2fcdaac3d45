#!/usr/bin/env bash
# Smoke of the PyTorch port (src/repro_torch): its static-analysis and
# model-checking gates, its tests, and a short offload-fabric run.
#
#   ./scripts/smoke_torch.sh
#
# The counterpart of scripts/smoke.sh on the port's tools. Everything here
# runs on the host CPU. Left out: the benchmarks.* gates of smoke.sh (the
# analysis, explore, runtime, locality, dataplane, fanout, serve, dag and
# obs benches), which drive the JAX package and have no port. The card's
# smoke is chip_smoke.py.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

echo "== static analysis gate (emlint) =="
# the lint lints the port itself (catalogue drift + lock discipline)...
python -m repro_torch.tools.emlint --self
# ...and every workflow example must verify clean (warnings are errors
# here; W020 infos are allowed). torch_fabric_quickstart spawns worker
# processes and torch_train_lm / torch_serve_lm build models, so they are
# exercised by tests/test_torch_examples.py instead.
python -m repro_torch.tools.emlint --strict \
    examples.torch_quickstart examples.torch_wide_dag \
    examples.torch_multi_tenant examples.torch_adjoint_tomography

echo "== emcheck smoke (exhaustive diamond + reproducer replay) =="
timeout 300 python - <<'PY'
import time
from repro_torch.analysis.explorer import explore, model_diamond

t0 = time.time()
# gate 1: the canonical 6-step diamond exhausts its schedule space with
# full distinct-interleaving coverage and zero hazards
res = explore(model_diamond())
assert res.exhaustive, "diamond schedule space not exhausted"
assert res.hazard_count == 0, f"hazards on clean model: {res.hazard_rules()}"
assert res.schedules == len(res.coverage), (
    f"interleaving coverage lost: {len(res.coverage)} terminals for "
    f"{res.schedules} schedules")
print(f"emcheck: diamond exhausted — {res.schedules} schedules, "
      f"{res.decisions} decisions, {res.deduped} dedup cuts, "
      f"{res.por_pruned} POR prunes, 0 hazards "
      f"in {time.time() - t0:.1f}s")
PY
# gate 2: the planted duplicate-done race is found within 500 schedules,
# delta-debugged, serialized byte-identically, and the reproducer replays
# the hazard
REPRO_DIR="$(mktemp -d)"
trap 'rm -rf "$REPRO_DIR"' EXIT
EMCHECK="python -m repro_torch.tools.emcheck"
rc=0
$EMCHECK --model diamond --bug duplicate_done --max-schedules 500 \
    --max-hazards 1 --out "$REPRO_DIR/race1.json" -q || rc=$?
[ "$rc" -eq 1 ] || { echo "emcheck did not flag the planted race (rc=$rc)"; exit 1; }
rc=0
$EMCHECK --model diamond --bug duplicate_done --max-schedules 500 \
    --max-hazards 1 --out "$REPRO_DIR/race2.json" -q || rc=$?
[ "$rc" -eq 1 ] || { echo "emcheck second run rc=$rc"; exit 1; }
cmp "$REPRO_DIR/race1.json" "$REPRO_DIR/race2.json" \
    || { echo "reproducer serialization is not byte-identical"; exit 1; }
$EMCHECK --replay "$REPRO_DIR/race1.json" \
    || { echo "reproducer replay did not re-trigger the hazard"; exit 1; }
echo "emcheck: planted race found, minimized, replayed byte-identically"

echo "== emcheck front-door model (admission + preemption invariants) =="
$EMCHECK --model frontdoor -q
rc=0
$EMCHECK --model frontdoor --bug parked_starved --max-schedules 500 \
    --max-hazards 1 -q || rc=$?
[ "$rc" -eq 1 ] || { echo "emcheck missed parked_starved (rc=$rc)"; exit 1; }
rc=0
$EMCHECK --model frontdoor --bug preempt_lost_step --max-schedules 500 \
    --max-hazards 1 -q || rc=$?
[ "$rc" -eq 1 ] || { echo "emcheck missed preempt_lost_step (rc=$rc)"; exit 1; }

echo "== the port's tests =="
python -m pytest -q tests/test_torch_*.py

echo "== fabric smoke (2 workers) =="
timeout 120 python - <<'PY'
import time
from repro_torch.cloud import Fabric

t0 = time.time()
with Fabric(workers=2) as fabric:
    pids = fabric.broker.worker_pids()
    assert len(pids) == 2, pids
    assert fabric.broker.submit(step="add_one",
                                kwargs={"x": 41.0}).result(60)["y"] == 42.0
    # a quick 2-worker scaling sanity: 8 spins across the pool
    tasks = [fabric.broker.submit(step="spin", kwargs={"seconds": 0.05})
             for _ in range(8)]
    for t in tasks:
        t.result(60)
    assert fabric.broker.tasks_done >= 9
print(f"# fabric smoke ok in {time.time() - t0:.1f}s (workers {pids})")
PY
echo "smoke OK"
