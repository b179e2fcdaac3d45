"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Finds the cell in ``BENCHMARK.json`` and its
files under ``portbench/`` by name, needs as many CUDA cards as the cell
asks for (it has no CPU fallback), runs the cell's driver (set-up, the
measured window, then the check against the plain reference), and prints
the numbers compared beside their limits last on standard error and one
JSON object last on standard output. ``--trace 1`` profiles a short
stretch of the window and reports the per-layer metrics instead of the
end-to-end ones.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    from portbench.lib import harness as h
    args = h.parse_args(argv)
    cell = h.find_cell(args.workload)
    h.cache_env()
    h.require_cards(cell["entry"]["chips"])
    r = h.Run(args, cell)
    print(f"portbench: {args.workload} seed {args.seed} on "
          f"{h.card_line()}", file=sys.stderr, flush=True)
    driver = h.load_module(cell["driver"], "portbench_driver")
    driver.run(r)
    bad = h.forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}; the port's benchmark "
              f"may not", file=sys.stderr, flush=True)
        return 4
    line = h.result_line(r)
    for name, c in r.compared.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
