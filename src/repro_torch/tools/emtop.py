"""emtop — text view of an EmeraldRuntime introspection snapshot.

Usage:
    # render a snapshot someone exported with json.dump(rt.introspect())
    python -m repro_torch.tools.emtop snapshot.json
    cat snapshot.json | python -m repro_torch.tools.emtop -

    # self-contained demo: spin a tiny two-tenant runtime and render it
    # (its cloud tier on the card; --device cpu runs it on the host)
    python -m repro_torch.tools.emtop --demo

The snapshot is produced by ``EmeraldRuntime.introspect()`` — built on
the runtime's driver thread, so it is serially consistent with every
state mutation (a step is never shown simultaneously in-flight and
completed). This module only formats it.
"""
import argparse
import json
import sys

from repro_torch.obs.introspect import render


def _demo_snapshot(device=None):
    from repro_torch.core import default_tiers
    from repro_torch.core.runtime import EmeraldRuntime
    from repro_torch.core.workflow import Workflow

    def make_wf(name):
        wf = Workflow(name)
        wf.var("x")
        wf.step("a", lambda x: {"y": x + 1}, inputs=["x"], outputs=["y"],
                device_step=False)
        wf.step("b", lambda y: {"z": y * 2}, inputs=["y"], outputs=["z"],
                device_step=False)
        return wf

    rt = EmeraldRuntime(tiers=default_tiers(cloud_device=device),
                        policy="annotate", max_workers=2, local_workers=2)
    try:
        h1 = rt.submit(make_wf("alpha"), {"x": 1})
        h2 = rt.submit(make_wf("beta"), {"x": 10}, weight=2.0)
        snap = rt.introspect()
        h1.result(30)
        h2.result(30)
        return snap
    finally:
        rt.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("snapshot", nargs="?",
                    help="path to a JSON snapshot, or - for stdin")
    ap.add_argument("--demo", action="store_true",
                    help="run a tiny two-tenant demo runtime and render it")
    ap.add_argument("--device", default=None,
                    help="the demo's cloud-tier device (default: the card)")
    args = ap.parse_args(argv)
    if args.demo:
        snap = _demo_snapshot(args.device)
    elif args.snapshot == "-":
        snap = json.load(sys.stdin)
    elif args.snapshot:
        with open(args.snapshot) as f:
            snap = json.load(f)
    else:
        ap.error("need a snapshot path, -, or --demo")
    print(render(snap))


if __name__ == "__main__":
    main()
