"""Text renderer for :meth:`EmeraldRuntime.introspect` snapshots.

The snapshot itself is built inside the runtime's driver thread (so it
is serially consistent with every state mutation); this module only
formats it. ``scripts/emtop.py`` is the CLI wrapper.
"""
from __future__ import annotations

from typing import Any, Dict, List


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}GiB"


def _bar(frac: float, width: int = 20) -> str:
    frac = max(0.0, min(1.0, frac))
    filled = int(round(frac * width))
    return "#" * filled + "." * (width - filled)


def render(snap: Dict[str, Any]) -> str:
    """Render an introspection snapshot as a multi-section text report."""
    lines: List[str] = []
    rt = snap.get("runtime", {})
    lines.append(f"emerald runtime  pid={rt.get('pid', '?')}  "
                 f"runs={len(snap.get('runs', []))}  "
                 f"telemetry={'on' if rt.get('telemetry') else 'off'}")

    lanes = snap.get("lanes", {})
    if lanes:
        lines.append("")
        lines.append("LANES")
        for name, lane in sorted(lanes.items()):
            busy, slots = lane.get("busy", 0), lane.get("slots", 0)
            frac = busy / slots if slots else 0.0
            lines.append(f"  {name:<10} [{_bar(frac)}] {busy}/{slots} busy")

    runs = snap.get("runs", [])
    if runs:
        lines.append("")
        lines.append("RUNS")
        lines.append(f"  {'run':<20} {'ns':<8} {'state':<10} "
                     f"{'done':>5} {'inflt':>5} {'ready':>5} {'pend':>5} "
                     f"{'retry':>5}  vtime")
        for r in runs:
            lines.append(
                f"  {r.get('run_id', '?'):<20} {r.get('ns', ''):<8} "
                f"{r.get('state', ''):<10} "
                f"{r.get('completed', 0):>5} {r.get('inflight', 0):>5} "
                f"{r.get('ready', 0):>5} {r.get('pending', 0):>5} "
                f"{r.get('retries', 0):>5}  "
                f"{r.get('fair_share_vtime', 0.0):.3f}")
        for r in runs:
            placements = r.get("placements") or {}
            if placements:
                placed = ", ".join(f"{s}->{t}" for s, t
                                   in sorted(placements.items()))
                lines.append(f"    {r.get('run_id', '?')}: {placed}")

    fd = snap.get("frontdoor", {})
    if fd and (fd.get("depth") or fd.get("parked_total")
               or fd.get("coalescers")):
        lines.append("")
        lines.append(f"FRONTDOOR  queued={fd.get('depth', 0)}/"
                     f"{fd.get('queue_limit', '?')} "
                     f"oldest_wait={fd.get('oldest_wait_s', 0.0):.3f}s "
                     f"parked_total={fd.get('parked_total', 0)} "
                     f"admitted={fd.get('admitted_total', 0)}")
        for p in fd.get("parked", []):
            slack = p.get("slack_s")
            slack_s = f"{slack:+.3f}s" if slack is not None else "-"
            lines.append(f"  {p.get('run_id', '?'):<20} "
                         f"{p.get('reason', ''):<10} "
                         f"waited={p.get('waited_s', 0.0):.3f}s "
                         f"slack={slack_s}")
        for c in fd.get("coalescers", []):
            lines.append(
                f"  coalescer {c.get('name', '?'):<12} "
                f"flushes={c.get('flushes', 0)} "
                f"avg_batch={c.get('avg_batch', 0.0):.1f} "
                f"ema={c.get('exec_ema_s', 0.0):.4f}s")
            for b in c.get("buckets", []):
                frac = (b.get("pending", 0) / c["max_batch"]) \
                    if c.get("max_batch") else 0.0
                lines.append(f"    {b.get('key', '?'):<32} "
                             f"[{_bar(frac, 12)}] {b.get('pending', 0)}"
                             f"/{c.get('max_batch', '?')} "
                             f"wait={b.get('oldest_wait_s', 0.0):.3f}s")

    mdss = snap.get("mdss", {})
    resid = mdss.get("residency", [])
    if resid:
        lines.append("")
        lines.append("RESIDENCY (namespace x tier)")
        for row in resid:
            budget = row.get("budget_bytes")
            used = row.get("resident_bytes", 0)
            if budget:
                pct = f"[{_bar(used / budget, 12)}] " \
                      f"{_fmt_bytes(used)}/{_fmt_bytes(budget)}"
            else:
                pct = f"{_fmt_bytes(used)} (no budget)"
            lines.append(f"  {row.get('namespace', '?'):<10} "
                         f"{row.get('tier', '?'):<8} {pct}")
    tiers = mdss.get("tiers", [])
    if tiers:
        lines.append("")
        lines.append("TIERS")
        for t in tiers:
            lines.append(
                f"  {t.get('name', '?'):<8} objs={t.get('objects', 0):<6} "
                f"resident={_fmt_bytes(t.get('resident_bytes'))} "
                f"cap={_fmt_bytes(t.get('capacity_bytes'))} "
                f"chunks={t.get('chunks', 0)} "
                f"chunk_bytes={_fmt_bytes(t.get('chunk_bytes'))}")

    memo = snap.get("memo", {})
    if memo:
        lines.append("")
        lines.append(f"MEMO  entries={memo.get('entries', 0)} "
                     f"bytes={_fmt_bytes(memo.get('bytes'))} "
                     f"hits={memo.get('hits', 0)} "
                     f"waits={memo.get('waits', 0)}")

    workers = snap.get("workers", {})
    if workers:
        lines.append("")
        lines.append(f"WORKERS  total={workers.get('num_workers', 0)} "
                     f"idle={workers.get('idle', 0)} "
                     f"warm={workers.get('warm', 0)} "
                     f"queue={workers.get('queue_depth', 0)} "
                     f"inflight={workers.get('inflight', 0)}")
        pids = workers.get("pids", [])
        if pids:
            lines.append(f"  pids: {', '.join(str(p) for p in pids)}")

    metrics = snap.get("metrics", {})
    if metrics:
        lines.append("")
        lines.append("METRICS")
        for name in sorted(metrics):
            v = metrics[name]
            if isinstance(v, dict):  # histogram
                avg = v.get("avg")
                lines.append(
                    f"  {name:<40} n={v.get('count', 0)} "
                    f"avg={avg:.4f}s" if avg is not None else
                    f"  {name:<40} n={v.get('count', 0)}")
            else:
                lines.append(f"  {name:<40} {v}")
    return "\n".join(lines)
