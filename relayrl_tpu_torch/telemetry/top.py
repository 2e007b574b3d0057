"""``python -m relayrl_tpu_torch.telemetry.top`` — one-screen live fleet summary.

Polls a telemetry exporter's ``/snapshot`` JSON endpoint and renders the
plane-by-plane view an operator wants at a glance: server ingest rates,
learner pipeline stage latencies, transport wire traffic, actor
throughput. Rates are deltas between consecutive snapshots (counters are
cumulative), so the first frame shows totals only.

Usage::

    python -m relayrl_tpu_torch.telemetry.top [--url http://127.0.0.1:9100]
                                        [--interval 2.0] [--once]

``--once`` prints a single frame and exits (scripts, tests); the default
loops with an ANSI clear between frames until interrupted.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request

# (section title, metric-name prefix) — the render groups by prefix so a
# new instrumented subsystem shows up without touching this CLI.
_SECTIONS = (
    ("server", "relayrl_server_"),
    ("learner", "relayrl_learner_"),
    ("transport", "relayrl_transport_"),
    ("relay", "relayrl_relay_"),
    ("rlhf", "relayrl_rlhf_"),
    ("trace", "relayrl_trace_"),
    ("serving", "relayrl_serving_"),
    ("fleet", "relayrl_fleet_"),
    ("alerts", "relayrl_alert"),
    ("actor", "relayrl_actor_"),
    ("epoch", "relayrl_epoch_"),
)


def fetch_snapshot(url: str, timeout_s: float = 5.0) -> dict:
    with urllib.request.urlopen(url.rstrip("/") + "/snapshot",
                                timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


def fetch_fleet(url: str, timeout_s: float = 5.0) -> dict:
    with urllib.request.urlopen(url.rstrip("/") + "/fleet",
                                timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


def _key(entry: dict) -> str:
    labels = entry.get("labels") or {}
    if not labels:
        return entry["name"]
    body = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{entry['name']}{{{body}}}"


def histogram_quantile(entry: dict, q: float) -> float | None:
    """Linear-interpolated quantile estimate from cumulative-izable
    fixed-bucket counts (the standard Prometheus estimation)."""
    counts = entry.get("counts") or []
    total = entry.get("count") or 0
    if not total:
        return None
    bounds = list(entry["buckets"]) + [float("inf")]
    target = q * total
    cumulative = 0
    for i, (bound, n) in enumerate(zip(bounds, counts)):
        prev_cum = cumulative
        cumulative += n
        if cumulative >= target:
            if bound == float("inf"):
                return entry["buckets"][-1]  # open bucket: clamp to last bound
            lo = bounds[i - 1] if i else 0.0
            frac = (target - prev_cum) / n if n else 0.0
            return lo + (bound - lo) * frac
    return None


def _fmt_num(v: float | None) -> str:
    if v is None:  # snapshot's strict-JSON stand-in for NaN/Inf
        return "NaN"
    if abs(v) >= 1e6:
        return f"{v / 1e6:.2f}M"
    if abs(v) >= 1e3:
        return f"{v / 1e3:.1f}k"
    if isinstance(v, float) and not v.is_integer():
        return f"{v:.4g}"
    return str(int(v))


def render(snapshot: dict, prev: dict | None = None) -> str:
    """Pure snapshot(s) → screen text (tested without any HTTP)."""
    if not snapshot.get("enabled", False):
        return "telemetry disabled on the target process\n"
    lines = [
        f"relayrl telemetry · run {snapshot.get('run_id')}"
        f" · up {snapshot.get('uptime_s', 0):.0f}s"
        f" · {time.strftime('%H:%M:%S')}",
    ]
    prev_by_key = {}
    dt = None
    if prev is not None and prev.get("metrics"):
        prev_by_key = {_key(e): e for e in prev["metrics"]}
        dt = (snapshot["mono_ns"] - prev["mono_ns"]) / 1e9
        if dt <= 0:
            dt = None
    by_section: dict[str, list[str]] = {}
    for entry in snapshot.get("metrics", []):
        name = entry["name"]
        section = next((title for title, prefix in _SECTIONS
                        if name.startswith(prefix)), "other")
        short = name
        for _, prefix in _SECTIONS:
            if name.startswith(prefix):
                short = name[len(prefix):]
                break
        label_str = ""
        labels = entry.get("labels") or {}
        if labels:
            label_str = " [" + ",".join(
                f"{k}={v}" for k, v in sorted(labels.items())) + "]"
        if entry["kind"] == "histogram":
            p50 = histogram_quantile(entry, 0.5)
            p95 = histogram_quantile(entry, 0.95)
            text = (f"{short}{label_str}: n={_fmt_num(entry['count'])}"
                    + (f" p50={p50 * 1e3:.2f}ms p95={p95 * 1e3:.2f}ms"
                       if p50 is not None else ""))
        elif entry["kind"] == "counter":
            text = f"{short}{label_str}: {_fmt_num(entry['value'])}"
            old = prev_by_key.get(_key(entry))
            if (dt and old is not None and old.get("value") is not None
                    and entry.get("value") is not None):
                rate = (entry["value"] - old["value"]) / dt
                text += f" ({_fmt_num(rate)}/s)"
        else:
            text = f"{short}{label_str}: {_fmt_num(entry['value'])}"
        by_section.setdefault(section, []).append(text)
    for title, _prefix in _SECTIONS + (("other", ""),):
        rows = by_section.get(title)
        if not rows:
            continue
        lines.append(f"-- {title} " + "-" * max(1, 58 - len(title)))
        lines.extend("  " + r for r in rows)
    return "\n".join(lines) + "\n"


_TIER_ORDER = ("server", "relay", "actor", "client", "other")


def render_fleet(doc: dict, prev: dict | None = None) -> str:
    """``/fleet`` document → one merged fleet pane: an alerts
    line, per-tier proc sections, and the fleet-merged metrics grouped
    by the same plane prefixes as the single-process view. Pure
    function (tested without any HTTP)."""
    procs = doc.get("procs", [])
    tiers: dict[str, list[dict]] = {}
    for p in procs:
        tiers.setdefault(p.get("tier", "other"), []).append(p)
    tier_counts = " ".join(f"{t}={len(tiers[t])}" for t in _TIER_ORDER
                           if t in tiers)
    lines = [f"relayrl fleet · {len(procs)} proc(s) · {tier_counts}"
             f" · stale_s {doc.get('stale_s')}"
             f" · {time.strftime('%H:%M:%S')}"]
    alerts = doc.get("alerts") or []
    active = [a for a in alerts if a.get("active")]
    if active:
        parts = ", ".join(
            f"{a['name']}({_fmt_num(a.get('value'))} {a.get('op')} "
            f"{_fmt_num(a.get('threshold'))})" for a in active)
        lines.append(f"ALERTS: {len(active)} active — {parts}")
    else:
        lines.append(f"alerts: none active ({len(alerts)} rule(s) armed)")
    for tier in _TIER_ORDER:
        rows = tiers.get(tier)
        if not rows:
            continue
        lines.append(f"-- {tier} " + "-" * max(1, 58 - len(tier)))
        for p in sorted(rows, key=lambda r: r.get("proc", "")):
            extra = (f" · restarts {p['restarts']}"
                     if p.get("restarts") else "")
            up = p.get("uptime_s")
            lines.append(
                f"  {p.get('proc')} · age {p.get('age_s', '?')}s"
                + (f" · up {up:.0f}s" if isinstance(up, (int, float))
                   else "") + extra)
    merged = doc.get("merged") or {}
    if merged.get("metrics"):
        # No rate column: merged docs carry no shared monotonic clock.
        lines.append("== fleet merged " + "=" * 47)
        lines.append(render(dict(merged, enabled=True, run_id="fleet",
                                 uptime_s=0.0)).split("\n", 1)[1])
    return "\n".join(lines).rstrip("\n") + "\n"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m relayrl_tpu_torch.telemetry.top",
        description="one-screen live summary of a relayrl telemetry "
                    "endpoint")
    parser.add_argument("--url", default="http://127.0.0.1:9100",
                        help="exporter base URL (default %(default)s)")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="refresh seconds (default %(default)s)")
    parser.add_argument("--once", action="store_true",
                        help="print one frame and exit")
    parser.add_argument("--fleet", action="store_true",
                        help="render the ROOT server's merged fleet pane "
                             "(/fleet: per-tier proc sections, alerts "
                             "line, fleet-merged metrics) instead of the "
                             "single-process /snapshot view")
    args = parser.parse_args(argv)
    endpoint = "fleet" if args.fleet else "snapshot"
    prev = None
    try:
        while True:
            try:
                snapshot = (fetch_fleet(args.url) if args.fleet
                            else fetch_snapshot(args.url))
            except (urllib.error.URLError, OSError, ValueError) as e:
                print(f"cannot reach {args.url}/{endpoint}: {e}",
                      file=sys.stderr)
                return 1
            frame = (render_fleet(snapshot, prev) if args.fleet
                     else render(snapshot, prev))
            if args.once:
                sys.stdout.write(frame)
                return 0
            sys.stdout.write("\x1b[2J\x1b[H" + frame)
            sys.stdout.flush()
            prev = snapshot
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
