"""Fleet telemetry aggregation over the relay tree.

The metrics plane was O(processes): every actor/relay exports
``/metrics`` on an ephemeral port that only ever appears in stdout, so a
1k-actor soak had no single pane of glass. This module makes fleet
rollup a first-class plane of the disaggregated dataflow (RLAX
arXiv:2512.06392, MindSpeed RL arXiv:2507.19017), riding the planes the
tree already has:

* **Snapshot frames** — a versioned compact wire frame (``RLS1`` magic +
  msgpack) carrying one or more per-process *sections*: proc identity,
  tier, process epoch, frame seq, and the registry's ``/snapshot``
  document verbatim. Frames ship through the ordinary trajectory
  transport beside trajectories (no new socket): the envelope id is the
  untagged ``@fleet/<proc>`` marker, the payload is sniffed by magic at
  every ingest funnel exactly like columnar ``RLD1`` frames.
* **Merge semantics** — :func:`merge_snapshots` is THE one merge
  implementation:
  counters sum, gauges keep min/max/sum/count across procs (the
  per-proc latest lives in the fleet table), histograms sum bucket-wise
  (the shared bucket presets make grids compatible; mismatches are
  counted, never mixed). Merging is commutative and associative by
  construction — a merged document can be merged again.
* **Fleet table** — the root's per-proc store. Counter merging is
  EPOCH-AWARE: when a process restarts (its registry's ``created_unix``
  epoch bumps) the old epoch's counter values fold into a per-proc
  baseline, so a restarted process never makes a fleet counter go
  backwards. Procs that stop reporting evict after
  ``telemetry.fleet_stale_s``.
* **Relay fan-in** — a relay buffers its subtree's frames
  (:class:`FleetRelayBuffer`, latest-per-proc, epoch/seq ordered) and
  forwards ONE multi-proc frame per interval with every section
  verbatim, so root ingest cost is O(relays) exactly like the model
  plane. Sections are never re-stamped: the root's epoch logic needs
  the leaf's own epoch/seq.
* **SLO alerts** — declarative ``telemetry.alerts`` rules (metric
  selector, aggregation, threshold, ``for_s`` hold-down) evaluated over
  the merged snapshot each interval at the root, emitting
  ``alert_fired``/``alert_resolved`` journal events and
  ``relayrl_alert_active{rule}`` gauges. :func:`default_alert_rules`
  ships the stock pack (drops, open breakers, guardrail halt,
  non-finite publish blocked, ingest queue depth, trace data-age p95).

Consume at the root: ``GET /fleet`` (JSON), ``GET /fleet/metrics``
(Prometheus text with ``proc``/``tier`` labels), or
``python -m relayrl_tpu_torch.telemetry.top --fleet``.

A copy of :mod:`relayrl_tpu.telemetry.aggregate`: the frames are byte-equal
to the JAX package's, so either package's root reads the other's
processes. ``msgpack`` is imported by the functions that encode or decode a
frame, never at import.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, Mapping

# -- snapshot frames ---------------------------------------------------------

SNAP_MAGIC = b"RLS1"
FRAME_VERSION = 1

#: Envelope-id prefix for fleet snapshot frames. Untagged on purpose: no
#: ``#s`` seq (telemetry is latest-wins — a replayed stale snapshot is
#: worse than a dropped one, so frames never enter a spool) and no
#: ``#t`` trace context.
FLEET_WIRE_PREFIX = "@fleet/"

#: Seconds a process that sent its closing fleet frame waits, at most, for
#: the frame to leave when its transport closes (``close(drain_s)``): a
#: dropped closing frame leaves its last counts out of the root's totals.
FLEET_DRAIN_S = 5.0

_TIERS = ("server", "relay", "actor", "client", "other")


def fleet_wire_id(proc: str) -> str:
    return f"{FLEET_WIRE_PREFIX}{proc}"


def is_snapshot_frame(payload) -> bool:
    """Cheap magic sniff — the ingest funnels call this on EVERY payload
    (like the columnar ``RLD1`` sniff), so it must be a slice compare."""
    return bytes(payload[:4]) == SNAP_MAGIC


def snapshot_section(snapshot: Mapping, proc: str, tier: str,
                     epoch: float, seq: int) -> dict:
    """One per-process section of a snapshot frame. ``snapshot`` is the
    registry's ``/snapshot`` document verbatim (the one schema
    everywhere); ``epoch`` identifies the process LIFE (the registry's
    ``created_unix`` — a restart mints a new one), ``seq`` orders frames
    within an epoch."""
    return {
        "proc": str(proc),
        "tier": str(tier) if tier in _TIERS else "other",
        "epoch": float(epoch),
        "seq": int(seq),
        "t_unix": time.time(),
        "snapshot": dict(snapshot),
    }


def encode_snapshot_frame(sections: Iterable[Mapping]) -> bytes:
    import msgpack

    return SNAP_MAGIC + msgpack.packb(
        {"v": FRAME_VERSION, "procs": list(sections)}, use_bin_type=True)


def parse_snapshot_frame(payload) -> list[dict]:
    """Frame → sections. Raises ``ValueError`` on anything malformed (the
    transport swallow-classifier's droppable class), including a section
    missing its identity fields — a frame that cannot be attributed to a
    proc cannot be merged."""
    if not is_snapshot_frame(payload):
        raise ValueError("not a snapshot frame (RLS1 magic missing)")
    import msgpack

    try:
        doc = msgpack.unpackb(bytes(payload[4:]), raw=False)
    except Exception as e:  # msgpack raises its own hierarchy
        raise ValueError(f"snapshot frame undecodable: {e!r}") from e
    if not isinstance(doc, dict) or int(doc.get("v", -1)) != FRAME_VERSION:
        raise ValueError("snapshot frame version/shape mismatch")
    sections = doc.get("procs")
    if not isinstance(sections, list):
        raise ValueError("snapshot frame carries no sections")
    out = []
    for s in sections:
        if not isinstance(s, dict) or not s.get("proc") \
                or not isinstance(s.get("snapshot"), dict):
            raise ValueError("snapshot section missing proc/snapshot")
        try:
            s["epoch"] = float(s.get("epoch", 0.0))
            s["seq"] = int(s.get("seq", 0))
        except (TypeError, ValueError) as e:
            raise ValueError(f"snapshot section bad epoch/seq: {e!r}") from e
        out.append(s)
    return out


# -- merge semantics ---------------------------------------------------------

def _canon_key(entry: Mapping) -> tuple:
    labels = entry.get("labels") or {}
    return (entry.get("name"),
            tuple(sorted((str(k), str(v)) for k, v in labels.items())))


def merge_snapshots(snapshots: Iterable[Mapping]) -> dict:
    """Deterministically merge registry ``/snapshot`` documents into one.

    Per (name, labels) family child:

    * **counters** sum (``None`` — the strict-JSON stand-in for a
      non-finite value — contributes nothing);
    * **histograms** sum bucket-wise when the grids match; a grid
      mismatch keeps the first grid and counts the skipped child in
      ``grid_mismatches`` (never mixes incompatible buckets);
    * **gauges** aggregate to ``{value: sum, min, max, sum, count}`` —
      the fleet total plus the spread. Already-merged gauge entries
      (carrying ``count``) fold by their components, which is what makes
      the merge associative: ``merge([merge([a, b]), c]) ==
      merge([a, b, c])``.

    The output is itself snapshot-schema (``metrics`` sorted like
    ``Registry.snapshot``), so every existing consumer — the Prometheus
    renderer, ``histogram_quantile`` — reads it
    unchanged.
    """
    merged: dict[tuple, dict] = {}
    order: list[tuple] = []
    n_snaps = 0
    mismatches = 0
    for snap in snapshots:
        n_snaps += 1
        for m in (snap or {}).get("metrics", []):
            kind = m.get("kind")
            key = _canon_key(m)
            cur = merged.get(key)
            if kind == "counter":
                v = m.get("value")
                if cur is None:
                    cur = {"name": m["name"], "kind": "counter",
                           "labels": dict(m.get("labels") or {}),
                           "value": 0.0}
                    if m.get("help"):
                        cur["help"] = m["help"]
                    merged[key] = cur
                    order.append(key)
                if v is not None:
                    cur["value"] += v
            elif kind == "histogram":
                if cur is None:
                    cur = {"name": m["name"], "kind": "histogram",
                           "labels": dict(m.get("labels") or {}),
                           "buckets": list(m["buckets"]),
                           "counts": list(m["counts"]),
                           "sum": m.get("sum") or 0.0,
                           "count": int(m.get("count") or 0)}
                    if m.get("help"):
                        cur["help"] = m["help"]
                    merged[key] = cur
                    order.append(key)
                elif cur.get("buckets") != list(m["buckets"]):
                    mismatches += 1
                else:
                    for i, c in enumerate(m["counts"]):
                        cur["counts"][i] += c
                    cur["sum"] += m.get("sum") or 0.0
                    cur["count"] += int(m.get("count") or 0)
            elif kind == "gauge":
                # Raw gauge: {value}; merged gauge: {value(sum), min,
                # max, sum, count}. Fold either shape.
                if m.get("count") is not None and "min" in m:
                    g_sum, g_min = m.get("sum"), m.get("min")
                    g_max, g_n = m.get("max"), int(m["count"])
                else:
                    v = m.get("value")
                    if v is None:
                        g_n = 0
                        g_sum = g_min = g_max = None
                    else:
                        g_sum = g_min = g_max = v
                        g_n = 1
                if cur is None:
                    cur = {"name": m["name"], "kind": "gauge",
                           "labels": dict(m.get("labels") or {}),
                           "value": 0.0, "min": None, "max": None,
                           "sum": 0.0, "count": 0}
                    if m.get("help"):
                        cur["help"] = m["help"]
                    merged[key] = cur
                    order.append(key)
                if g_n:
                    cur["sum"] += g_sum
                    cur["count"] += g_n
                    cur["min"] = (g_min if cur["min"] is None
                                  else min(cur["min"], g_min))
                    cur["max"] = (g_max if cur["max"] is None
                                  else max(cur["max"], g_max))
                    cur["value"] = cur["sum"]
    out = [merged[k] for k in order]
    out.sort(key=lambda e: (e["name"], sorted(e["labels"].items())))
    return {
        "schema": "relayrl-telemetry-v1",
        "enabled": True,
        "merged": True,
        "merged_from": n_snaps,
        "grid_mismatches": mismatches,
        "time_unix": time.time(),
        "metrics": out,
    }


def snapshot_metric(snap: Mapping, name: str,
                    labels: Mapping | None = None) -> float | None:
    """One scalar out of a snapshot document, labels matched as a SUBSET
    (instance-distinguishing labels the caller doesn't care about must
    not break the lookup)."""
    want = {str(k): str(v) for k, v in (labels or {}).items()}
    for m in snap.get("metrics", []):
        if m.get("name") != name:
            continue
        have = m.get("labels") or {}
        if all(have.get(k) == v for k, v in want.items()):
            return m.get("value")
    return None


# -- fleet table (root-side per-proc store) ----------------------------------

class _ProcEntry:
    __slots__ = ("proc", "tier", "epoch", "seq", "t_unix", "snapshot",
                 "last_seen", "base", "restarts")

    def __init__(self, section: Mapping, now: float):
        self.proc = section["proc"]
        self.tier = section.get("tier", "other")
        self.epoch = section["epoch"]
        self.seq = section["seq"]
        self.t_unix = section.get("t_unix")
        self.snapshot = section["snapshot"]
        self.last_seen = now
        # Prior-epoch accumulation: key -> ("counter", value) |
        # ("histogram", counts, sum, count). The fleet-counter
        # monotonicity contract across process restarts.
        self.base: dict[tuple, tuple] = {}
        self.restarts = 0


def _fold_base(base: dict, snapshot: Mapping) -> None:
    """Accumulate a finished epoch's cumulative families into ``base``
    (counters AND histograms — both are cumulative and both would
    regress fleet-wide when a restarted process reports from zero)."""
    for m in snapshot.get("metrics", []):
        key = _canon_key(m)
        kind = m.get("kind")
        if kind == "counter":
            v = m.get("value")
            if v is None:
                continue
            old = base.get(key)
            base[key] = ("counter", (old[1] if old else 0.0) + v)
        elif kind == "histogram":
            old = base.get(key)
            counts = list(m["counts"])
            h_sum = m.get("sum") or 0.0
            h_n = int(m.get("count") or 0)
            if old and old[0] == "histogram" and len(old[1]) == len(counts):
                counts = [a + b for a, b in zip(old[1], counts)]
                h_sum += old[2]
                h_n += old[3]
            base[key] = ("histogram", counts, h_sum, h_n,
                         list(m.get("buckets") or ()))


def _effective_snapshot(entry: _ProcEntry) -> dict:
    """The proc's snapshot with prior-epoch baselines added back in.
    Verbatim (no copy, bit-exact) when the proc never restarted — the
    common case, and the acceptance drill's exactness bar."""
    if not entry.base:
        return entry.snapshot
    metrics = []
    seen: set[tuple] = set()
    for m in entry.snapshot.get("metrics", []):
        key = _canon_key(m)
        seen.add(key)
        old = entry.base.get(key)
        if old is None:
            metrics.append(m)
        elif old[0] == "counter" and m.get("kind") == "counter":
            adj = dict(m)
            adj["value"] = (adj.get("value") or 0.0) + old[1]
            metrics.append(adj)
        elif (old[0] == "histogram" and m.get("kind") == "histogram"
                and len(old[1]) == len(m.get("counts") or ())):
            adj = dict(m)
            adj["counts"] = [a + b for a, b in zip(old[1], m["counts"])]
            adj["sum"] = (adj.get("sum") or 0.0) + old[2]
            adj["count"] = int(adj.get("count") or 0) + old[3]
            metrics.append(adj)
        else:
            metrics.append(m)
    # Families the new life never registered (yet) still carry their
    # prior-epoch totals — dropping them would regress the fleet sum.
    for key, old in entry.base.items():
        if key in seen:
            continue
        name, labels = key
        if old[0] == "counter":
            metrics.append({"name": name, "kind": "counter",
                            "labels": dict(labels), "value": old[1]})
        else:
            metrics.append({"name": name, "kind": "histogram",
                            "labels": dict(labels),
                            "buckets": list(old[4]),
                            "counts": list(old[1]), "sum": old[2],
                            "count": old[3]})
    snap = dict(entry.snapshot)
    snap["metrics"] = metrics
    return snap


class FleetTable:
    """The root's fleet store: latest snapshot per proc with epoch-aware
    counter baselines and staleness eviction. Thread-safe — transport
    threads ingest while the fleet tick and exporter handlers read."""

    #: Bounded proc store (the relay subtree-registry precedent): a
    #: forged-frame flood must not grow the table without limit.
    MAX_PROCS = 65536

    def __init__(self, stale_s: float = 15.0, registry=None):
        from relayrl_tpu_torch import telemetry

        reg = registry if registry is not None else telemetry.get_registry()
        self.stale_s = float(stale_s)
        self._lock = threading.Lock()
        self._entries: dict[str, _ProcEntry] = {}
        self._local_seq = 0
        self._m_frames = reg.counter(
            "relayrl_fleet_frames_total",
            "snapshot frames ingested at this table (O(relays) at the "
            "root of a relay tree)")
        self._m_sections = reg.counter(
            "relayrl_fleet_sections_total",
            "per-proc sections ingested (O(procs))")
        self._m_stale_sections = reg.counter(
            "relayrl_fleet_stale_sections_total",
            "sections dropped: out of order (older epoch/seq than the "
            "held one) or past the bounded proc-store cap")
        self._m_evicted = reg.counter(
            "relayrl_fleet_evicted_total",
            "procs evicted after telemetry.fleet_stale_s of silence")
        self._m_restarts = reg.counter(
            "relayrl_fleet_restarts_total",
            "epoch bumps observed (a proc restarted; its prior-epoch "
            "counters folded into the monotonic baseline)")
        # Weak source (the server pull-gauge precedent): the registry is
        # process-global and must not pin a replaced table's proc store.
        import weakref

        wref = weakref.ref(self)
        reg.gauge_fn(
            "relayrl_fleet_procs",
            lambda: (lambda t: None if t is None else t.proc_count())(
                wref()),
            "processes currently reporting in the fleet table")

    def proc_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def ingest_frame(self, payload) -> int:
        """One wire frame (possibly multi-proc, from a relay). Raises
        ``ValueError`` on malformed frames — callers sit behind the
        standard decode-error narrowing."""
        sections = parse_snapshot_frame(payload)
        self._m_frames.inc()
        return self.ingest_sections(sections)

    def ingest_sections(self, sections: Iterable[Mapping],
                        now: float | None = None) -> int:
        now = time.monotonic() if now is None else now
        accepted = 0
        with self._lock:
            for s in sections:
                self._m_sections.inc()
                e = self._entries.get(s["proc"])
                if e is None:
                    if len(self._entries) >= self.MAX_PROCS:
                        self._m_stale_sections.inc()
                        continue
                    self._entries[s["proc"]] = _ProcEntry(s, now)
                    accepted += 1
                    continue
                if s["epoch"] > e.epoch:
                    # Restart: fold the finished life's cumulative
                    # families into the baseline FIRST (the base dict
                    # already carries any earlier epochs), so the fleet
                    # totals never go backwards.
                    _fold_base(e.base, e.snapshot)
                    e.epoch = s["epoch"]
                    e.seq = s["seq"]
                    e.restarts += 1
                    self._m_restarts.inc()
                elif s["epoch"] < e.epoch or s["seq"] < e.seq:
                    self._m_stale_sections.inc()
                    continue
                else:
                    e.seq = s["seq"]
                e.tier = s.get("tier", e.tier)
                e.t_unix = s.get("t_unix", e.t_unix)
                e.snapshot = s["snapshot"]
                e.last_seen = now
                accepted += 1
        return accepted

    def ingest_registry(self, registry, proc: str, tier: str) -> None:
        """Join a LOCAL registry (the root server's own) without a wire
        hop; epoch is the registry's ``created_unix`` like every remote
        section."""
        self._local_seq += 1
        self.ingest_sections([snapshot_section(
            registry.snapshot(), proc, tier,
            getattr(registry, "created_unix", 0.0), self._local_seq)])

    def sweep(self, now: float | None = None) -> list[str]:
        """Evict procs silent past ``stale_s``; returns the evicted proc
        ids (the caller journals them — this module never imports the
        journal so benches can use the table standalone)."""
        now = time.monotonic() if now is None else now
        evicted = []
        with self._lock:
            for proc, e in list(self._entries.items()):
                if now - e.last_seen > self.stale_s:
                    del self._entries[proc]
                    evicted.append(proc)
        if evicted:
            self._m_evicted.inc(len(evicted))
        return evicted

    def procs(self, now: float | None = None) -> list[dict]:
        now = time.monotonic() if now is None else now
        with self._lock:
            entries = sorted(self._entries.values(), key=lambda e: e.proc)
            return [{
                "proc": e.proc,
                "tier": e.tier,
                "epoch": e.epoch,
                "seq": e.seq,
                "restarts": e.restarts,
                "age_s": round(max(0.0, now - e.last_seen), 3),
                "run_id": e.snapshot.get("run_id"),
                "uptime_s": e.snapshot.get("uptime_s"),
            } for e in entries]

    def proc_snapshot(self, proc: str) -> dict | None:
        """One proc's effective (baseline-adjusted) snapshot."""
        with self._lock:
            e = self._entries.get(proc)
            return None if e is None else _effective_snapshot(e)

    def merged(self) -> dict:
        """The fleet-merged snapshot: every proc's effective snapshot in
        sorted-proc order through :func:`merge_snapshots` — one
        deterministic float-addition order, the drill's bit-exactness
        contract."""
        with self._lock:
            snaps = [_effective_snapshot(e) for e in sorted(
                self._entries.values(), key=lambda e: e.proc)]
        return merge_snapshots(snaps)

    def document(self, alerts: "AlertEngine | None" = None) -> dict:
        """The ``/fleet`` JSON document."""
        doc = {
            "schema": "relayrl-fleet-v1",
            "time_unix": time.time(),
            "stale_s": self.stale_s,
            "procs": self.procs(),
            "merged": self.merged(),
        }
        doc["alerts"] = alerts.describe() if alerts is not None else []
        return doc

    def prometheus_text(self) -> str:
        """Per-proc series with ``proc``/``tier`` labels — the merged
        Prometheus scrape surface (``/fleet/metrics``): the grid a
        Prometheus server would itself aggregate across."""
        from relayrl_tpu_torch.telemetry.export import render_prometheus

        with self._lock:
            entries = sorted(self._entries.values(), key=lambda e: e.proc)
            rows = []
            for e in entries:
                for m in _effective_snapshot(e).get("metrics", []):
                    child = dict(m)
                    labels = dict(m.get("labels") or {})
                    labels["proc"] = e.proc
                    labels["tier"] = e.tier
                    child["labels"] = labels
                    rows.append(child)
        return render_prometheus({"metrics": rows})


# -- SLO alert engine --------------------------------------------------------

_ALERT_AGGS = ("sum", "max", "min", "avg", "increase",
               "p50", "p95", "p99", "count")
_ALERT_OPS: dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


class AlertRule:
    """One declarative SLO rule over the merged fleet snapshot.

    ``agg`` picks the reduction over matching children: ``sum``/``max``/
    ``min``/``avg`` for scalars, ``p50``/``p95``/``p99``/``count`` for
    histograms, ``increase`` for counters (delta between consecutive
    evaluations, clamped at 0 — the "is it STILL happening" form that a
    cumulative counter can't express). ``for_s`` is the hold-down: the
    condition must hold continuously that long before the alert fires
    (0 = fire on first observation); resolution is immediate."""

    def __init__(self, name: str, metric: str, agg: str = "sum",
                 op: str = ">", threshold: float = 0.0,
                 for_s: float = 0.0, labels: Mapping | None = None):
        if not name or not metric:
            raise ValueError("alert rule needs name and metric")
        if agg not in _ALERT_AGGS:
            raise ValueError(f"alert {name!r}: agg {agg!r} not in "
                             f"{_ALERT_AGGS}")
        if op not in _ALERT_OPS:
            raise ValueError(f"alert {name!r}: op {op!r} not in "
                             f"{tuple(_ALERT_OPS)}")
        self.name = str(name)
        self.metric = str(metric)
        self.agg = agg
        self.op = op
        self.threshold = float(threshold)
        self.for_s = max(0.0, float(for_s))
        self.labels = {str(k): str(v) for k, v in (labels or {}).items()}

    @classmethod
    def from_dict(cls, d: Mapping) -> "AlertRule":
        allowed = {"name", "metric", "agg", "op", "threshold", "for_s",
                   "labels"}
        unknown = set(d) - allowed
        if unknown:
            raise ValueError(f"alert rule has unknown keys {sorted(unknown)}")
        if "name" not in d or "metric" not in d:
            raise ValueError(f"alert rule needs name and metric, got {d!r}")
        return cls(**{k: d[k] for k in allowed if k in d})

    def describe(self) -> dict:
        return {"name": self.name, "metric": self.metric, "agg": self.agg,
                "op": self.op, "threshold": self.threshold,
                "for_s": self.for_s, "labels": self.labels}


def default_alert_rules() -> list[AlertRule]:
    """The stock rule pack — every signature already has a runbook row
    (docs/operations.md): data loss, a stuck transport, a halted
    learner, blocked non-finite publishes, ingest backlog, stale data
    reaching updates."""
    return [
        AlertRule("ingest_drops", "relayrl_server_dropped_total",
                  agg="increase", op=">", threshold=0.0),
        AlertRule("breaker_open", "relayrl_breaker_state",
                  agg="max", op=">=", threshold=2.0),
        AlertRule("guardrail_halt", "relayrl_guard_halted",
                  agg="max", op=">", threshold=0.0),
        AlertRule("nonfinite_publish_blocked",
                  "relayrl_guard_publish_blocked_total",
                  agg="increase", op=">", threshold=0.0),
        AlertRule("ingest_queue_depth", "relayrl_server_ingest_queue_depth",
                  agg="max", op=">", threshold=50_000.0, for_s=5.0),
        AlertRule("trace_data_age_p95", "relayrl_trace_data_age_seconds",
                  agg="p95", op=">", threshold=60.0, for_s=10.0),
    ]


def rules_from_config(params: Mapping) -> list[AlertRule]:
    """``telemetry.alerts`` + the default pack (unless
    ``telemetry.alerts_default_pack`` is false). A malformed user rule
    warns and is skipped — the alert plane must never take down the
    process it watches. User rules override same-named defaults."""
    import warnings

    rules: dict[str, AlertRule] = {}
    if params.get("alerts_default_pack", True):
        for r in default_alert_rules():
            rules[r.name] = r
    user = params.get("alerts")
    if isinstance(user, (list, tuple)):
        for d in user:
            try:
                r = AlertRule.from_dict(d)
            except (ValueError, TypeError) as e:
                warnings.warn(f"ignoring invalid telemetry.alerts rule "
                              f"{d!r}: {e}")
                continue
            rules[r.name] = r
    return [rules[k] for k in sorted(rules)]


class _RuleState:
    __slots__ = ("active", "pending_since", "last_raw", "last_value")

    def __init__(self):
        self.active = False
        self.pending_since: float | None = None
        self.last_raw: float | None = None
        self.last_value: float | None = None


class AlertEngine:
    """Evaluates rules over consecutive merged snapshots, with journal
    events + per-rule active gauges as the outputs. Single-threaded by
    contract (the root's fleet tick drives it)."""

    def __init__(self, rules: Iterable[AlertRule], registry=None,
                 emit=None):
        from relayrl_tpu_torch import telemetry

        reg = registry if registry is not None else telemetry.get_registry()
        self._emit = emit if emit is not None else telemetry.emit
        self.rules = list(rules)
        self._state = {r.name: _RuleState() for r in self.rules}
        self._gauges = {
            r.name: reg.gauge("relayrl_alert_active",
                              "1 while this SLO alert rule is firing",
                              {"rule": r.name})
            for r in self.rules}
        self._m_fired = reg.counter(
            "relayrl_alerts_fired_total", "alert rule activations")
        self._last_membership: frozenset | None = None
        for g in self._gauges.values():
            g.set(0)

    def _value(self, merged: Mapping, rule: AlertRule) -> float | None:
        matching = [m for m in merged.get("metrics", [])
                    if m.get("name") == rule.metric
                    and all((m.get("labels") or {}).get(k) == v
                            for k, v in rule.labels.items())]
        if not matching:
            return None
        if rule.agg in ("p50", "p95", "p99", "count"):
            hists = [m for m in matching if m.get("kind") == "histogram"]
            if not hists:
                return None
            # Strip labels so children with distinct label sets (e.g.
            # backend=zmq/grpc) pool into ONE distribution for the rule.
            pooled = merge_snapshots(
                [{"metrics": [{**m, "labels": {}} for m in hists]}]
            )["metrics"]
            agg = pooled[0] if pooled else None
            if agg is None or not agg.get("count"):
                return None
            if rule.agg == "count":
                return float(agg["count"])
            from relayrl_tpu_torch.telemetry.top import histogram_quantile

            return histogram_quantile(agg, float(rule.agg[1:]) / 100.0)
        scalars = [m for m in matching
                   if m.get("kind") in ("counter", "gauge")]
        if not scalars:
            return None
        if rule.agg in ("sum", "increase"):
            values = [m.get("value") for m in scalars
                      if m.get("value") is not None]
            return float(sum(values)) if values else None

        # max/min/avg must range over PER-PROC values, and a merged
        # gauge child collapses those into value=sum — but it carries
        # the spread (min/max/sum/count) for exactly this read. A rule
        # like spool_depth max > N must fire on the worst PROCESS, not
        # on the fleet-wide sum of healthy depths.
        def spread(m, field):
            if m.get("kind") == "gauge" and m.get("count") is not None \
                    and field in m:
                return m.get(field)
            return m.get("value")

        if rule.agg == "max":
            values = [spread(m, "max") for m in scalars]
            values = [v for v in values if v is not None]
            return float(max(values)) if values else None
        if rule.agg == "min":
            values = [spread(m, "min") for m in scalars]
            values = [v for v in values if v is not None]
            return float(min(values)) if values else None
        # avg: pooled mean across procs/children where the merged entry
        # knows its sample count; raw entries count 1.
        total = n = 0.0
        for m in scalars:
            if m.get("kind") == "gauge" and m.get("count") is not None:
                if m["count"]:
                    total += m.get("sum") or 0.0
                    n += m["count"]
            elif m.get("value") is not None:
                total += m["value"]
                n += 1
        return float(total / n) if n else None

    def evaluate(self, merged: Mapping, now: float | None = None,
                 membership: Iterable[str] | None = None) -> list[dict]:
        """One evaluation pass; returns the transitions (fired/resolved)
        it made, already journaled and reflected in the gauges.

        ``membership`` (the proc-id set behind ``merged``, passed by the
        fleet tick) guards the ``increase`` rules against table churn: a
        proc evicting drops its whole cumulative counter out of the
        merged sum, and its REJOIN re-adds the lifetime total in one
        step — a delta that would read as an enormous spurious increase.
        On any membership change, increase rules rebaseline (one skipped
        observation) instead of firing on the step."""
        now = time.monotonic() if now is None else now
        rebaseline = False
        if membership is not None:
            current = frozenset(membership)
            rebaseline = (self._last_membership is not None
                          and current != self._last_membership)
            self._last_membership = current
        transitions = []
        for rule in self.rules:
            state = self._state[rule.name]
            value = self._value(merged, rule)
            if rule.agg == "increase":
                raw = value
                if value is None or state.last_raw is None or rebaseline:
                    value = None
                else:
                    value = max(0.0, value - state.last_raw)
                state.last_raw = raw
            state.last_value = value
            firing = (value is not None
                      and _ALERT_OPS[rule.op](value, rule.threshold))
            if firing:
                if state.active:
                    continue
                if state.pending_since is None:
                    state.pending_since = now
                if now - state.pending_since >= rule.for_s:
                    state.active = True
                    state.pending_since = None
                    self._gauges[rule.name].set(1)
                    self._m_fired.inc()
                    self._emit("alert_fired", rule=rule.name,
                               metric=rule.metric, value=value,
                               threshold=rule.threshold)
                    transitions.append({"rule": rule.name,
                                        "event": "alert_fired",
                                        "value": value})
            else:
                state.pending_since = None
                if state.active:
                    state.active = False
                    self._gauges[rule.name].set(0)
                    self._emit("alert_resolved", rule=rule.name,
                               metric=rule.metric)
                    transitions.append({"rule": rule.name,
                                        "event": "alert_resolved"})
        return transitions

    def active(self) -> list[str]:
        return [r.name for r in self.rules if self._state[r.name].active]

    def describe(self) -> list[dict]:
        out = []
        for rule in self.rules:
            state = self._state[rule.name]
            d = rule.describe()
            d["active"] = state.active
            d["value"] = state.last_value
            out.append(d)
        return out


# -- push path: per-process emitter + relay fan-in ---------------------------

class FleetEmitter:
    """Periodic snapshot-frame emitter for one process: every
    ``interval_s`` the registry's snapshot ships as a single-section
    frame through ``send_fn(frame_bytes, wire_id)`` — the caller binds
    its agent transport's ``send_trajectory`` so the frame rides beside
    trajectories on the existing connection. Send failures count and
    never escape (telemetry must not crash the loop it observes)."""

    def __init__(self, send_fn: Callable[[bytes, str], Any], proc: str,
                 tier: str, interval_s: float, registry=None,
                 start: bool = True):
        from relayrl_tpu_torch import telemetry

        self._registry = (registry if registry is not None
                          else telemetry.get_registry())
        self._send_fn = send_fn
        self.proc = str(proc)
        self.tier = str(tier)
        self.interval_s = max(0.05, float(interval_s))
        self.epoch = float(getattr(self._registry, "created_unix", 0.0))
        self._seq = 0
        self._seq_lock = threading.Lock()
        reg = self._registry
        self._m_emitted = reg.counter(
            "relayrl_fleet_frames_emitted_total",
            "snapshot frames this process shipped upstream")
        self._m_errors = reg.counter(
            "relayrl_fleet_emit_errors_total",
            "snapshot-frame sends that failed (dropped; next interval "
            "carries fresher data anyway)")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name=f"fleet-emit-{self.proc}",
                daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.emit_now()

    def emit_now(self) -> bool:
        try:
            with self._seq_lock:
                self._seq += 1
                seq = self._seq
            frame = encode_snapshot_frame([snapshot_section(
                self._registry.snapshot(), self.proc, self.tier,
                self.epoch, seq)])
            self._send_fn(frame, fleet_wire_id(self.proc))
        except Exception:
            self._m_errors.inc()
            return False
        self._m_emitted.inc()
        return True

    def close(self, final: bool = True) -> None:
        """Stop the thread; ``final`` ships one last frame so the root's
        table holds this life's closing totals (the drill's exactness
        fence)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if final:
            self.emit_now()


class FleetRelayBuffer:
    """A relay's subtree fan-in: latest section per proc (epoch, then
    seq ordered — a restarted leaf's fresh epoch replaces the old one),
    drained once per interval into ONE multi-proc frame upstream.
    Sections forward VERBATIM: the root's epoch-aware baselines need
    the leaf's own stamps, so a relay never re-stamps or merges values
    — it compresses FRAME COUNT (O(relays) at the root), not content."""

    MAX_PROCS = 65536  # the FleetTable bound, one hop down

    def __init__(self):
        self._lock = threading.Lock()
        self._latest: dict[str, dict] = {}
        self._dirty: set[str] = set()

    def ingest_frame(self, payload) -> int:
        return self.ingest_sections(parse_snapshot_frame(payload))

    def ingest_sections(self, sections: Iterable[Mapping]) -> int:
        n = 0
        with self._lock:
            for s in sections:
                held = self._latest.get(s["proc"])
                if held is None and len(self._latest) >= self.MAX_PROCS:
                    continue
                if held is not None and (
                        s["epoch"] < held["epoch"]
                        or (s["epoch"] == held["epoch"]
                            and s["seq"] < held["seq"])):
                    continue
                self._latest[s["proc"]] = dict(s)
                self._dirty.add(s["proc"])
                n += 1
        return n

    def drain(self) -> list[dict]:
        """Sections updated since the last drain, sorted by proc. A leaf
        that went quiet is not re-forwarded — root staleness owns
        eviction, and re-sending frozen counters would mask it."""
        with self._lock:
            out = [self._latest[p] for p in sorted(self._dirty)
                   if p in self._latest]
            self._dirty.clear()
        return out

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._latest)


__all__ = [
    "SNAP_MAGIC", "FLEET_WIRE_PREFIX", "fleet_wire_id",
    "is_snapshot_frame", "snapshot_section", "encode_snapshot_frame",
    "parse_snapshot_frame", "merge_snapshots", "snapshot_metric",
    "FleetTable", "AlertRule", "AlertEngine", "default_alert_rules",
    "rules_from_config", "FleetEmitter", "FleetRelayBuffer",
]
