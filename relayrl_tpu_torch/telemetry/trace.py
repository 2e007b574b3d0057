"""End-to-end distributed tracing: per-trajectory and per-model-version
span propagation with critical-path attribution.

The metrics plane (``telemetry/core.py``) answers "how fast is each
stage"; this module answers "where did THIS trajectory's 40 ms go" and
"why did this actor swap version N late" — the cross-process causal view
Podracer-style disaggregated designs (arXiv:2104.06272) and dataflow RL
systems (MindSpeed RL, arXiv:2507.19017) treat as a first-class
debugging surface.

Two trace kinds, both sampled at ``telemetry.trace_sample_rate``:

* ``traj`` — one sampled trajectory, traced **upstream** from env-step /
  window production through columnar encode, spool/send, (relay
  batch-forward,) server ingest, dedup, staging decode, and the update
  dispatch that consumed it. The trace context rides the wire as a
  suffix on the envelope agent id — ``<agent>#t<ctx>#s<seq>`` — beside
  the spool's ``#s`` seq tag, so zmq/grpc/native and relay hops all
  carry it without a new wire version (the native C++ core carries
  envelope ids verbatim; RLD1 frames and RLB1 containers are untouched).
* ``model`` — one sampled model version, traced **downstream** from
  learner dispatch through fence, wire-v2 encode, publish, (relay
  re-broadcast,) actor receipt, and swap. No wire context is needed:
  every process samples versions with the same deterministic hash
  (:meth:`Tracer.sample_version`), so all hops of a sampled version
  record spans independently and the analyzer joins them by version.

Spans land in a bounded in-memory flight recorder (``telemetry.
trace_ring`` entries, oldest evicted) and are exported three ways:

* NDJSON — every span also lands in the events journal as a
  ``trace_span`` event (rotation-bounded, ``telemetry.events_max_bytes``);
* ``/traces`` on the telemetry exporter — the live ring as JSON;
* Chrome-trace JSON (:func:`to_chrome_trace`) loadable in
  ``chrome://tracing`` / Perfetto.

On top sits the critical-path analyzer::

    python -m relayrl_tpu_torch.telemetry.trace events.ndjson [--url http://...]
        [--json] [--chrome out.json]

which reduces sampled traces to per-hop latency attribution plus the two
numbers the metrics plane cannot produce: end-to-end **data age**
(env-step → consumed-by-update) and **model age** (dispatch →
applied-at-actor) distributions. The same ages are observed live into
``relayrl_trace_data_age_seconds`` / ``relayrl_trace_model_age_seconds``
(surfaced by ``telemetry.top``).

Clock discipline: every stamp is CLOCK_MONOTONIC ``monotonic_ns()`` —
comparable across processes on ONE host. Cross-host pairs inherit the
exporter's skew guard: an age
outside ``[0, 300 s)`` is dropped as skew, never observed, and the
analyzer applies the same bound when joining spans from different
journals. Disabled mode is a shared :data:`NULL_TRACER` whose every
surface is a no-op attribute call — the instrumented sites cost one
``.enabled`` check.

A copy of :mod:`relayrl_tpu.telemetry.trace`: the wire context and the
version-sampling hash agree with the JAX package's bit for bit, so a mixed
fleet joins its spans by trace id.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from relayrl_tpu_torch.transport.base import (  # noqa: F401 (re-exported)
    split_agent_trace,
    tag_agent_trace,
)

# Upstream (trajectory) hops in causal order; the analyzer sorts by this.
TRAJ_HOPS = ("env", "encode", "send", "relay", "ingest", "dedup",
             "staging", "update")
# Downstream (model-version) hops in causal order.
MODEL_HOPS = ("dispatch", "fence", "encode", "publish", "relay",
              "receipt", "swap")
# Serving / RLHF stage hops (self-contained per-plane attribution).
SERVE_HOPS = ("queue", "dispatch")
RLHF_HOPS = ("generate", "score", "emit")

_HOP_ORDER = {h: i for i, h in enumerate(TRAJ_HOPS)}
_MODEL_ORDER = {h: i for i, h in enumerate(MODEL_HOPS)}

# The cross-host monotonic skew guard, in ns: CLOCK_MONOTONIC is
# per-boot, so cross-host pairs are off by the uptime delta in EITHER
# direction; nothing on these planes legitimately takes 300 s.
SKEW_GUARD_NS = int(300e9)


class TrajCtx:
    """The trajectory trace context that rides the wire: a trace id plus
    the origin stamps the server needs to compute data age (born_ns,
    CLOCK_MONOTONIC at env-step/window production) and version lag
    (born_version, the params version the data was generated under)."""

    __slots__ = ("trace_id", "born_ns", "born_version")

    def __init__(self, trace_id: str, born_ns: int, born_version: int):
        self.trace_id = trace_id
        self.born_ns = int(born_ns)
        self.born_version = int(born_version)

    def encode(self) -> str:
        """Wire form (the ``#t`` tag payload): three dot-separated hex
        fields — compact, and strictly validated on split so an agent id
        that happens to contain ``#t`` can never be misparsed."""
        return (f"{self.trace_id}.{self.born_ns:x}."
                f"{self.born_version & 0xFFFFFFFFFFFF:x}")

    _ID_CHARS = frozenset("0123456789abcdef-")

    @classmethod
    def decode(cls, text: str) -> "TrajCtx | None":
        parts = text.split(".")
        if len(parts) != 3 or not parts[0] \
                or not set(parts[0]) <= cls._ID_CHARS:
            return None
        try:
            return cls(parts[0], int(parts[1], 16), int(parts[2], 16))
        except ValueError:
            return None


def model_trace_id(version: int) -> str:
    return f"v{int(version)}"


class SpanRecorder:
    """Bounded in-memory flight recorder: the newest ``capacity`` spans,
    oldest evicted (a ring, not a leak — soak-length runs stay bounded
    no matter the sample rate)."""

    def __init__(self, capacity: int = 4096):
        self._spans: deque[dict] = deque(maxlen=max(16, int(capacity)))
        self._lock = threading.Lock()

    def record(self, span: dict) -> None:
        with self._lock:
            self._spans.append(span)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


class Tracer:
    """The live tracing surface: sampling decisions, span recording,
    and the data-age/model-age histograms. One per process, installed by
    :func:`configure` (telemetry's ``configure_from_config`` does it when
    ``telemetry.trace_sample_rate > 0``)."""

    enabled = True

    def __init__(self, sample_rate: float, ring: int = 4096,
                 proc: str | None = None, journal: bool = True):
        from relayrl_tpu_torch import telemetry
        from relayrl_tpu_torch.telemetry.core import AGE_BUCKETS

        self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
        self.recorder = SpanRecorder(ring)
        self.proc = proc or f"pid{os.getpid()}"
        # Wire-safe trace-id prefix: the ctx tag's validator admits
        # lowercase hex + '-' only (transport.base.split_agent_trace).
        self._id_prefix = f"{os.getpid():x}"
        self.journal = bool(journal)
        self._sample_lock = threading.Lock()
        self._accum = 0.0
        self._seq = 0
        reg = telemetry.get_registry()
        self._m_spans = reg.counter(
            "relayrl_trace_spans_total",
            "trace spans recorded into the flight recorder")
        self._m_sampled = reg.counter(
            "relayrl_trace_sampled_total",
            "trajectories that drew a trace context at emission")
        self._m_data_age = reg.histogram(
            "relayrl_trace_data_age_seconds",
            "end-to-end data age of sampled trajectories: env-step/window "
            "production to the update dispatch that consumed them "
            "(same-host monotonic pairs; skew-guarded)",
            buckets=AGE_BUCKETS)
        self._m_model_age = reg.histogram(
            "relayrl_trace_model_age_seconds",
            "model age at the actor: publish stamp to swap-applied "
            "(on_model return) for sampled versions; the analyzer adds "
            "the server-side dispatch→publish spans for the full "
            "dispatch→applied distribution",
            buckets=AGE_BUCKETS)
        self._m_data_lag = reg.histogram(
            "relayrl_trace_data_age_versions",
            "data age in model versions: consuming update's dispatched "
            "version minus the version the trajectory was generated "
            "under (the trace-context twin of "
            "relayrl_rlhf_train_lag_versions)",
            buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0))

    # -- sampling --
    def _draw(self) -> int | None:
        """Stride sampling: deterministic, rate-exact over any window
        (every ceil(1/rate)-th draw fires) — reproducible in tests and
        cheap (one lock at trajectory granularity, never per step).
        Returns this draw's unique sequence number, or None. The seq is
        minted UNDER the lock — two threads that both fire must never
        share an id, or the analyzer would join their traces."""
        if self.sample_rate <= 0.0:
            return None
        with self._sample_lock:
            self._accum += self.sample_rate
            if self._accum >= 1.0:
                self._accum -= 1.0
                self._seq += 1
                return self._seq
            return None

    def sample_traj(self, born_ns: int, born_version: int) -> TrajCtx | None:
        """Per-trajectory sampling decision at emission time; the
        returned context rides the wire (``tag_agent_trace``)."""
        seq = self._draw()
        if seq is None:
            return None
        self._m_sampled.inc()
        return TrajCtx(f"{self._id_prefix}-{seq:x}", born_ns, born_version)

    def sample_id(self, kind: str) -> str | None:
        """Per-event sampling for self-contained planes (serving
        requests, RLHF stage rounds): a trace id, or None."""
        seq = self._draw()
        if seq is None:
            return None
        return f"{kind}-{self._id_prefix}-{seq:x}"

    def sample_version(self, version: int) -> bool:
        """Deterministic per-version sampling for the downstream model
        trace: every process running the same rate samples the SAME
        version set, so dispatch/publish/relay/receipt/swap hops record
        independently with no wire context. Version 0 (the handshake
        model) is never sampled."""
        rate = self.sample_rate
        if rate <= 0.0 or version <= 0:
            return False
        if rate >= 1.0:
            return True
        import hashlib

        digest = hashlib.blake2b(str(int(version)).encode(),
                                 digest_size=4).digest()
        return int.from_bytes(digest, "little") < int(rate * 2**32)

    # -- recording --
    def span(self, kind: str, trace_id: str, hop: str, t0_ns: int,
             t1_ns: int, **fields) -> None:
        rec = {"kind": kind, "trace": trace_id, "hop": hop,
               "proc": self.proc, "t0_ns": int(t0_ns), "t1_ns": int(t1_ns)}
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        self.recorder.record(rec)
        self._m_spans.inc()
        if self.journal:
            from relayrl_tpu_torch import telemetry

            telemetry.emit("trace_span", **rec)

    def observe_data_age(self, age_s: float,
                         lag_versions: int | None = None) -> None:
        self._m_data_age.observe(age_s)
        if lag_versions is not None and lag_versions >= 0:
            self._m_data_lag.observe(float(lag_versions))

    def observe_model_age(self, age_s: float) -> None:
        self._m_model_age.observe(age_s)

    def snapshot(self) -> list[dict]:
        return self.recorder.snapshot()


class NullTracer:
    """Disabled mode: every surface is a no-op attribute call; sites
    gate their clock reads on ``.enabled`` so the hot paths stay
    untouched."""

    enabled = False
    sample_rate = 0.0
    proc = None

    def sample_traj(self, born_ns: int, born_version: int):
        return None

    def sample_id(self, kind: str):
        return None

    def sample_version(self, version: int) -> bool:
        return False

    def span(self, *args, **fields) -> None:
        pass

    def observe_data_age(self, age_s, lag_versions=None) -> None:
        pass

    def observe_model_age(self, age_s) -> None:
        pass

    def snapshot(self) -> list[dict]:
        return []


NULL_TRACER = NullTracer()
_tracer: Tracer | NullTracer = NULL_TRACER


def get_tracer() -> Tracer | NullTracer:
    """The process tracer (the shared :data:`NULL_TRACER` until
    configured). Instrumented sites call this per *trajectory/publish*,
    never per step."""
    return _tracer


def configure(sample_rate: float, ring: int = 4096,
              proc: str | None = None,
              journal: bool = True) -> Tracer | NullTracer:
    """Install the process tracer (idempotent against re-configure with
    rate 0 — a live tracer is never replaced by a null one so late
    config-bearing components can't disable an explicitly-enabled
    trace). Rate 0 leaves the null tracer in place."""
    global _tracer
    if float(sample_rate) <= 0.0:
        return _tracer
    _tracer = Tracer(sample_rate, ring=ring, proc=proc, journal=journal)
    return _tracer


def reset_for_tests() -> None:
    global _tracer
    _tracer = NULL_TRACER


def snapshot_spans() -> list[dict]:
    """The live flight-recorder ring (drills, tests, embedders)."""
    return _tracer.snapshot()


def traces_document() -> dict:
    """The ``/traces`` endpoint body: the live flight-recorder ring."""
    tr = _tracer
    return {
        "schema": "relayrl-trace-v1",
        "enabled": tr.enabled,
        "proc": tr.proc,
        "sample_rate": getattr(tr, "sample_rate", 0.0),
        "spans": tr.snapshot(),
    }


def record_model_receipt(version: int, rx_ns: int, pub_ns: int | None,
                         backend: str) -> None:
    """Shared actor-transport hook, called right after ``on_model``
    returns (zmq/grpc/native deliver sites): records the ``receipt``
    hop span for sampled versions (receipt stamp → swap-applied) and
    observes model age when the frame carried the publisher's monotonic
    stamp — same skew guard as the receipt-latency histogram."""
    tr = _tracer
    if not tr.enabled:
        return
    done = time.monotonic_ns()
    if tr.sample_version(version):
        tr.span("model", model_trace_id(version), "receipt", rx_ns, done,
                backend=backend, version=int(version))
    if pub_ns is not None and 0 <= done - pub_ns < SKEW_GUARD_NS:
        tr.observe_model_age((done - pub_ns) / 1e9)


def split_ctx(agent_id: str) -> tuple[str, TrajCtx | None]:
    """Strip + decode a ``#t`` trace tag from an (already seq-stripped)
    envelope id. Unconditional on the server ingest path — like the seq
    tag, the trace tag must never leak into attribution even when this
    process traces nothing."""
    base, text = split_agent_trace(agent_id)
    if text is None:
        return agent_id, None
    ctx = TrajCtx.decode(text)
    return (base, ctx) if ctx is not None else (agent_id, None)


# -- Chrome-trace export ----------------------------------------------------

_CORE_KEYS = ("kind", "trace", "hop", "proc", "t0_ns", "t1_ns")


def to_chrome_trace(spans: list[dict]) -> dict:
    """Spans → Chrome Trace Event JSON (``chrome://tracing`` /
    Perfetto): complete ("X") events, microsecond timestamps, one pid
    row per process, one tid row per trace."""
    events = []
    for s in spans:
        t0 = int(s.get("t0_ns", 0))
        t1 = max(t0, int(s.get("t1_ns", t0)))
        events.append({
            "name": s.get("hop", "?"),
            "cat": s.get("kind", "?"),
            "ph": "X",
            "ts": t0 / 1e3,
            "dur": max(0.001, (t1 - t0) / 1e3),
            "pid": s.get("proc", "?"),
            "tid": s.get("trace", "?"),
            "args": {k: v for k, v in s.items() if k not in _CORE_KEYS},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- critical-path analyzer -------------------------------------------------

def spans_from_events(events: list[dict]) -> list[dict]:
    """``trace_span`` journal records → span dicts (the journal adds
    run_id/t_unix/mono_ns around the span fields; strip the envelope)."""
    out = []
    for e in events:
        if e.get("event") != "trace_span":
            continue
        span = {k: v for k, v in e.items()
                if k not in ("event", "run_id", "t_unix", "mono_ns")}
        if "t0_ns" in span and "t1_ns" in span:
            out.append(span)
    return out


def load_spans(paths: list[str] = (), urls: list[str] = ()) -> list[dict]:
    """Gather spans from NDJSON journals (``trace_span`` events) and/or
    live ``/traces`` endpoints, deduplicated (a span may sit in both the
    ring and the journal)."""
    from relayrl_tpu_torch.telemetry.events import read_events

    spans: list[dict] = []
    for path in paths:
        spans.extend(spans_from_events(read_events(path)))
    for url in urls:
        import urllib.request

        with urllib.request.urlopen(url.rstrip("/") + "/traces",
                                    timeout=10.0) as resp:
            doc = json.loads(resp.read().decode())
        spans.extend(doc.get("spans", []))
    seen = set()
    unique = []
    for s in spans:
        key = (s.get("kind"), s.get("trace"), s.get("hop"),
               s.get("proc"), s.get("t0_ns"),
               s.get("actor") or s.get("agent") or s.get("backend"))
        if key in seen:
            continue
        seen.add(key)
        unique.append(s)
    return unique


def _dist(values: list[float]) -> dict:
    if not values:
        return {"count": 0}
    vs = sorted(values)

    def pct(q: float) -> float:
        return vs[min(len(vs) - 1, int(q * len(vs)))]

    return {"count": len(vs), "mean": sum(vs) / len(vs),
            "p50": pct(0.5), "p95": pct(0.95), "max": vs[-1]}


def _sort_hops(spans: list[dict], order: dict) -> list[dict]:
    return sorted(spans, key=lambda s: (order.get(s["hop"], 99),
                                        s["t0_ns"]))


def analyze(spans: list[dict]) -> dict:
    """Reduce spans to critical-path attribution.

    * per-hop latency: total/mean/p95 span duration by (kind, hop);
    * trajectory traces: completeness (saw env AND update), data-age
      seconds + version lag per complete trace, inter-hop gap share;
    * model traces: model age (dispatch t0 → each swap t1) per
      (version, actor) pair — one version swapping on N actors yields N
      ages — plus distinct-actor and relay-hop counts.

    Cross-process joins apply the same-host skew guard: a negative or
    >300 s delta is dropped as clock skew, counted in ``skew_dropped``.
    """
    by_hop: dict[tuple, list[float]] = {}
    traj: dict[str, list[dict]] = {}
    model: dict[str, list[dict]] = {}
    for s in spans:
        kind = s.get("kind")
        dur = max(0, int(s["t1_ns"]) - int(s["t0_ns"])) / 1e9
        by_hop.setdefault((kind, s["hop"]), []).append(dur)
        if kind == "traj":
            traj.setdefault(s["trace"], []).append(s)
        elif kind == "model":
            model.setdefault(s["trace"], []).append(s)

    data_ages, data_lags = [], []
    gaps = []
    skew_dropped = 0
    complete_traj = 0
    for tid, ss in traj.items():
        hops = _sort_hops(ss, _HOP_ORDER)
        env = next((h for h in hops if h["hop"] == "env"), None)
        upd = next((h for h in reversed(hops) if h["hop"] == "update"),
                   None)
        if env is None or upd is None:
            continue
        age_ns = int(upd["t1_ns"]) - int(env["t0_ns"])
        if not (0 <= age_ns < SKEW_GUARD_NS):
            skew_dropped += 1
            continue
        complete_traj += 1
        data_ages.append(age_ns / 1e9)
        if "version" in upd and "version" in env:
            data_lags.append(max(0, int(upd["version"])
                                 - int(env["version"])))
        span_total = sum(max(0, h["t1_ns"] - h["t0_ns"]) for h in hops)
        gaps.append(max(0.0, (age_ns - span_total) / 1e9))

    model_ages = []
    model_traces = {}
    for tid, ss in model.items():
        hops = _sort_hops(ss, _MODEL_ORDER)
        disp = next((h for h in hops if h["hop"] == "dispatch"), None)
        swaps = [h for h in hops if h["hop"] == "swap"]
        relays = [h for h in hops if h["hop"] == "relay"]
        entry = {"hops": sorted({h["hop"] for h in hops},
                                key=lambda h: _MODEL_ORDER.get(h, 99)),
                 "actors": sorted({h.get("actor", h.get("proc", "?"))
                                   for h in swaps}),
                 "relay_hops": len(relays)}
        model_traces[tid] = entry
        if disp is None:
            continue
        for sw in swaps:
            age_ns = int(sw["t1_ns"]) - int(disp["t0_ns"])
            if 0 <= age_ns < SKEW_GUARD_NS:
                model_ages.append(age_ns / 1e9)
            else:
                skew_dropped += 1

    return {
        "spans": len(spans),
        "per_hop": {
            f"{kind}:{hop}": _dist(vals)
            for (kind, hop), vals in sorted(by_hop.items())
        },
        "trajectories": {
            "traced": len(traj),
            "complete": complete_traj,
            "data_age_s": _dist(data_ages),
            "data_age_versions": _dist([float(v) for v in data_lags]),
            "inter_hop_gap_s": _dist(gaps),
        },
        "models": {
            "traced": len(model),
            "model_age_s": _dist(model_ages),
            "traces": model_traces,
        },
        "skew_dropped": skew_dropped,
    }


def render_report(report: dict) -> str:
    """Analyzer report → operator text (the CLI's default output)."""
    lines = [f"trace analysis · {report['spans']} spans"]
    lines.append("-- per-hop latency "
                 + "-" * 41)
    for key, dist in report["per_hop"].items():
        if not dist["count"]:
            continue
        lines.append(
            f"  {key:<18} n={dist['count']:<6} "
            f"mean={dist['mean'] * 1e3:8.3f}ms "
            f"p95={dist['p95'] * 1e3:8.3f}ms")
    tj = report["trajectories"]
    lines.append(f"-- trajectories: {tj['traced']} traced, "
                 f"{tj['complete']} complete "
                 + "-" * 20)
    for label, key in (("data age", "data_age_s"),
                       ("inter-hop gap", "inter_hop_gap_s")):
        d = tj[key]
        if d["count"]:
            lines.append(
                f"  {label:<14} n={d['count']:<6} "
                f"mean={d['mean'] * 1e3:8.3f}ms "
                f"p50={d['p50'] * 1e3:8.3f}ms "
                f"p95={d['p95'] * 1e3:8.3f}ms")
    d = tj["data_age_versions"]
    if d["count"]:
        lines.append(f"  version lag    n={d['count']:<6} "
                     f"mean={d['mean']:.2f} p95={d['p95']:.0f}")
    mo = report["models"]
    lines.append(f"-- model versions: {mo['traced']} traced "
                 + "-" * 28)
    d = mo["model_age_s"]
    if d["count"]:
        lines.append(
            f"  model age      n={d['count']:<6} "
            f"mean={d['mean'] * 1e3:8.3f}ms "
            f"p50={d['p50'] * 1e3:8.3f}ms "
            f"p95={d['p95'] * 1e3:8.3f}ms")
    if report["skew_dropped"]:
        lines.append(f"  skew-dropped pairs: {report['skew_dropped']}")
    return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m relayrl_tpu_torch.telemetry.trace",
        description="critical-path analyzer over relayrl trace spans "
                    "(NDJSON journals and/or live /traces endpoints)")
    parser.add_argument("journals", nargs="*",
                        help="event-journal NDJSON files carrying "
                             "trace_span events")
    parser.add_argument("--url", action="append", default=[],
                        help="telemetry exporter base URL; its /traces "
                             "ring joins the analysis (repeatable)")
    parser.add_argument("--json", action="store_true",
                        help="emit the full report as JSON")
    parser.add_argument("--chrome", metavar="OUT",
                        help="also write a Chrome-trace JSON "
                             "(chrome://tracing / Perfetto)")
    args = parser.parse_args(argv)
    if not args.journals and not args.url:
        parser.error("need at least one journal file or --url")
    spans = load_spans(args.journals, args.url)
    report = analyze(spans)
    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump(to_chrome_trace(spans), f)
        print(f"chrome trace written to {args.chrome} "
              f"({len(spans)} spans)", file=sys.stderr)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render_report(report), end="")
    return 0


__all__ = [
    "TRAJ_HOPS", "MODEL_HOPS", "SERVE_HOPS", "RLHF_HOPS",
    "SKEW_GUARD_NS", "TrajCtx", "SpanRecorder", "Tracer", "NullTracer",
    "NULL_TRACER", "get_tracer", "configure", "reset_for_tests",
    "traces_document", "snapshot_spans", "model_trace_id",
    "record_model_receipt",
    "split_ctx", "tag_agent_trace", "split_agent_trace",
    "to_chrome_trace", "spans_from_events", "load_spans", "analyze",
    "render_report", "main",
]


if __name__ == "__main__":
    import sys

    sys.exit(main())
