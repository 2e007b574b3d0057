"""Telemetry: the framework's first-class observability subsystem.

Three pieces:

* :mod:`relayrl_tpu_torch.telemetry.core`   — metrics registry (counters,
  gauges, fixed-bucket histograms) with per-thread shards and a null
  registry for disabled mode;
* :mod:`relayrl_tpu_torch.telemetry.export` — Prometheus text + JSON snapshot
  endpoints on a stdlib http.server thread;
* :mod:`relayrl_tpu_torch.telemetry.events` — append-only NDJSON run-event
  journal (publish/swap/register/drop/checkpoint/drain).

Process model: ONE registry + ONE journal per process, owned by this
module. Instrumentation sites (server, pipeline, transports, actors,
epoch logger) call :func:`get_registry` / :func:`emit` at construction
time and hold direct metric references — when telemetry is disabled
those are null objects and the hot-path cost is a single attribute call
(benches/bench_telemetry.py commits the numbers).

Enablement: the first :class:`~relayrl_tpu_torch.config.ConfigLoader`-bearing
component in a process (TrainingServer, Agent, VectorAgent) calls
:func:`configure_from_config`, which reads the ``telemetry.*`` section
(docs/observability.md has the knob table) and installs a real
:class:`~relayrl_tpu_torch.telemetry.core.Registry` + journal once; later
calls are no-ops so a server and an in-process agent can't fight over
it. Embedders and benches can instead install a registry directly with
:func:`set_registry` and serve it with :func:`serve`.

Consume with Prometheus against ``/metrics``, any JSON poller against
``/snapshot``, or the bundled one-screen CLI::

    python -m relayrl_tpu_torch.telemetry.top --url http://127.0.0.1:9100

Distributed tracing (:mod:`~relayrl_tpu_torch.telemetry.trace`, on with
``telemetry.trace_sample_rate > 0``) and fleet aggregation with SLO alerts
(:mod:`~relayrl_tpu_torch.telemetry.aggregate`, on with
``telemetry.fleet_interval_s > 0``) ride the same registry and journal.

A copy of :mod:`relayrl_tpu.telemetry`.
"""

from __future__ import annotations

import threading

from relayrl_tpu_torch.telemetry.core import (  # noqa: F401
    DEFAULT_TIME_BUCKETS,
    NULL_METRIC,
    Counter,
    Gauge,
    GaugeFn,
    Histogram,
    NullRegistry,
    Registry,
)
from relayrl_tpu_torch.telemetry.events import (  # noqa: F401
    EVENT_TYPES,
    EventJournal,
    NullJournal,
    read_events,
)
from relayrl_tpu_torch.telemetry.export import (  # noqa: F401
    TelemetryExporter,
    render_prometheus,
)

_state_lock = threading.Lock()
_registry = NullRegistry()
_journal = NullJournal()
_exporter: TelemetryExporter | None = None
_configured = False
_serve_port: int | None = None
_serve_host = "127.0.0.1"


def get_registry():
    """The process-wide registry (a :class:`NullRegistry` until telemetry
    is enabled). Instrumentation sites call this once at construction
    and keep the metric objects it hands out."""
    return _registry


def set_registry(registry) -> None:
    """Install a registry explicitly (benches, tests, embedders). Marks
    the process configured so a later config-driven component doesn't
    overwrite it."""
    global _registry, _configured
    with _state_lock:
        _registry = registry
        _configured = True


def get_journal():
    return _journal


def set_journal(journal) -> None:
    global _journal
    with _state_lock:
        _journal = journal


def emit(event: str, **fields) -> None:
    """Append one run event to the process journal (no-op when no
    journal is configured). See events.EVENT_TYPES for the vocabulary."""
    _journal.emit(event, **fields)


def configure_from_config(config) -> object:
    """Idempotently configure this process's telemetry from a
    :class:`~relayrl_tpu_torch.config.ConfigLoader` (the ``telemetry.*``
    section). First caller wins; every caller gets the live registry
    back. Does NOT start the HTTP exporter — the component that owns the
    port (the training server) calls :func:`maybe_serve` after this."""
    global _registry, _journal, _configured, _serve_port, _serve_host
    with _state_lock:
        if _configured:
            return _registry
        params = config.get_telemetry_params()
        _configured = True
        if not params.get("enabled"):
            return _registry
        _registry = Registry(run_id=params.get("run_id") or None)
        _serve_port = params.get("port")
        _serve_host = params.get("host", "127.0.0.1")
        events_path = params.get("events_path")
        if events_path:
            try:
                _journal = EventJournal(
                    str(events_path), run_id=_registry.run_id,
                    max_bytes=params.get("events_max_bytes") or 0)
            except OSError as e:
                print(f"[telemetry] event journal unavailable "
                      f"({events_path}): {e!r}", flush=True)
        # Distributed tracing (telemetry/trace.py): sample_rate 0 (the
        # default) leaves the shared null tracer installed — every span
        # site then costs one attribute check.
        rate = params.get("trace_sample_rate") or 0.0
        if rate > 0:
            from relayrl_tpu_torch.telemetry import trace as _trace

            _trace.configure(rate, ring=params.get("trace_ring", 4096))
        return _registry


def serve(port: int = 0, host: str = "127.0.0.1") -> TelemetryExporter:
    """Start (or return) the process exporter for the live registry."""
    global _exporter
    with _state_lock:
        if _exporter is None:
            _exporter = TelemetryExporter(_registry, port=port, host=host)
        return _exporter


def maybe_serve() -> TelemetryExporter | None:
    """Start the exporter iff telemetry was config-enabled with a port.
    Called by the training server (the one component per host expected
    to own ``telemetry.port``); returns None when disabled. A bind
    failure (port already held — two servers on one host, a stale
    process) degrades to metrics-without-exporter with a loud note: the
    observability plane must never take down the process it observes."""
    if not _registry.enabled or _serve_port is None:
        return None
    try:
        exporter = serve(port=int(_serve_port), host=_serve_host)
    except OSError as e:
        print(f"[telemetry] exporter bind failed on "
              f"{_serve_host}:{_serve_port} ({e!r}) — metrics stay "
              f"in-process only (set telemetry.port to a free port, or 0 "
              f"for ephemeral)", flush=True)
        return None
    print(f"[telemetry] serving /metrics and /snapshot at {exporter.url}",
          flush=True)
    return exporter


def shutdown() -> None:
    """Stop the exporter and close the journal (tests / clean exits).
    The registry stays — counters are cumulative for the process life."""
    global _exporter
    with _state_lock:
        if _exporter is not None:
            _exporter.close()
            _exporter = None
        _journal.close()


def reset_for_tests() -> None:
    """Restore pristine disabled state (test isolation only)."""
    global _registry, _journal, _exporter, _configured, _serve_port
    with _state_lock:
        if _exporter is not None:
            _exporter.close()
            _exporter = None
        _journal.close()
        _registry = NullRegistry()
        _journal = NullJournal()
        _configured = False
        _serve_port = None
    from relayrl_tpu_torch.telemetry import trace as _trace

    _trace.reset_for_tests()


__all__ = [
    "Registry", "NullRegistry", "Counter", "Gauge", "GaugeFn", "Histogram",
    "EventJournal", "NullJournal", "TelemetryExporter", "render_prometheus",
    "read_events", "EVENT_TYPES", "DEFAULT_TIME_BUCKETS", "NULL_METRIC",
    "get_registry", "set_registry", "get_journal", "set_journal", "emit",
    "configure_from_config", "serve", "maybe_serve", "shutdown",
    "reset_for_tests",
]
