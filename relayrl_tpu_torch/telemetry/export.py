"""Telemetry exporter: Prometheus text exposition + JSON snapshot over a
stdlib ``http.server`` thread.

Endpoints (GET):

* ``/metrics``  — Prometheus text exposition format 0.0.4 (the scrape
  surface; conformance locked by tests/test_telemetry.py).
* ``/snapshot`` — the registry's structured JSON snapshot verbatim (the
  schema ``telemetry.top`` and the soak-bench rows consume — one schema
  for live scrapes and committed artifacts).
* ``/healthz``  — liveness stub for probes.

The server is a daemon ``ThreadingHTTPServer`` so a slow scraper never
blocks a second one, and every handler only *reads* a snapshot — the
registry's hot paths (per-thread shard ``+=``) proceed untouched while
an export renders. Device-valued gauges resolve inside the handler
thread (the snapshot contract), so a scrape can fence device work but
the learner/actor threads never do.

A copy of :mod:`relayrl_tpu.telemetry.export`.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_CONTENT_TYPE_PROM = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label_value(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _render_labels(labels: dict, extra: list[tuple[str, str]] = ()) -> str:
    items = [(k, str(v)) for k, v in sorted(labels.items())] + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in items)
    return "{" + body + "}"


def _fmt(value: float | None) -> str:
    if value is None:
        # Snapshot's strict-JSON stand-in for a non-finite value; the
        # text format does allow a NaN literal.
        return "NaN"
    if value == float("inf"):
        return "+Inf"
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return repr(float(value))


def render_prometheus(snapshot: dict) -> str:
    """Registry snapshot → Prometheus text exposition.

    Conformance points the tests pin: one ``# HELP``/``# TYPE`` pair per
    metric family (not per labeled child), histogram children named
    ``<name>_bucket`` with CUMULATIVE ``le`` counts ending at ``+Inf``,
    plus ``<name>_sum``/``<name>_count``, and a trailing newline."""
    families: dict[str, list[dict]] = {}
    order: list[str] = []
    for entry in snapshot.get("metrics", []):
        name = entry["name"]
        if name not in families:
            families[name] = []
            order.append(name)
        families[name].append(entry)
    lines: list[str] = []
    for name in order:
        children = families[name]
        help_text = next((c["help"] for c in children if c.get("help")), "")
        kind = children[0]["kind"]
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        for child in children:
            labels = child.get("labels", {})
            if child["kind"] == "histogram":
                cumulative = 0
                bounds = list(child["buckets"]) + [float("inf")]
                for bound, count in zip(bounds, child["counts"]):
                    cumulative += count
                    lines.append(
                        f"{name}_bucket"
                        f"{_render_labels(labels, [('le', _fmt(bound))])}"
                        f" {cumulative}")
                lines.append(
                    f"{name}_sum{_render_labels(labels)} "
                    f"{_fmt(child['sum'])}")
                lines.append(
                    f"{name}_count{_render_labels(labels)} {child['count']}")
            else:
                lines.append(
                    f"{name}{_render_labels(labels)} {_fmt(child['value'])}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    # set per-server via the factory in TelemetryExporter
    registry = None
    # Fleet aggregation (telemetry/aggregate.py): the root training
    # server installs its FleetTable (+ AlertEngine) via
    # TelemetryExporter.set_fleet, enabling /fleet and /fleet/metrics.
    fleet = None
    alerts = None

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            body = render_prometheus(self.registry.snapshot()).encode()
            self._reply(200, _CONTENT_TYPE_PROM, body)
        elif path == "/fleet":
            fleet = type(self).fleet
            if fleet is None:
                self._reply(404, "application/json",
                            b'{"error": "no fleet table on this process '
                            b'(telemetry.fleet_interval_s off, or not the '
                            b'root server)"}\n')
                return
            body = json.dumps(fleet.document(alerts=type(self).alerts),
                              allow_nan=False).encode()
            self._reply(200, "application/json", body)
        elif path == "/fleet/metrics":
            fleet = type(self).fleet
            if fleet is None:
                self._reply(404, "text/plain", b"no fleet table\n")
                return
            self._reply(200, _CONTENT_TYPE_PROM,
                        fleet.prometheus_text().encode())
        elif path == "/snapshot":
            # allow_nan=False is a tripwire, not a formatter: the
            # snapshot contract already nulls non-finite values.
            body = json.dumps(self.registry.snapshot(),
                              allow_nan=False).encode()
            self._reply(200, "application/json", body)
        elif path == "/traces":
            # The distributed-tracing flight recorder (telemetry/
            # trace.py): the process tracer's live span ring. Served
            # even when tracing is disabled (an empty, enabled=false
            # document) so fleet pollers need no probe-then-fetch dance.
            from relayrl_tpu_torch.telemetry import trace as _trace

            body = json.dumps(_trace.traces_document(),
                              allow_nan=False).encode()
            self._reply(200, "application/json", body)
        elif path == "/healthz":
            self._reply(200, "text/plain", b"ok\n")
        else:
            self._reply(404, "text/plain", b"not found\n")

    def _reply(self, code: int, ctype: str, body: bytes) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper hung up mid-reply; nothing to clean up

    def log_message(self, fmt, *args):
        pass  # scrape chatter must not pollute training logs


class TelemetryExporter:
    """HTTP exporter bound to one registry. ``port=0`` binds an ephemeral
    port (tests, multi-process fleets on one host); read the resolved
    one from :attr:`port`."""

    def __init__(self, registry, port: int = 0, host: str = "127.0.0.1"):
        self.registry = registry
        handler = type("_BoundHandler", (_Handler,), {"registry": registry})
        self._httpd = ThreadingHTTPServer((host, int(port)), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="telemetry-exporter",
            daemon=True)
        self._thread.start()
        # The journal is the discoverable record of ephemeral ports: a
        # fleet operator greps `telemetry_exporter` events instead of
        # scraping stdout for per-process bind lines.
        from relayrl_tpu_torch import telemetry

        telemetry.emit("telemetry_exporter", url=self.url,
                       pid=os.getpid())

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def set_fleet(self, fleet, alerts=None) -> None:
        """Install the fleet table (+ alert engine) behind ``/fleet`` and
        ``/fleet/metrics``. Called by the root training server AFTER the
        exporter is up (construction order: telemetry serves first, the
        fleet plane builds later)."""
        handler = self._httpd.RequestHandlerClass
        handler.fleet = fleet
        handler.alerts = alerts

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


__all__ = ["TelemetryExporter", "render_prometheus"]
