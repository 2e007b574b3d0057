"""Telemetry contract: metric registrations + journal event kinds.

Extracts every ``counter/gauge/gauge_fn/histogram`` registration site
(its name a string literal, or the first element of a module-level
``(name, help)`` tuple spread into the call) and every journal ``emit``
kind from the package AST, then checks

* naming conventions — ``relayrl_`` prefix (MET01), ``_total`` on
  counters (MET02), a unit suffix on histograms (MET03);
* family coherence — one name registered with two kinds or two bucket
  grids is a scrape-time collision (MET04);
* the docs/observability.md catalog, two ways — undocumented metric
  (MET05), documented-but-gone metric (MET06), kind drift (MET07);
* the event vocabulary — emitted kind missing from ``EVENT_TYPES``
  (EVT01), ``EVENT_TYPES`` entry undocumented (EVT02), documented
  event gone from the vocabulary (EVT03).

The convention checks run everywhere; the doc half degrades to a no-op
when docs/ is absent (installed wheel).
"""

from __future__ import annotations

import ast
import os
import re

from relayrl_tpu_torch.analysis.contracts.base import (
    ContractContext,
    ParsedModule,
    code_spans,
    const_fold,
    first_str,
    iter_md_tables,
)
from relayrl_tpu_torch.analysis.engine import Finding, qualname

_METRIC_FACTORIES = frozenset({"counter", "gauge", "gauge_fn", "histogram"})
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
# Histogram unit suffixes: base units per the prometheus convention,
# plus the repo's own dimensioned units (model versions).
_HISTOGRAM_UNITS = ("_seconds", "_bytes", "_ratio", "_versions")
_KIND_CATEGORY = {"counter": "counter", "gauge": "gauge",
                  "gauge_fn": "gauge", "histogram": "histogram"}

OBSERVABILITY_MD = "observability.md"


class MetricSite:
    def __init__(self, name: str, kind: str, module: ParsedModule,
                 node: ast.Call, buckets: str | None):
        self.name = name
        self.kind = kind
        self.module = module
        self.node = node
        self.buckets = buckets


def _bucket_spec(call: ast.Call) -> str | None:
    """Stable string for a histogram's bucket grid: the preset's dotted
    name, or the folded literal, or ``None`` for the default grid."""
    for kw in call.keywords:
        if kw.arg == "buckets":
            name = qualname(kw.value)
            if name:
                return name.split(".")[-1]
            ok, value = const_fold(kw.value)
            return repr(value) if ok else ast.dump(kw.value)
    return None


def _name_tuples(mod: ParsedModule) -> dict[str, str]:
    """Module-level tuple constants that lead with a string —
    ``_GENERATED = ("relayrl_..._total", "help")`` — by name: a
    registration written ``reg.counter(*_GENERATED)`` takes its metric
    name from the tuple's first element."""
    out: dict[str, str] = {}
    for node in mod.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Tuple)):
            ok, value = const_fold(node.value)
            if ok and value and isinstance(value[0], str):
                out[node.targets[0].id] = value[0]
    return out


def _metric_name(call: ast.Call, tuples: dict[str, str]) -> str | None:
    """The metric name a factory call registers: its first positional
    argument when a string literal, or the first element of a
    module-level tuple constant spread into it (``*_GENERATED``)."""
    name = first_str(call)
    if name is None and call.args and isinstance(call.args[0], ast.Starred) \
            and isinstance(call.args[0].value, ast.Name):
        name = tuples.get(call.args[0].value.id)
    return name


def extract_metrics(ctx: ContractContext) -> list[MetricSite]:
    sites: list[MetricSite] = []
    for mod in ctx.package_modules():
        tuples = _name_tuples(mod)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _METRIC_FACTORIES):
                continue
            name = _metric_name(node, tuples)
            if name is None:
                continue
            sites.append(MetricSite(name, node.func.attr, mod, node,
                                    _bucket_spec(node)))
    sites.sort(key=lambda s: (s.name, s.module.relpath, s.node.lineno))
    return sites


def extract_event_types(ctx: ContractContext) -> tuple[
        list[str], ParsedModule | None, ast.Assign | None]:
    mod = ctx.module(os.path.join("telemetry", "events.py"))
    if mod is None:
        return [], None, None
    for node in mod.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "EVENT_TYPES"):
            ok, value = const_fold(node.value)
            if ok and isinstance(value, tuple):
                return [str(v) for v in value], mod, node
    return [], mod, None


def extract_emit_sites(ctx: ContractContext) -> list[
        tuple[str, ParsedModule, ast.Call]]:
    """Call sites of the journal emit surface with a literal kind:
    ``telemetry.emit(...)`` (the package-level helper) and
    ``<...journal...>.emit(...)``."""
    out: list[tuple[str, ParsedModule, ast.Call]] = []
    for mod in ctx.package_modules():
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "emit"):
                continue
            receiver = qualname(node.func.value) or ""
            resolved = mod.info.resolve(receiver) or receiver
            if not (resolved.endswith("telemetry")
                    or "journal" in receiver.lower()):
                continue
            kind = first_str(node)
            if kind is not None:
                out.append((kind, mod, node))
    return out


def _doc_metric_names(cell: str, known: set[str],
                      prev: list[str]) -> list[tuple[str, str]]:
    """Expand a doc cell's code spans to full metric names. A span may
    be a continuation shorthand (``_send_bytes_total`` after
    ``relayrl_transport_send_total``): expand against the longest
    ``_``-prefix of the previous full name that yields a known metric.
    Returns ``(as_written, full_name)`` pairs."""
    out: list[tuple[str, str]] = []
    for span in code_spans(cell):
        name = span.split("{")[0].strip()
        if not name or " " in name:
            continue
        if name.startswith("relayrl_"):
            out.append((span, name))
            prev.append(name)
            continue
        if name.startswith("_") and prev:
            base = prev[-1].split("_")
            for cut in range(len(base) - 1, 0, -1):
                candidate = "_".join(base[:cut]) + name
                if candidate in known:
                    out.append((span, candidate))
                    prev.append(candidate)
                    break
            else:
                out.append((span, name))  # unresolvable shorthand
    return out


def parse_doc_catalog(ctx: ContractContext, known: set[str]) -> tuple[
        dict[str, tuple[str, int]], dict[str, int], str | None]:
    """The observability.md catalog: ``{metric: (kind, line)}`` from
    every ``| metric | kind | ... |`` table and ``{event: line}`` from
    the ``| event | ... |`` table."""
    if ctx.docs_root is None:
        return {}, {}, None
    path = os.path.join(ctx.docs_root, OBSERVABILITY_MD)
    text = ctx.read_text(path)
    if text is None:
        return {}, {}, None
    metrics: dict[str, tuple[str, int]] = {}
    events: dict[str, int] = {}
    for _heading, header, rows in iter_md_tables(text):
        head0 = header[0].lower() if header else ""
        if head0 == "metric" and len(header) >= 2:
            prev: list[str] = []
            for line_no, cells in rows:
                if len(cells) < 2:
                    continue
                kind_words = cells[1].lower().split()
                kind = next((w for w in kind_words if w in
                             ("counter", "gauge", "histogram")), "")
                for _span, name in _doc_metric_names(cells[0], known, prev):
                    metrics.setdefault(name, (kind, line_no))
        elif head0 == "event":
            for line_no, cells in rows:
                for span in code_spans(cells[0]):
                    if re.match(r"^[a-z][a-z0-9_]*$", span):
                        events.setdefault(span, line_no)
    return metrics, events, ctx.rel(path)


def run(ctx: ContractContext) -> tuple[list[Finding], dict]:
    findings: list[Finding] = []

    def add(code: str, name: str, message: str, **kw) -> None:
        f = ctx.finding(code, name, message, **kw)
        if f is not None:
            findings.append(f)

    sites = extract_metrics(ctx)
    families: dict[str, MetricSite] = {}
    for s in sites:
        if not s.name.startswith("relayrl_"):
            add("MET01", "metric-prefix",
                f"metric `{s.name}` lacks the `relayrl_` namespace prefix "
                f"every scrape consumer filters on",
                module=s.module, node=s.node)
        elif not _NAME_RE.match(s.name):
            add("MET01", "metric-prefix",
                f"metric `{s.name}` is not a lower_snake_case metric name",
                module=s.module, node=s.node)
        if s.kind == "counter" and not s.name.endswith("_total"):
            add("MET02", "counter-suffix",
                f"counter `{s.name}` must end in `_total` (the monotonic-"
                f"family convention rate() consumers rely on)",
                module=s.module, node=s.node)
        if (s.kind == "histogram"
                and not s.name.endswith(_HISTOGRAM_UNITS)):
            add("MET03", "histogram-unit-suffix",
                f"histogram `{s.name}` carries no unit suffix "
                f"({'/'.join(_HISTOGRAM_UNITS)}) — dashboards can't tell "
                f"what the buckets measure",
                module=s.module, node=s.node)
        prior = families.get(s.name)
        if prior is None:
            families[s.name] = s
        else:
            if _KIND_CATEGORY[prior.kind] != _KIND_CATEGORY[s.kind]:
                add("MET04", "metric-family-collision",
                    f"metric `{s.name}` is registered as {s.kind} here but "
                    f"as {prior.kind} at {prior.module.relpath}:"
                    f"{prior.node.lineno} — one family, one kind",
                    module=s.module, node=s.node)
            elif (s.kind == "histogram"
                    and prior.buckets != s.buckets):
                add("MET04", "metric-family-collision",
                    f"histogram `{s.name}` uses bucket grid "
                    f"{s.buckets or 'default'} here but "
                    f"{prior.buckets or 'default'} at "
                    f"{prior.module.relpath}:{prior.node.lineno} — merged "
                    f"snapshots would mix incomparable grids",
                    module=s.module, node=s.node)

    event_types, events_mod, types_node = extract_event_types(ctx)
    emit_sites = extract_emit_sites(ctx)
    event_set = set(event_types)
    for kind, mod, node in emit_sites:
        # the events module itself only defines/forwards the vocabulary
        if events_mod is not None and mod is events_mod:
            continue
        if kind not in event_set:
            add("EVT01", "event-unregistered",
                f"journal event `{kind}` is emitted here but missing from "
                f"telemetry/events.py EVENT_TYPES — the closed vocabulary "
                f"docs and dashboards consume",
                module=mod, node=node)

    doc_metrics, doc_events, doc_path = parse_doc_catalog(
        ctx, set(families))
    if doc_path is not None:
        for name in sorted(families):
            s = families[name]
            if name not in doc_metrics:
                add("MET05", "metric-undocumented",
                    f"metric `{name}` ({s.kind}) is registered here but "
                    f"missing from docs/observability.md's catalog",
                    module=s.module, node=s.node)
            else:
                doc_kind, doc_line = doc_metrics[name]
                if doc_kind and doc_kind != _KIND_CATEGORY[s.kind]:
                    add("MET07", "metric-doc-kind-drift",
                        f"metric `{name}` is a {_KIND_CATEGORY[s.kind]} in "
                        f"code but documented as {doc_kind} "
                        f"({doc_path}:{doc_line})",
                        module=s.module, node=s.node)
        for name in sorted(doc_metrics):
            if name not in families:
                _kind, line = doc_metrics[name]
                add("MET06", "metric-documented-gone",
                    f"docs/observability.md documents `{name}` but no "
                    f"registration site exists — stale docs or a renamed "
                    f"metric", path=doc_path, line=line,
                    snippet=name)
        for kind in event_types:
            if kind not in doc_events and events_mod is not None \
                    and types_node is not None:
                f = ctx.finding(
                    "EVT02", "event-undocumented",
                    f"journal event `{kind}` is in EVENT_TYPES but missing "
                    f"from docs/observability.md's event table",
                    path=events_mod.relpath, line=types_node.lineno,
                    snippet=kind)
                if f is not None:
                    findings.append(f)
        for kind in sorted(doc_events):
            if kind not in event_set:
                add("EVT03", "event-documented-gone",
                    f"docs/observability.md's event table documents "
                    f"`{kind}` but it is not in EVENT_TYPES",
                    path=doc_path, line=doc_events[kind], snippet=kind)

    inventory = {
        "metrics": {
            name: {
                "kind": s.kind,
                "sites": sorted({x.module.relpath for x in sites
                                 if x.name == name}),
                **({"buckets": s.buckets} if s.buckets else {}),
            }
            for name, s in families.items()
        },
        "events": sorted(event_set),
        "emitted_event_kinds": sorted({k for k, _m, _n in emit_sites}),
    }
    return findings, inventory
