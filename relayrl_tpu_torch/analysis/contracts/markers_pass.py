"""Pytest-marker mini-contract: tests/ vs pytest.ini, both directions.

The tier-1 gate selects suites with ``-m`` marker expressions; a marker
used in a test file but never registered is silently ignored by that
selection (and warns under ``--strict-markers``), while a registered
marker no test carries is a dead selector in CI configs.

* PYT01 — ``@pytest.mark.X`` used in tests/ but ``X`` is not registered
  in pytest.ini's ``markers =`` section.
* PYT02 — a marker registered in pytest.ini that no test file uses.

Skips cleanly when tests/ or pytest.ini is absent (installed wheel).
"""

from __future__ import annotations

import ast
import os
import re

from relayrl_tpu_torch.analysis.contracts.base import ContractContext
from relayrl_tpu_torch.analysis.engine import (
    Finding,
    _suppressed_rules,
    iter_python_files,
    qualname,
    statement_end_line,
)

# pytest's own markers: always registered, never in pytest.ini.
_BUILTIN_MARKERS = frozenset({
    "parametrize", "skip", "skipif", "xfail", "usefixtures",
    "filterwarnings", "tryfirst", "trylast",
})

_MARKER_LINE_RE = re.compile(r"^\s+([A-Za-z_][A-Za-z0-9_]*)\s*:")


def parse_registered_markers(ctx: ContractContext) -> dict[str, int]:
    """``{marker: 1-based line}`` from pytest.ini's ``markers=`` block."""
    if ctx.pytest_ini is None:
        return {}
    text = ctx.read_text(ctx.pytest_ini)
    if text is None:
        return {}
    markers: dict[str, int] = {}
    in_block = False
    for i, line in enumerate(text.splitlines(), start=1):
        stripped = line.strip()
        if re.match(r"^markers\s*=", stripped):
            in_block = True
            continue
        if in_block:
            m = _MARKER_LINE_RE.match(line)
            if m:
                markers.setdefault(m.group(1), i)
            elif stripped and not line[:1].isspace():
                in_block = False
    return markers


def extract_used_markers(ctx: ContractContext) -> dict[
        str, list[tuple[str, list[str], ast.AST]]]:
    """``{marker: [(relpath, source_lines, node), ...]}`` for every
    ``pytest.mark.X`` attribute in tests/ (decorators, ``pytestmark``
    assignments, inline ``request.applymarker`` — any attribute walk)."""
    used: dict[str, list[tuple[str, list[str], ast.AST]]] = {}
    if ctx.tests_root is None:
        return used
    for path in iter_python_files(ctx.tests_root):
        source = ctx.read_text(path)
        if source is None:
            continue
        try:
            tree = ast.parse(source)
        except SyntaxError:
            continue
        lines = source.splitlines()
        rel = ctx.rel(path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute):
                continue
            q = qualname(node) or ""
            parts = q.split(".")
            if len(parts) >= 3 and parts[-2] == "mark" \
                    and parts[-3] == "pytest":
                used.setdefault(parts[-1], []).append((rel, lines, node))
    return used


def run(ctx: ContractContext) -> tuple[list[Finding], dict]:
    findings: list[Finding] = []
    registered = parse_registered_markers(ctx)
    used = extract_used_markers(ctx)
    if not registered and not used:
        return [], {}

    ini_rel = ctx.rel(ctx.pytest_ini) if ctx.pytest_ini else "pytest.ini"
    for marker in sorted(used):
        if marker in _BUILTIN_MARKERS or marker in registered:
            continue
        rel, lines, node = min(
            used[marker],
            key=lambda s: (s[0], getattr(s[2], "lineno", 1)))
        line = getattr(node, "lineno", 1)
        disabled = _suppressed_rules(lines, line,
                                     statement_end_line(node))
        if disabled & {"all", "pyt01", "marker-unregistered"}:
            continue
        snippet = lines[line - 1].strip() if 1 <= line <= len(lines) \
            else ""
        findings.append(Finding(
            rule="PYT01", name="marker-unregistered", path=rel,
            line=line, col=1,
            message=(f"marker `{marker}` is used in tests but not "
                     f"registered in pytest.ini — `-m {marker}` "
                     f"selections silently match nothing under strict "
                     f"marker configs"),
            snippet=snippet))
    for marker in sorted(registered):
        if marker in used:
            continue
        findings.append(Finding(
            rule="PYT02", name="marker-unused", path=ini_rel,
            line=registered[marker], col=1,
            message=(f"pytest.ini registers marker `{marker}` but no "
                     f"test carries it — a dead selector in CI "
                     f"configs"),
            snippet=marker))

    inventory = {
        "registered": sorted(registered),
        "used": sorted(used),
    }
    return findings, inventory
