"""The contracts engine: cross-artifact drift checks.

torchlint answers "is this line of code wrong"; contracts answers "do the
artifacts still agree" — metric registrations vs the observability
catalog, config defaults vs loader clamps vs the ops knob tables,
Python wire constants vs ``native/*.cc``, the cross-module lock graph,
and tests/ markers vs pytest.ini. :func:`run_contracts` runs every
pass, returns torchlint-shaped :class:`Finding` objects (same baseline,
same ``# torchlint: disable=`` suppressions), and the merged machine-
readable inventory whose committed copy (``contracts.json``) anchors
CON01 drift detection.
"""

from __future__ import annotations

import os

from relayrl_tpu_torch.analysis.contracts import (
    concurrency_pass,
    config_pass,
    markers_pass,
    telemetry_pass,
    wire_pass,
)
from relayrl_tpu_torch.analysis.contracts.base import (
    ContractContext,
    sorted_findings,
)
from relayrl_tpu_torch.analysis.contracts.inventory import (
    DEFAULT_INVENTORY,
    diff_inventory,
    load_inventory,
    merge_inventory,
    serialize_inventory,
    write_inventory,
)
from relayrl_tpu_torch.analysis.engine import Finding

__all__ = [
    "CONTRACT_RULES",
    "ContractContext",
    "DEFAULT_INVENTORY",
    "run_contracts",
    "serialize_inventory",
    "write_inventory",
]

# (code, name, one-line description) — the --list-rules catalog and the
# --select/--ignore universe for the contracts half.
CONTRACT_RULES: list[tuple[str, str, str]] = [
    ("MET01", "metric-prefix",
     "metric name lacks the relayrl_ namespace prefix"),
    ("MET02", "counter-suffix", "counter not named *_total"),
    ("MET03", "histogram-unit-suffix",
     "histogram without a unit suffix (_seconds/_bytes/...)"),
    ("MET04", "metric-family-collision",
     "one metric name registered with two kinds or bucket grids"),
    ("MET05", "metric-undocumented",
     "registered metric missing from docs/observability.md"),
    ("MET06", "metric-documented-gone",
     "documented metric with no registration site"),
    ("MET07", "metric-doc-kind-drift",
     "metric kind in code disagrees with the docs"),
    ("EVT01", "event-unregistered",
     "journal event emitted but missing from EVENT_TYPES"),
    ("EVT02", "event-undocumented",
     "EVENT_TYPES entry missing from the docs event table"),
    ("EVT03", "event-documented-gone",
     "documented event not in EVENT_TYPES"),
    ("CFG01", "config-read-no-default",
     "config key read with no shipped default"),
    ("CFG02", "config-dead-knob",
     "shipped default whose key nothing reads"),
    ("CFG03", "config-clamp-drift",
     "loader fallback disagrees with the shipped default"),
    ("CFG04", "config-doc-drift",
     "doc knob table disagrees with the shipped default"),
    ("CFG05", "config-undocumented-knob",
     "operational knob with no doc knob-table row"),
    ("CFG06", "config-doc-unknown-knob",
     "documented knob that does not exist in the defaults"),
    ("WIRE01", "wire-parity-mismatch",
     "wire constant disagrees between python and native"),
    ("WIRE02", "wire-symbol-missing",
     "a parity pair's symbol is no longer extractable"),
    ("LOCK01", "lock-order-cycle",
     "two locks acquired in both orders (potential deadlock)"),
    ("LOCK02", "blocking-under-lock-transitive",
     "call under lock reaches a blocking op through callees"),
    ("THR01", "thread-never-joined",
     "thread neither daemonized nor joined"),
    ("PYT01", "marker-unregistered",
     "pytest marker used but not registered in pytest.ini"),
    ("PYT02", "marker-unused",
     "pytest.ini marker no test carries"),
    ("CON01", "contracts-inventory-drift",
     "committed contracts.json disagrees with a fresh extraction"),
]

CONTRACT_CODES = frozenset(code for code, _n, _d in CONTRACT_RULES)

_PASSES = (
    ("telemetry", telemetry_pass.run),
    ("config", config_pass.run),
    ("wire", wire_pass.run),
    ("concurrency", concurrency_pass.run),
    ("markers", markers_pass.run),
)


def run_contracts(ctx: ContractContext | None = None,
                  inventory_path: str | None = None,
                  check_inventory: bool = True,
                  ) -> tuple[list[Finding], dict]:
    """Run every contract pass. Returns ``(findings, inventory_doc)``.

    When ``check_inventory`` is true and a committed inventory exists
    at ``inventory_path`` (default: the packaged ``contracts.json``),
    CON01 compares it against the fresh extraction — but only when the
    run has full repo context (docs + native + tests + pytest.ini and
    no root overrides), so wheels and fixture-scoped test runs don't
    flag spurious drift.
    """
    if ctx is None:
        ctx = ContractContext()
    findings: list[Finding] = []
    sections: dict[str, dict] = {}
    for name, pass_run in _PASSES:
        pass_findings, inventory = pass_run(ctx)
        findings.extend(pass_findings)
        sections[name] = inventory
    doc = merge_inventory(sections)

    if check_inventory and _full_context(ctx):
        path = inventory_path or DEFAULT_INVENTORY
        if os.path.exists(path):
            committed = load_inventory(path)
            if committed is None:
                findings.append(Finding(
                    rule="CON01", name="contracts-inventory-drift",
                    path=ctx.rel(path), line=1, col=1,
                    message="committed contracts inventory is not "
                            "valid JSON — regenerate it with "
                            "--write-inventory",
                    snippet=""))
            else:
                diffs = diff_inventory(committed, doc)
                if diffs:
                    findings.append(Finding(
                        rule="CON01", name="contracts-inventory-drift",
                        path=ctx.rel(path), line=1, col=1,
                        message=("committed contracts inventory "
                                 "disagrees with a fresh extraction ("
                                 + "; ".join(diffs)
                                 + ") — a contract changed without the "
                                 "inventory; regenerate with "
                                 "--write-inventory and review the "
                                 "diff"),
                        snippet=""))
    return sorted_findings(findings), doc


def _full_context(ctx: ContractContext) -> bool:
    return all(root is not None for root in (
        ctx.repo_root, ctx.docs_root, ctx.native_root, ctx.tests_root,
        ctx.pytest_ini))
