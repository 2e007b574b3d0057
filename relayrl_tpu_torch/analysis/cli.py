"""torchlint + contracts command line.

    python -m relayrl_tpu_torch.analysis [paths...] [options]

Two engines share one gate: torchlint (per-line AST rules over the given
paths) and contracts (cross-artifact drift checks over the installed
port + repo artifacts). The bare default invocation runs BOTH and
any *new* finding fails the gate; ``--contracts`` runs the contract
engine alone, ``--no-contracts`` the linter alone. Explicit paths scan
with torchlint only — the contract surfaces are package-wide, not
path-scoped — unless ``--contracts`` is also given. With no paths,
torchlint scans the installed port and, in a checkout, the repo's
``chip_smoke.py`` beside it.

Exit codes: 0 = clean (every finding baselined or none), 1 = new
findings, 2 = bad invocation. The default baseline is the committed
``relayrl_tpu_torch/analysis/baseline.json``; the committed contract
inventory is ``relayrl_tpu_torch/analysis/contracts.json`` (regenerate
with ``--contracts --write-inventory``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Sequence

from relayrl_tpu_torch.analysis.engine import (
    analyze_paths,
    apply_baseline,
    load_baseline,
    write_baseline,
)
from relayrl_tpu_torch.analysis.rules import all_rules

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


def _default_scan_roots() -> list[str]:
    """The installed relayrl_tpu_torch package, plus ``chip_smoke.py``
    when the package sits in a checkout that has one — so a bare
    ``python -m relayrl_tpu_torch.analysis`` lints the port from any
    cwd."""
    import relayrl_tpu_torch

    package = os.path.dirname(os.path.abspath(relayrl_tpu_torch.__file__))
    smoke = os.path.join(os.path.dirname(package), "chip_smoke.py")
    return [package, smoke] if os.path.isfile(smoke) else [package]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m relayrl_tpu_torch.analysis",
        description=("torchlint + contracts: static analysis for "
                     "relayrl_tpu_torch"),
    )
    p.add_argument("paths", nargs="*",
                   help="files/directories to scan with torchlint "
                        "(default: the installed relayrl_tpu_torch "
                        "package and the checkout's chip_smoke.py)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="baseline JSON of grandfathered findings "
                        f"(default: {DEFAULT_BASELINE})")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignoring any baseline")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the current findings to the baseline file "
                        "and exit 0 (requires an explicit --baseline "
                        "PATH — never overwrites the default silently)")
    p.add_argument("--contracts", action="store_true",
                   help="run only the contracts engine (cross-artifact "
                        "drift checks)")
    p.add_argument("--no-contracts", action="store_true",
                   help="run only torchlint, skipping the contracts engine")
    p.add_argument("--inventory", default=None, metavar="FILE",
                   help="committed contract inventory to check against / "
                        "write (default: the packaged contracts.json)")
    p.add_argument("--write-inventory", action="store_true",
                   help="regenerate the contract inventory from the "
                        "current tree (to --inventory, default the "
                        "packaged contracts.json) and exit 0")
    p.add_argument("--select", default=None, metavar="CODES",
                   help="comma-separated rule codes to run (default all)")
    p.add_argument("--ignore", default=None, metavar="CODES",
                   help="comma-separated rule codes to skip")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--list-rules", action="store_true",
                   help="print both engines' rule catalogs and exit")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress the summary line")
    return p


def _pick_rules(select: str | None, ignore: str | None,
                contract_codes: frozenset[str]):
    """torchlint rule objects plus the (selected, ignored) contract-code
    filters; unknown codes across BOTH engines' catalogs exit 2."""
    rules = all_rules()
    lint_codes = {r.code for r in rules}
    selected_contracts: set[str] | None = None
    if select:
        wanted = {c.strip().upper() for c in select.split(",") if c.strip()}
        unknown = wanted - lint_codes - contract_codes
        if unknown:
            raise SystemExit(
                f"unknown rule code(s): {', '.join(sorted(unknown))}")
        rules = [r for r in rules if r.code in wanted]
        selected_contracts = wanted & contract_codes
    ignored: set[str] = set()
    if ignore:
        ignored = {c.strip().upper() for c in ignore.split(",") if c.strip()}
        rules = [r for r in rules if r.code not in ignored]
    return rules, selected_contracts, ignored


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from relayrl_tpu_torch.analysis.contracts import (
        CONTRACT_CODES,
        CONTRACT_RULES,
        DEFAULT_INVENTORY,
        run_contracts,
        write_inventory,
    )

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.code}  {rule.name}: {rule.description}")
        for code, name, description in CONTRACT_RULES:
            print(f"{code}  {name}: {description}")
        return 0

    if args.contracts and args.no_contracts:
        print("--contracts and --no-contracts are mutually exclusive",
              file=sys.stderr)
        return 2

    try:
        rules, selected_contracts, ignored = _pick_rules(
            args.select, args.ignore, CONTRACT_CODES)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2

    run_lint = not args.contracts
    # contract surfaces are package-wide: the engine runs on the bare
    # default invocation and on an explicit --contracts, not when the
    # caller aimed torchlint at specific paths
    run_contract_engine = not args.no_contracts and (
        args.contracts or not args.paths)

    paths = args.paths or _default_scan_roots()
    if run_lint:
        for path in paths:
            if not os.path.exists(path):
                print(f"no such path: {path}", file=sys.stderr)
                return 2

    findings = []
    if run_lint:
        findings.extend(analyze_paths(paths, rules=rules))

    inventory_path = args.inventory or DEFAULT_INVENTORY
    if run_contract_engine:
        contract_findings, inventory_doc = run_contracts(
            inventory_path=args.inventory,
            check_inventory=not args.write_inventory)
        if args.write_inventory:
            write_inventory(inventory_path, inventory_doc)
            if not args.quiet:
                print(f"contracts: wrote inventory to {inventory_path}")
            return 0
        for f in contract_findings:
            if selected_contracts is not None \
                    and f.rule not in selected_contracts:
                continue
            if f.rule in ignored:
                continue
            findings.append(f)
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    elif args.write_inventory:
        print("--write-inventory requires the contracts engine "
              "(drop --no-contracts / path arguments or pass "
              "--contracts)", file=sys.stderr)
        return 2

    baseline_path = args.baseline or DEFAULT_BASELINE
    if args.write_baseline:
        if args.baseline is None:
            # Any scan (bare default included) sees only its own slice of
            # the gate's coverage; writing it to the shared default
            # baseline would silently drop grandfathered entries from
            # every path outside this scan. Rewriting the committed
            # baseline must name it explicitly.
            print("--write-baseline requires an explicit --baseline PATH "
                  "(refusing to overwrite the shared default baseline "
                  "with this scan's findings)", file=sys.stderr)
            return 2
        write_baseline(baseline_path, findings)
        if not args.quiet:
            print(f"baseline: wrote {len(findings)} finding(s) to "
                  f"{baseline_path}")
        return 0

    baseline = {}
    if not args.no_baseline and os.path.isfile(baseline_path):
        try:
            baseline = load_baseline(baseline_path)
        except (ValueError, OSError, KeyError, TypeError) as e:
            # exit 2 = bad invocation; 1 is reserved for "new findings"
            print(f"cannot read baseline {baseline_path}: {e!r} — fix or "
                  f"regenerate it with --write-baseline", file=sys.stderr)
            return 2
    new, matched, stale = apply_baseline(findings, baseline)

    if args.format == "json":
        print(json.dumps({
            "new": [vars(f) for f in new],
            "baselined": matched,
            "stale_baseline_entries": [list(k) for k in stale],
        }, indent=2))
    else:
        for f in new:
            print(f.format())
        if not args.quiet:
            for rule, path, snippet in stale:
                print(f"note: stale baseline entry {rule} @ {path} "
                      f"({snippet[:60]!r}) — fixed code, prune it with "
                      f"--write-baseline")
            engines = []
            if run_lint:
                engines.append(f"{len(rules)} torchlint rule(s)")
            if run_contract_engine:
                engines.append("contracts")
            print(f"torchlint: {len(new)} new finding(s), {matched} "
                  f"baselined, {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'}, "
                  f"{' + '.join(engines)} active")
    return 1 if new else 0
