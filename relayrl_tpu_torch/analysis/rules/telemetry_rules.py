"""Telemetry timing rules.

The skew-guard convention: wall clocks (``time.time()``) exist to be
*compared across hosts* — every latency/duration a single process
measures and records must come from the monotonic clock
(``time.monotonic()``/``time.perf_counter()``), because NTP steps the
wall clock backwards and forwards under load and a stepped wall clock
turns into negative or wildly inflated latencies on the dashboards.
"""

from __future__ import annotations

import ast
from typing import Iterator

from relayrl_tpu_torch.analysis.engine import (
    ModuleInfo,
    Rule,
    qualname,
    walk_skip_nested_functions,
)

_WALL_CALLS = frozenset({"time.time"})
# The metric-recording surfaces a computed duration flows into.
_RECORD_ATTRS = frozenset({"observe", "set", "inc", "add"})


class WallClockLatency(Rule):
    """``time.time() - t0`` feeding a metric ``observe``/``set`` call:
    the interval is wrong whenever NTP steps the clock. Intervals must
    use ``time.monotonic()``; keep ``time.time()`` only for timestamps
    that cross host boundaries (where the skew guard compensates)."""

    code = "TEL01"
    name = "wall-clock-latency"
    description = ("time.time() interval recorded by telemetry — use "
                   "time.monotonic()")

    def check(self, module: ModuleInfo) -> Iterator[tuple[ast.AST, str]]:
        scopes: list[ast.AST] = [module.tree]
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(node)
        for scope in scopes:
            yield from self._check_scope(module, scope)

    def _is_wall_call(self, module: ModuleInfo, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and module.resolved_call(node) in _WALL_CALLS)

    def _check_scope(self, module: ModuleInfo,
                     scope: ast.AST) -> Iterator[tuple[ast.AST, str]]:
        body = walk_skip_nested_functions(scope) \
            if not isinstance(scope, ast.Module) \
            else (n for stmt in scope.body
                  if not isinstance(stmt, (ast.FunctionDef,
                                           ast.AsyncFunctionDef,
                                           ast.ClassDef))
                  for n in (stmt, *walk_skip_nested_functions(stmt)))
        nodes = list(body)

        wall_names: set[str] = set()
        for node in nodes:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and self._is_wall_call(module, node.value)):
                target = qualname(node.targets[0])
                if target:
                    wall_names.add(target)

        def is_wall_operand(op: ast.AST) -> bool:
            if self._is_wall_call(module, op):
                return True
            name = qualname(op)
            return name is not None and name in wall_names

        # wall-clock interval expressions first, THEN the names they
        # land in — an Assign precedes its own BinOp child in walk
        # order, so a single combined pass would miss `dt = time.time()
        # - t0` every time
        wall_subs: dict[int, ast.BinOp] = {}
        for node in nodes:
            if (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Sub)
                    and (is_wall_operand(node.left)
                         or is_wall_operand(node.right))):
                wall_subs[id(node)] = node
        interval_names: dict[str, ast.BinOp] = {}
        for node in nodes:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1):
                for sub in ast.walk(node.value):
                    if id(sub) in wall_subs:
                        target = qualname(node.targets[0])
                        if target:
                            interval_names[target] = wall_subs[id(sub)]

        for node in nodes:
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _RECORD_ATTRS
                    and not isinstance(node.func.value, ast.Constant)):
                continue
            for arg in (*node.args, *(kw.value for kw in node.keywords)):
                anchor: ast.AST | None = None
                for sub in ast.walk(arg):
                    if id(sub) in wall_subs:
                        anchor = sub
                        break
                    name = qualname(sub)
                    if name is not None and name in interval_names:
                        anchor = interval_names[name]
                        break
                if anchor is not None:
                    yield anchor, (
                        f"wall-clock interval recorded via "
                        f"`.{node.func.attr}()` — time.time() steps "
                        f"under NTP; measure durations with "
                        f"time.monotonic() and keep wall clocks for "
                        f"cross-host timestamps only")
                    break


RULES = [WallClockLatency]
