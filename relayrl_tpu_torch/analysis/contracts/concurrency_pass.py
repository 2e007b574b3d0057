"""Concurrency contract: lock-order cycles, transitive blocking, threads.

CONC01 (torchlint) sees one function at a time. This pass builds the
cross-module picture: which named locks exist (``self._lock =
threading.Lock()`` attributes and module-level lock globals), which
functions acquire them (``with`` statements), and who calls whom — then
checks the properties that only exist at the graph level:

* LOCK01 — two locks are acquired in both orders somewhere in the
  package (an A→B and a B→A path): the classic deadlock shape. Cycles
  are reported with every participating acquisition site.
* LOCK02 — a call made while holding a lock reaches (through one or
  more callees) a blocking operation — ``time.sleep``, a socket recv, a
  thread join. The direct case is CONC01's; this is the interprocedural
  upgrade, so only depth ≥ 1 chains are reported here.
* THR01 — a ``threading.Thread`` that is neither daemonized nor ever
  joined: an unkillable process at shutdown, or a silently leaked
  worker.

Call resolution is best-effort and package-local (same-module
functions, ``self.``-methods of the same class, and module-level
functions reached through import aliases); unresolved calls simply
contribute nothing, so the pass under-reports rather than guessing.
"""

from __future__ import annotations

import ast
from typing import Iterator

from relayrl_tpu_torch.analysis.contracts.base import (
    ContractContext,
    ParsedModule,
)
from relayrl_tpu_torch.analysis.engine import Finding, qualname
from relayrl_tpu_torch.analysis.rules.concurrency_rules import BlockingUnderLock

_LOCK_CTORS = frozenset({"threading.Lock", "threading.RLock",
                         "threading.Condition"})

FuncKey = tuple  # (module_dotted, class_or_None, func_name)


def _is_lock_ctor(mod: ParsedModule, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    resolved = mod.info.resolved_call(node) or qualname(node.func) or ""
    return resolved in _LOCK_CTORS or (
        resolved.rsplit(".", 1)[-1] in ("Lock", "RLock", "Condition")
        and "thread" in resolved.lower())


class FuncSummary:
    def __init__(self, key: FuncKey, module: ParsedModule):
        self.key = key
        self.module = module
        # lock_id -> acquisition `with` node (first one wins)
        self.acquires: dict[str, ast.AST] = {}
        # nested-with edges: (held_id, acquired_id, with_node)
        self.direct_edges: list[tuple[str, str, ast.AST]] = []
        # every resolved package-local call: (held_ids, node, callee_key)
        self.calls: list[tuple[tuple[str, ...], ast.Call, FuncKey]] = []
        # direct blocking ops: label -> node
        self.blocks: dict[str, ast.AST] = {}


class ConcurrencyGraph:
    """Locks, per-function summaries, and the call graph for one run."""

    def __init__(self, ctx: ContractContext):
        self.ctx = ctx
        self.module_locks: dict[str, dict[str, str]] = {}  # dotted -> name -> id
        self.class_locks: dict[tuple[str, str], dict[str, str]] = {}
        self.functions: dict[FuncKey, FuncSummary] = {}
        self.thread_sites: list[tuple[ParsedModule, ast.Call,
                                      str | None]] = []
        self._collect_locks()
        self._collect_functions()

    # -- collection ------------------------------------------------------
    def _collect_locks(self) -> None:
        for mod in self.ctx.package_modules():
            mlocks: dict[str, str] = {}
            for node in mod.tree.body:
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and _is_lock_ctor(mod, node.value)):
                    name = node.targets[0].id
                    mlocks[name] = f"{mod.dotted}.{name}"
            if mlocks:
                self.module_locks[mod.dotted] = mlocks
            for cls in mod.tree.body:
                if not isinstance(cls, ast.ClassDef):
                    continue
                clocks: dict[str, str] = {}
                for node in ast.walk(cls):
                    if (isinstance(node, ast.Assign)
                            and len(node.targets) == 1
                            and _is_lock_ctor(mod, node.value)):
                        target = qualname(node.targets[0]) or ""
                        if target.startswith("self.") \
                                and target.count(".") == 1:
                            attr = target.split(".", 1)[1]
                            clocks[attr] = (f"{mod.dotted}."
                                            f"{cls.name}.{attr}")
                if clocks:
                    self.class_locks[(mod.dotted, cls.name)] = clocks

    def _collect_functions(self) -> None:
        # two phases: register every key first, THEN walk bodies — call
        # resolution must see functions defined later in the file or in
        # a module not yet visited
        units: list[tuple[ParsedModule, str | None, ast.AST]] = []
        for mod in self.ctx.package_modules():
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    units.append((mod, None, node))
                elif isinstance(node, ast.ClassDef):
                    for item in node.body:
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            units.append((mod, node.name, item))
        for mod, cls, func in units:
            key: FuncKey = (mod.dotted, cls, func.name)
            self.functions.setdefault(key, FuncSummary(key, mod))
        for mod, cls, func in units:
            summary = self.functions[(mod.dotted, cls, func.name)]
            for stmt in func.body:
                self._walk(summary, mod, cls, stmt, ())

    def _lock_id(self, mod: ParsedModule, cls: str | None,
                 expr: ast.AST) -> str | None:
        name = qualname(expr)
        if not name:
            return None
        if name.startswith("self.") and name.count(".") == 1 \
                and cls is not None:
            return self.class_locks.get((mod.dotted, cls), {}).get(
                name.split(".", 1)[1])
        if "." not in name:
            return self.module_locks.get(mod.dotted, {}).get(name)
        return None

    def _walk(self, summary: FuncSummary, mod: ParsedModule,
              cls: str | None, node: ast.AST,
              held: tuple[str, ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # separate execution context
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired: list[str] = []
            for item in node.items:
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, ast.Call):
                        self._record_call(summary, mod, cls, sub, held)
                lock_id = self._lock_id(mod, cls, item.context_expr)
                if lock_id is not None:
                    summary.acquires.setdefault(lock_id, node)
                    for h in held:
                        if h != lock_id:
                            summary.direct_edges.append((h, lock_id,
                                                         node))
                    acquired.append(lock_id)
            inner = held + tuple(a for a in acquired if a not in held)
            for stmt in node.body:
                self._walk(summary, mod, cls, stmt, inner)
            return
        if isinstance(node, ast.Call):
            self._record_call(summary, mod, cls, node, held)
        for child in ast.iter_child_nodes(node):
            self._walk(summary, mod, cls, child, held)

    def _record_call(self, summary: FuncSummary, mod: ParsedModule,
                     cls: str | None, call: ast.Call,
                     held: tuple[str, ...]) -> None:
        label = BlockingUnderLock._blocking_label(mod.info, call)
        if label:
            summary.blocks.setdefault(label, call)
        callee = self._resolve_call(mod, cls, call)
        if callee is not None:
            summary.calls.append((held, call, callee))

    def _resolve_call(self, mod: ParsedModule, cls: str | None,
                      call: ast.Call) -> FuncKey | None:
        if isinstance(call.func, ast.Name):
            name = call.func.id
            key: FuncKey = (mod.dotted, None, name)
            if key in self.functions:
                return key
            return self._resolve_dotted(mod.info.resolve(name))
        q = qualname(call.func)
        if not q:
            return None
        if q.startswith("self.") and q.count(".") == 1 and cls is not None:
            key = (mod.dotted, cls, q.split(".", 1)[1])
            return key if key in self.functions else None
        return self._resolve_dotted(mod.info.resolve(q) or q)

    def _resolve_dotted(self, dotted: str | None) -> FuncKey | None:
        if not dotted or "." not in dotted:
            return None
        mod_path, name = dotted.rsplit(".", 1)
        key: FuncKey = (mod_path, None, name)
        return key if key in self.functions else None

    # -- closures --------------------------------------------------------
    def acquires_closure(self, key: FuncKey,
                         _memo: dict | None = None,
                         _stack: frozenset = frozenset()
                         ) -> dict[str, tuple[ParsedModule, ast.AST]]:
        memo = _memo if _memo is not None else {}
        if key in memo:
            return memo[key]
        if key in _stack:
            return {}
        summary = self.functions.get(key)
        if summary is None:
            return {}
        out: dict[str, tuple[ParsedModule, ast.AST]] = {
            lock: (summary.module, node)
            for lock, node in summary.acquires.items()}
        stack = _stack | {key}
        for _held, _node, callee in summary.calls:
            for lock, site in self.acquires_closure(callee, memo,
                                                    stack).items():
                out.setdefault(lock, site)
        memo[key] = out
        return out

    def blocking_closure(self, key: FuncKey,
                         _memo: dict | None = None,
                         _stack: frozenset = frozenset()
                         ) -> dict[str, tuple[ParsedModule, ast.AST]]:
        memo = _memo if _memo is not None else {}
        if key in memo:
            return memo[key]
        if key in _stack:
            return {}
        summary = self.functions.get(key)
        if summary is None:
            return {}
        out: dict[str, tuple[ParsedModule, ast.AST]] = {
            label: (summary.module, node)
            for label, node in summary.blocks.items()}
        stack = _stack | {key}
        for _held, _node, callee in summary.calls:
            for label, site in self.blocking_closure(callee, memo,
                                                     stack).items():
                out.setdefault(label, site)
        memo[key] = out
        return out


# -- cycle detection -----------------------------------------------------

def _strongly_connected(graph: dict[str, set[str]]) -> list[list[str]]:
    """Tarjan; returns SCCs with ≥2 nodes, deterministically ordered."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    counter = [0]
    sccs: list[list[str]] = []

    def visit(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        for w in sorted(graph.get(v, ())):
            if w not in index:
                visit(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            scc = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                scc.append(w)
                if w == v:
                    break
            if len(scc) >= 2:
                sccs.append(sorted(scc))

    for v in sorted(graph):
        if v not in index:
            visit(v)
    sccs.sort()
    return sccs


def _site(module: ParsedModule, node: ast.AST) -> str:
    return f"{module.relpath}:{getattr(node, 'lineno', 1)}"


# -- the pass ------------------------------------------------------------

def run(ctx: ContractContext) -> tuple[list[Finding], dict]:
    findings: list[Finding] = []

    def add(code: str, name: str, message: str, **kw) -> None:
        f = ctx.finding(code, name, message, **kw)
        if f is not None:
            findings.append(f)

    graph = ConcurrencyGraph(ctx)

    # edges: (A, B) -> (module, node, via_label) — deterministic winner
    edges: dict[tuple[str, str], tuple[ParsedModule, ast.AST, str]] = {}

    def record_edge(a: str, b: str, module: ParsedModule, node: ast.AST,
                    via: str) -> None:
        prior = edges.get((a, b))
        cand = (module, node, via)
        if prior is None or (_site(module, node), via) < (
                _site(prior[0], prior[1]), prior[2]):
            edges[(a, b)] = cand

    memo_acq: dict = {}
    memo_blk: dict = {}
    for key in sorted(graph.functions,
                      key=lambda k: (k[0], k[1] or "", k[2])):
        summary = graph.functions[key]
        for a, b, node in summary.direct_edges:
            record_edge(a, b, summary.module, node, "")
        for held, node, callee in summary.calls:
            if not held:
                continue
            callee_name = ".".join(str(p) for p in callee if p)
            for lock, _acq_site in graph.acquires_closure(
                    callee, memo_acq).items():
                for h in held:
                    if h != lock:
                        record_edge(h, lock, summary.module, node,
                                    f"via {callee_name}()")
            blocked = graph.blocking_closure(callee, memo_blk)
            if blocked:
                label = sorted(blocked)[0]
                bmod, bnode = blocked[label]
                add("LOCK02", "blocking-under-lock-transitive",
                    f"`{callee_name}()` is called while holding "
                    f"`{held[-1]}` and eventually blocks: `{label}` at "
                    f"{_site(bmod, bnode)} — CONC01 can't see through "
                    f"the call; move the call outside the critical "
                    f"section or make the callee non-blocking",
                    module=summary.module, node=node)

    adjacency: dict[str, set[str]] = {}
    for (a, b) in edges:
        adjacency.setdefault(a, set()).add(b)
        adjacency.setdefault(b, set())
    for scc in _strongly_connected(adjacency):
        members = set(scc)
        cycle_edges = sorted((a, b) for (a, b) in edges
                             if a in members and b in members)
        parts = []
        for a, b in cycle_edges:
            module, node, via = edges[(a, b)]
            suffix = f" {via}" if via else ""
            parts.append(f"`{a}` then `{b}` at "
                         f"{_site(module, node)}{suffix}")
        first_mod, first_node, _via = edges[cycle_edges[0]]
        add("LOCK01", "lock-order-cycle",
            "lock-order cycle (potential deadlock): "
            + "; ".join(parts)
            + " — pick one global order and acquire in it everywhere",
            module=first_mod, node=first_node)

    # THR01: threads neither daemonized nor joined
    for mod in ctx.package_modules():
        for module_, node, reason in _unjoined_threads(mod):
            add("THR01", "thread-never-joined",
                f"thread is {reason} — join it on shutdown or mark it "
                f"daemon=True so process exit isn't blocked on a "
                f"forgotten worker",
                module=module_, node=node)

    inventory = {
        "locks": sorted({lid for locks in graph.module_locks.values()
                         for lid in locks.values()}
                        | {lid for locks in graph.class_locks.values()
                           for lid in locks.values()}),
        "lock_edges": [f"{a} -> {b}" for a, b in sorted(edges)],
    }
    return findings, inventory


def _thread_ctor(mod: ParsedModule, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    resolved = mod.info.resolved_call(node) or qualname(node.func) or ""
    return resolved == "threading.Thread" or resolved.endswith(".Thread")


def _unjoined_threads(mod: ParsedModule) -> Iterator[
        tuple[ParsedModule, ast.Call, str]]:
    ctors: list[tuple[ast.Call, str | None]] = []

    class _Finder(ast.NodeVisitor):
        def visit_Assign(self, node: ast.Assign) -> None:
            if len(node.targets) == 1 and _thread_ctor(mod, node.value):
                ctors.append((node.value, qualname(node.targets[0])))
            else:
                self.generic_visit(node)

        def visit_Call(self, node: ast.Call) -> None:
            if _thread_ctor(mod, node):
                ctors.append((node, None))
            self.generic_visit(node)

    _Finder().visit(mod.tree)

    seen: set[int] = set()
    deduped: list[tuple[ast.Call, str | None]] = []
    for call, target in ctors:
        if id(call) in seen:
            continue
        seen.add(id(call))
        deduped.append((call, target))

    joined_receivers: set[str] = set()
    daemon_assigned: set[str] = set()
    any_join = False
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"
                and not isinstance(node.func.value, ast.Constant)):
            any_join = True
            receiver = qualname(node.func.value)
            if receiver:
                joined_receivers.add(receiver)
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = qualname(node.targets[0]) or ""
            if target.endswith(".daemon") and isinstance(
                    node.value, ast.Constant) and node.value.value is True:
                daemon_assigned.add(target[:-len(".daemon")])

    for call, target in deduped:
        daemon_kw = any(
            kw.arg == "daemon" and isinstance(kw.value, ast.Constant)
            and kw.value.value is True for kw in call.keywords)
        if daemon_kw:
            continue
        if target is not None:
            if target in joined_receivers or target in daemon_assigned:
                continue
            yield mod, call, (f"assigned to `{target}` but never "
                              f"joined or daemonized in this module")
        else:
            # anonymous: appended to a pool or started inline — accept
            # if the module joins *anything* (pool-join idiom)
            if any_join:
                continue
            yield mod, call, ("anonymous (never bound) and this module "
                              "joins nothing")
