"""torchlint rule engine: AST module model, finding type, suppression,
baseline matching, and the file/directory scan.

This module is pure stdlib (``ast`` + ``json``) on purpose: linting must
never require torch or a GPU — CI can gate a change on hosts with no
accelerator stack. (Reaching it as ``relayrl_tpu_torch.analysis``
executes the port's package root, which imports nothing.)

The unit of identity for a finding is ``(rule, path, stripped source
line)`` — NOT the line number. Line numbers churn on every unrelated
edit; the snippet-keyed baseline survives code motion the way
pylint/ruff per-line suppression cannot (idea borrowed from
mypy/ruff ``--add-noqa`` baselines and Google's Tricorder).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Iterable, Iterator, Mapping, Sequence

__all__ = [
    "Finding",
    "Rule",
    "ModuleInfo",
    "analyze_source",
    "analyze_file",
    "analyze_paths",
    "load_baseline",
    "write_baseline",
    "apply_baseline",
    "module_scope_nodes",
    "qualname",
    "statement_end_line",
]

# Context managers whose body records a CUDA graph.
CAPTURE_CONTEXTS = frozenset({"torch.cuda.graph", "torch.cuda.graphs.graph"})

# Calls whose function arguments are captured into CUDA graphs.
CAPTURE_WRAPPERS = frozenset({
    "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables",
})

_SUPPRESS_RE = re.compile(r"#\s*torchlint:\s*disable=([A-Za-z0-9_\-, ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic. ``snippet`` (the stripped source line) is part of
    the identity so baselines survive line-number churn."""

    rule: str       # stable code, e.g. "TORCH01"
    name: str       # human slug, e.g. "implicit-global-rng"
    path: str       # posix-style path as reported (relative when possible)
    line: int
    col: int
    message: str
    snippet: str

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.snippet)

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule}[{self.name}] {self.message}")


class Rule:
    """Base class. Subclasses set ``code``/``name``/``description`` and
    yield ``(node, message)`` from :meth:`check`; the engine attaches
    location, snippet and suppression handling."""

    code: str = "XXX00"
    name: str = "abstract-rule"
    description: str = ""

    def check(self, module: "ModuleInfo") -> Iterator[tuple[ast.AST, str]]:
        raise NotImplementedError

    def finding(self, module: "ModuleInfo", node: ast.AST,
                message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0) + 1
        snippet = ""
        if 1 <= line <= len(module.lines):
            snippet = module.lines[line - 1].strip()
        return Finding(rule=self.code, name=self.name, path=module.path,
                       line=line, col=col, message=message, snippet=snippet)


def walk_skip_nested_functions(node: ast.AST) -> Iterator[ast.AST]:
    """Walk a node's subtree without descending into nested
    def/lambda/class bodies (they execute in a different context). The
    shared helper for every rule that reasons about "what runs here"."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            continue
        yield child
        yield from walk_skip_nested_functions(child)


def module_scope_nodes(tree: ast.Module) -> Iterator[ast.AST]:
    """Every node that executes at import time: the module body plus
    module-level if/try/with/for blocks and class bodies — but nothing
    inside function or lambda bodies, which run later."""
    for child in ast.iter_child_nodes(tree):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        yield from module_scope_nodes(child)


def qualname(node: ast.AST) -> str | None:
    """Dotted name of a Name/Attribute chain (``self.x.y`` -> "self.x.y"),
    or None for anything not expressible as one."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class ModuleInfo:
    """Parsed module plus the cross-rule facts every rule needs: import
    aliases, and which code runs while a CUDA graph is being captured."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.aliases = self._collect_aliases(tree)
        # The bodies of ``with torch.cuda.graph(...)`` blocks: statement
        # lists executed once, at capture, and frozen into every replay.
        self.capture_blocks: list[list[ast.stmt]] = []
        self.captured_functions = self._collect_captured_functions(tree)

    # -- import alias resolution --
    @staticmethod
    def _collect_aliases(tree: ast.Module) -> dict[str, str]:
        aliases: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def resolve(self, dotted: str | None) -> str | None:
        """Expand the leading segment through the module's import aliases
        (``F.relu`` -> "torch.nn.functional.relu", ``nn.Linear`` ->
        "torch.nn.Linear")."""
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        expanded = self.aliases.get(head, head)
        return f"{expanded}.{rest}" if rest else expanded

    def resolved_call(self, node: ast.Call) -> str | None:
        return self.resolve(qualname(node.func))

    # -- capture topology --
    def is_capture_context(self, expr: ast.AST) -> bool:
        return (isinstance(expr, ast.Call)
                and self.resolved_call(expr) in CAPTURE_CONTEXTS)

    def _collect_captured_functions(self, tree: ast.Module) -> set[ast.AST]:
        """FunctionDefs that run under a CUDA-graph capture: called from
        the body of a ``with torch.cuda.graph(...)`` block, or passed to
        ``torch.cuda.make_graphed_callables``, and every function those
        call, transitively, within this module. A bare name resolves to a
        def in an enclosing function, then to a module-level def, then to
        a def whose name is unique in the module; ``self.m(...)`` resolves
        to ``m`` of the enclosing class. Unresolved calls contribute
        nothing: the model under-reports rather than guessing."""
        parents: dict[int, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node

        def enclosing(node: ast.AST, kinds) -> ast.AST | None:
            cur = parents.get(id(node))
            while cur is not None and not isinstance(cur, kinds):
                cur = parents.get(id(cur))
            return cur

        by_name: dict[str, list[ast.AST]] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                by_name.setdefault(node.name, []).append(node)
        top = {n.name: n for n in tree.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

        def methods_of(cls: ast.AST | None) -> dict[str, ast.AST]:
            if not isinstance(cls, ast.ClassDef):
                return {}
            return {n.name: n for n in cls.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

        def resolve_callable(expr: ast.AST, site: ast.AST) -> ast.AST | None:
            if isinstance(expr, ast.Name):
                scope = enclosing(site, (ast.FunctionDef, ast.AsyncFunctionDef))
                while scope is not None:
                    for stmt in ast.walk(scope):
                        if (isinstance(stmt, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))
                                and stmt is not scope
                                and stmt.name == expr.id):
                            return stmt
                    scope = enclosing(scope, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))
                if expr.id in top:
                    return top[expr.id]
                found = by_name.get(expr.id, [])
                return found[0] if len(found) == 1 else None
            name = qualname(expr)
            if name and name.startswith("self.") and name.count(".") == 1:
                cls = enclosing(site, (ast.ClassDef,))
                return methods_of(cls).get(name.split(".", 1)[1])
            return None

        captured: set[ast.AST] = set()
        pending: list[ast.AST] = []

        def calls_in(nodes) -> Iterator[ast.Call]:
            for stmt in nodes:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                for node in (stmt, *walk_skip_nested_functions(stmt)):
                    if isinstance(node, ast.Call):
                        yield node

        def mark(expr: ast.AST, site: ast.AST) -> None:
            fn = resolve_callable(expr, site)
            if fn is not None and fn not in captured:
                captured.add(fn)
                pending.append(fn)

        for node in ast.walk(tree):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    self.is_capture_context(item.context_expr)
                    for item in node.items):
                self.capture_blocks.append(node.body)
                for call in calls_in(node.body):
                    mark(call.func, call)
            elif (isinstance(node, ast.Call)
                    and self.resolved_call(node) in CAPTURE_WRAPPERS
                    and node.args):
                first = node.args[0]
                targets = (first.elts if isinstance(first, (ast.Tuple,
                                                            ast.List))
                           else [first])
                for target in targets:
                    mark(target, node)
        while pending:
            fn = pending.pop()
            for call in calls_in(fn.body):
                mark(call.func, call)
        return captured

    def capture_bodies(self) -> Iterator[list[ast.AST]]:
        """The nodes that execute under a capture, one list per capture
        block or captured function (nested defs and lambdas excluded:
        they run only if called, and a called def is a captured
        function of its own)."""
        bodies = list(self.capture_blocks)
        bodies.extend(fn.body for fn in sorted(
            self.captured_functions, key=lambda f: (f.lineno, f.col_offset)))
        for body in bodies:
            nodes: list[ast.AST] = []
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                nodes.append(stmt)
                nodes.extend(walk_skip_nested_functions(stmt))
            yield nodes


# -- suppression ---------------------------------------------------------

def _suppressed_rules(lines: Sequence[str], line: int,
                      end_line: int | None = None) -> set[str]:
    """Rule codes/slugs disabled for the statement starting at ``line``
    (1-based): an end-of-line ``# torchlint: disable=...`` comment on any
    line of the statement's span (``line``..``end_line`` — a wrapped
    call may carry the disable on its closing-paren line), or a
    COMMENT-ONLY preceding line (a trailing disable on the previous code
    line covers that line only — it must not leak onto the next one).
    Only the first word of each comma-separated token counts, so a
    trailing reason (``disable=IMP01 - entry script``) doesn't defeat
    the suppression."""

    def collect(text: str) -> None:
        m = _SUPPRESS_RE.search(text)
        if m:
            for token in m.group(1).split(","):
                words = token.strip().split()
                if words:
                    out.add(words[0].lower())

    out: set[str] = set()
    last = max(line, end_line or line)
    for n in range(line, last + 1):
        if 1 <= n <= len(lines):
            collect(lines[n - 1])
    prev = line - 2
    if 0 <= prev < len(lines) and lines[prev].lstrip().startswith("#"):
        collect(lines[prev])
    return out


def statement_end_line(node: ast.AST) -> int:
    """Last line of the LOGICAL statement a finding anchors to: the full
    node span for simple statements (a wrapped call's continuation lines
    belong to it), but only the header for compound statements — a
    disable inside a ``with``/``except`` BODY must not suppress a
    finding on the header."""
    line = getattr(node, "lineno", 1)
    end = getattr(node, "end_lineno", None) or line
    body = getattr(node, "body", None)
    if isinstance(body, list) and body:
        first = getattr(body[0], "lineno", None)
        if first is not None:
            end = max(line, first - 1)
    return end


def _is_suppressed(finding: Finding, lines: Sequence[str],
                   end_line: int | None = None) -> bool:
    disabled = _suppressed_rules(lines, finding.line, end_line)
    return bool(disabled & {"all", finding.rule.lower(),
                            finding.name.lower()})


# -- scans ---------------------------------------------------------------

def _default_rules() -> list[Rule]:
    from relayrl_tpu_torch.analysis.rules import all_rules

    return all_rules()


def analyze_source(source: str, path: str = "<string>",
                   rules: Sequence[Rule] | None = None) -> list[Finding]:
    """Run the rules over one source string. Syntax errors surface as a
    single ``PARSE`` finding instead of an exception, so one broken file
    can't hide every other file's findings in a directory scan."""
    rules = list(rules) if rules is not None else _default_rules()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(rule="PARSE", name="syntax-error", path=path,
                        line=e.lineno or 1, col=(e.offset or 0) + 1,
                        message=f"cannot parse: {e.msg}", snippet="")]
    module = ModuleInfo(path=path, source=source, tree=tree)
    findings: list[Finding] = []
    for rule in rules:
        for node, message in rule.check(module):
            f = rule.finding(module, node, message)
            if not _is_suppressed(f, module.lines,
                                  statement_end_line(node)):
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def analyze_file(path: str | os.PathLike, display_path: str | None = None,
                 rules: Sequence[Rule] | None = None) -> list[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    shown = display_path if display_path is not None else str(path)
    return analyze_source(source, path=shown.replace(os.sep, "/"),
                          rules=rules)


# Directories that never hold first-party source: linting a checkout
# root must not descend into virtualenvs, build trees, or tool caches
# (thousands of third-party findings would drown the real ones).
_PRUNE_DIRS = frozenset({
    "__pycache__", "build", "dist", "node_modules",
    ".venv", "venv", "env", ".eggs",
})


def iter_python_files(root: str | os.PathLike) -> Iterator[str]:
    root = str(root)
    if os.path.isfile(root):
        yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        # prune hidden dirs (.git, .tox, .mypy_cache, .claude, ...) and
        # the well-known non-source trees; an explicitly passed root is
        # unaffected (pruning applies to children only)
        dirnames[:] = sorted(
            d for d in dirnames
            if not d.startswith(".") and d not in _PRUNE_DIRS)
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


_REPO_MARKERS = (".git", "pyproject.toml", "setup.py")


def _enclosing_repo_root(path: str) -> str | None:
    """Nearest ancestor directory carrying a repo marker, or None."""
    cur = path if os.path.isdir(path) else os.path.dirname(path)
    while True:
        if any(os.path.exists(os.path.join(cur, m)) for m in _REPO_MARKERS):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return None
        cur = parent


def analyze_paths(paths: Sequence[str | os.PathLike],
                  rules: Sequence[Rule] | None = None) -> list[Finding]:
    """Scan files/directories. Baseline keys must come out identical no
    matter how — or from where — the same file is reached, so reported
    paths are anchored at the enclosing REPO root (nearest ancestor with
    a ``.git``/``pyproject.toml``/``setup.py`` marker): ``relayrl_tpu_torch/``,
    ``.``, and ``tests/x.py`` all key ``tests/x.py`` whether the scan
    runs from the repo root or a subdirectory. Outside any repo, a root
    under the cwd anchors at the cwd, and anything else falls back to its
    own parent directory (stable across checkouts, though same-named
    loose files from different out-of-tree parents can collide — scan
    the directory if that matters)."""
    rules = list(rules) if rules is not None else _default_rules()
    findings: list[Finding] = []
    cwd = os.getcwd()
    for root in paths:
        root_abs = os.path.abspath(str(root))
        base = _enclosing_repo_root(root_abs)
        if base is None:
            if root_abs == cwd or root_abs.startswith(cwd + os.sep):
                base = cwd
            else:
                base = os.path.dirname(root_abs)
        for file in iter_python_files(root_abs):
            display = os.path.relpath(file, base)
            findings.extend(analyze_file(file, display_path=display,
                                         rules=rules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# -- baseline ------------------------------------------------------------

def load_baseline(path: str | os.PathLike) -> dict[tuple[str, str, str], int]:
    """Baseline file -> multiset of finding keys ({key: count})."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    out: dict[tuple[str, str, str], int] = {}
    for entry in data.get("findings", []):
        key = (str(entry["rule"]), str(entry["path"]),
               str(entry["snippet"]))
        out[key] = out.get(key, 0) + int(entry.get("count", 1))
    return out


def write_baseline(path: str | os.PathLike,
                   findings: Iterable[Finding]) -> None:
    counts: dict[tuple[str, str, str], int] = {}
    for f in findings:
        counts[f.key()] = counts.get(f.key(), 0) + 1
    entries = [
        {"rule": rule, "path": p, "snippet": snippet, "count": n}
        for (rule, p, snippet), n in sorted(counts.items())
    ]
    payload = {
        "version": 1,
        "tool": "torchlint",
        "comment": ("Grandfathered findings. Entries are keyed by "
                    "(rule, path, stripped source line) so they survive "
                    "line-number churn; regenerate with --write-baseline "
                    "and keep this file shrinking."),
        "findings": entries,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=False)
        f.write("\n")


def apply_baseline(
    findings: Sequence[Finding],
    baseline: Mapping[tuple[str, str, str], int],
) -> tuple[list[Finding], int, list[tuple[str, str, str]]]:
    """Split findings into (new, matched_count, stale_keys).

    Each baseline entry absorbs up to ``count`` findings with the same
    key; the remainder are new. Keys present in the baseline but absent
    from the scan are stale — fixed code whose entry should be pruned.
    """
    remaining = dict(baseline)
    new: list[Finding] = []
    matched = 0
    for f in findings:
        k = f.key()
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
            matched += 1
        else:
            new.append(f)
    stale = sorted(k for k, n in remaining.items() if n > 0)
    return new, matched, stale
