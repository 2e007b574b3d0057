"""Shared infrastructure for the contracts engine.

Everything here is pure stdlib + AST, like the torchlint engine: contract
extraction must run on accelerator-free CI hosts and must not import the
modules it audits (a module with an import-time bug still gets checked).

:class:`ContractContext` resolves the artifact roots once — the
installed port, the enclosing repo (docs/, native/, tests/,
pytest.ini) — caches parsed modules, and constructs
:class:`~relayrl_tpu_torch.analysis.engine.Finding` objects that honor
the same ``# torchlint: disable=CODE`` per-line suppression torchlint
uses, so one suppression mechanism covers both engines. The repo
artifacts are the ones the JAX package is checked against too: the
port registers the same metrics, ships the same knobs and frames the
same wire, so the same docs and native sources are its catalog.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Any, Iterator, Sequence

from relayrl_tpu_torch.analysis.engine import (
    Finding,
    ModuleInfo,
    _enclosing_repo_root,
    _suppressed_rules,
    iter_python_files,
    statement_end_line,
)

__all__ = [
    "ContractContext",
    "ParsedModule",
    "const_fold",
    "iter_md_tables",
    "strip_cell",
]


class ParsedModule:
    """One parsed source file plus its display path and import aliases
    (reuses :class:`ModuleInfo` so passes get ``resolve``/``qualname``
    semantics identical to the torchlint rules)."""

    def __init__(self, abspath: str, relpath: str, source: str):
        self.abspath = abspath
        self.relpath = relpath  # posix, repo-root anchored
        self.info = ModuleInfo(path=relpath, source=source,
                               tree=ast.parse(source))

    @property
    def tree(self) -> ast.Module:
        return self.info.tree

    @property
    def lines(self) -> list[str]:
        return self.info.lines

    @property
    def dotted(self) -> str:
        """Dotted module name relative to the scan base
        (``relayrl_tpu_torch/transport/base.py`` ->
        "relayrl_tpu_torch.transport.base")."""
        name = self.relpath[:-3] if self.relpath.endswith(".py") else self.relpath
        name = name.replace("/", ".")
        return name[:-9] if name.endswith(".__init__") else name


class ContractContext:
    """Artifact roots + parsed-module cache for one contracts run.

    ``package_root`` is the python tree the passes walk (default: the
    installed ``relayrl_tpu_torch`` package). The repo artifacts — docs,
    native sources, tests, pytest.ini — resolve from the enclosing repo
    root when one exists; each pass degrades gracefully (skips its
    cross-artifact half) when its artifact is absent, so the engine
    still runs against an installed wheel. Tests override individual
    roots to aim passes at synthetic fixtures.
    """

    def __init__(self, package_root: str | None = None,
                 repo_root: str | None = None,
                 native_root: str | None = None,
                 docs_root: str | None = None,
                 tests_root: str | None = None,
                 pytest_ini: str | None = None):
        if package_root is None:
            import relayrl_tpu_torch

            package_root = os.path.dirname(
                os.path.abspath(relayrl_tpu_torch.__file__))
        self.package_root = os.path.abspath(str(package_root))
        if repo_root is None:
            repo_root = _enclosing_repo_root(self.package_root)
        self.repo_root = (os.path.abspath(str(repo_root))
                          if repo_root else None)
        base = self.repo_root or os.path.dirname(self.package_root)
        self.display_base = base

        def _default(sub: str) -> str | None:
            if self.repo_root is None:
                return None
            cand = os.path.join(self.repo_root, sub)
            return cand if os.path.exists(cand) else None

        self.native_root = (os.path.abspath(str(native_root))
                            if native_root else _default("native"))
        self.docs_root = (os.path.abspath(str(docs_root))
                          if docs_root else _default("docs"))
        self.tests_root = (os.path.abspath(str(tests_root))
                           if tests_root else _default("tests"))
        self.pytest_ini = (os.path.abspath(str(pytest_ini))
                           if pytest_ini else _default("pytest.ini"))
        self._modules: list[ParsedModule] | None = None
        self._texts: dict[str, str] = {}

    # -- file access -----------------------------------------------------
    def rel(self, abspath: str) -> str:
        return os.path.relpath(abspath, self.display_base).replace(
            os.sep, "/")

    def read_text(self, abspath: str) -> str | None:
        if abspath not in self._texts:
            try:
                with open(abspath, "r", encoding="utf-8") as f:
                    self._texts[abspath] = f.read()
            except OSError:
                return None
        return self._texts[abspath]

    def package_modules(self) -> list[ParsedModule]:
        """Every parseable .py file under ``package_root`` (parse errors
        are torchlint's PARSE finding's job — contracts skip them)."""
        if self._modules is None:
            mods: list[ParsedModule] = []
            for path in iter_python_files(self.package_root):
                source = self.read_text(path)
                if source is None:
                    continue
                try:
                    mods.append(ParsedModule(path, self.rel(path), source))
                except SyntaxError:
                    continue
            self._modules = mods
        return self._modules

    def module(self, rel_under_package: str) -> ParsedModule | None:
        """Look up one package module by its package-relative path
        (``telemetry/events.py``)."""
        want = os.path.join(self.package_root, rel_under_package)
        want = os.path.abspath(want)
        for mod in self.package_modules():
            if mod.abspath == want:
                return mod
        return None

    # -- findings --------------------------------------------------------
    def finding(self, code: str, name: str, message: str,
                module: ParsedModule | None = None,
                node: ast.AST | None = None,
                path: str | None = None, line: int = 1,
                snippet: str = "") -> Finding | None:
        """Build one contract finding. Anchored in a python module, the
        torchlint suppression comment applies (``# torchlint: disable=MET03
        - reason``) and returns None when suppressed; doc/native/json
        anchors have no per-line suppression (use the baseline)."""
        if module is not None and node is not None:
            line = getattr(node, "lineno", 1)
            path = module.relpath
            if 1 <= line <= len(module.lines):
                snippet = module.lines[line - 1].strip()
            disabled = _suppressed_rules(module.lines, line,
                                         statement_end_line(node))
            if disabled & {"all", code.lower(), name.lower()}:
                return None
        return Finding(rule=code, name=name, path=path or "<contracts>",
                       line=line, col=1, message=message, snippet=snippet)


# -- constant folding ----------------------------------------------------

def const_fold(node: ast.AST) -> tuple[bool, Any]:
    """Evaluate a literal-ish expression: constants, +/- and bit-shift
    arithmetic on constants (``64 << 20``), tuples/lists/dicts of the
    same. Returns ``(ok, value)`` — the config/wire extractors must
    never execute repo code, only fold what's written down."""
    if isinstance(node, ast.Constant):
        return True, node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        ok, v = const_fold(node.operand)
        return (True, -v) if ok and isinstance(v, (int, float)) else (False, None)
    if isinstance(node, ast.BinOp):
        lok, lv = const_fold(node.left)
        rok, rv = const_fold(node.right)
        if not (lok and rok):
            return False, None
        try:
            if isinstance(node.op, ast.LShift):
                return True, lv << rv
            if isinstance(node.op, ast.RShift):
                return True, lv >> rv
            if isinstance(node.op, ast.Add):
                return True, lv + rv
            if isinstance(node.op, ast.Sub):
                return True, lv - rv
            if isinstance(node.op, ast.Mult):
                return True, lv * rv
            if isinstance(node.op, ast.Div):
                return True, lv / rv
            if isinstance(node.op, ast.Pow):
                return True, lv ** rv
        except (TypeError, ValueError, ZeroDivisionError):
            return False, None
        return False, None
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            ok, v = const_fold(elt)
            if not ok:
                return False, None
            out.append(v)
        return True, (tuple(out) if isinstance(node, ast.Tuple) else out)
    if isinstance(node, ast.Dict):
        d: dict[Any, Any] = {}
        for k, v in zip(node.keys, node.values):
            if k is None:
                return False, None
            kok, kv = const_fold(k)
            vok, vv = const_fold(v)
            if not (kok and vok):
                return False, None
            d[kv] = vv
        return True, d
    return False, None


# -- markdown tables -----------------------------------------------------

_CODE_SPAN_RE = re.compile(r"`([^`]+)`")


def iter_md_tables(text: str) -> Iterator[tuple[str, list[str],
                                                list[tuple[int, list[str]]]]]:
    """Yield ``(nearest_heading, header_cells, rows)`` for every pipe
    table; each row is ``(1-based line number, cells)``. Good enough for
    the repo's hand-written GFM tables; ``\\|`` inside a cell (label
    enumerations like ``{plane=model\\|trajectory}``) stays one cell."""
    heading = ""
    in_fence = False
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.lstrip().startswith("```"):
            in_fence = not in_fence
            i += 1
            continue
        if in_fence:
            # a shell comment inside a code fence is not a heading, and
            # a table-looking line inside one is not a table
            i += 1
            continue
        if line.startswith("#"):
            heading = line.lstrip("#").strip()
            i += 1
            continue
        if (line.lstrip().startswith("|") and i + 1 < len(lines)
                and re.match(r"^\s*\|[\s:|-]+\|\s*$", lines[i + 1])):
            header = _cells(line)
            rows: list[tuple[int, list[str]]] = []
            j = i + 2
            while j < len(lines) and lines[j].lstrip().startswith("|"):
                rows.append((j + 1, _cells(lines[j])))
                j += 1
            yield heading, header, rows
            i = j
            continue
        i += 1


def _cells(row: str) -> list[str]:
    parts = re.split(r"(?<!\\)\|", row.strip().strip("|"))
    return [p.strip().replace("\\|", "|") for p in parts]


def strip_cell(cell: str) -> str:
    """First code-span content of a table cell, else the bare text."""
    m = _CODE_SPAN_RE.search(cell)
    return m.group(1).strip() if m else cell.strip()


def code_spans(cell: str) -> list[str]:
    return [m.group(1).strip() for m in _CODE_SPAN_RE.finditer(cell)]


def walk_functions(tree: ast.Module) -> Iterator[
        tuple[str | None, ast.FunctionDef | ast.AsyncFunctionDef]]:
    """Yield ``(class_name_or_None, function_def)`` for every module- or
    class-level function (nested defs belong to their parent's body and
    are not separate analysis units here)."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield None, node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    yield node.name, item


def first_str(call: ast.Call) -> str | None:
    """The first positional argument when it is a string literal."""
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def sorted_findings(findings: Sequence[Finding]) -> list[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule,
                                           f.message))
