"""Config contract: defaults vs loader clamps vs read sites vs docs.

The same knob is written down in up to four places — the
``DEFAULT_CONFIG`` literal, a hardcoded fallback in the loader's
``get_*_params`` clamp, the read site that consumes it, and the
operations.md / observability.md knob tables. Each pair can drift
silently; this pass folds all four out of the AST/markdown and
cross-checks:

* CFG01 — a config key read (loader clamp or section-dict read site)
  that has no shipped default: a typo'd knob or one users can't
  discover from the default config.
* CFG02 — a shipped default whose key name appears nowhere in the
  package: a dead knob nothing will ever read.
* CFG03 — the loader's hardcoded fallback disagrees with the shipped
  default (the two-defaults bug class: behavior depends on whether the
  section is present in the user's file).
* CFG04 — a doc knob-table default disagrees with the shipped default.
* CFG05 — an operational knob with no knob-table row in the docs.
* CFG06 — a documented knob that does not exist in the defaults.
"""

from __future__ import annotations

import ast
import os

from relayrl_tpu_torch.analysis.contracts.base import (
    ContractContext,
    ParsedModule,
    code_spans,
    const_fold,
    iter_md_tables,
    walk_functions,
)
from relayrl_tpu_torch.analysis.engine import Finding, qualname

# Sections whose knobs the operations/observability knob tables own.
DOC_SECTIONS = frozenset({"actor", "transport", "guardrails", "serving",
                          "relay", "rlhf", "telemetry", "learner"})
# The open-ended algorithms section is exempt everywhere: hyperparams
# are a per-plugin namespace, not a closed contract.
_OPEN_SECTIONS = frozenset({"algorithms"})

_GETTER_SECTION = {
    "get_actor_params": "actor",
    "get_transport_params": "transport",
    "get_guardrails_params": "guardrails",
    "get_serving_params": "serving",
    "get_relay_params": "relay",
    "get_rlhf_params": "rlhf",
    "get_telemetry_params": "telemetry",
    "get_learner_params": "learner",
    "get_tb_params": "training_tensorboard",
    "get_max_traj_length": "",
    "get_grpc_idle_timeout_s": "",
}

_UNPARSED = object()

KNOB_DOCS = ("operations.md", "observability.md")


# -- defaults ------------------------------------------------------------

def extract_defaults(ctx: ContractContext) -> tuple[
        dict[str, object], ParsedModule | None, int]:
    """Flatten the ``DEFAULT_CONFIG`` literal to dotted leaf keys
    (``guardrails.strike_threshold``; ``_comment*`` keys and the
    open-ended algorithms section excluded)."""
    mod = ctx.module(os.path.join("config", "default_config.py"))
    if mod is None:
        return {}, None, 1
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target, value_node = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.value is not None:
            target, value_node = node.target.id, node.value
        else:
            continue
        if target == "DEFAULT_CONFIG":
            ok, value = const_fold(value_node)
            if not ok or not isinstance(value, dict):
                return {}, mod, node.lineno
            flat: dict[str, object] = {}

            def descend(prefix: str, obj: object) -> None:
                if isinstance(obj, dict):
                    for k, v in obj.items():
                        if str(k).startswith("_comment"):
                            continue
                        descend(f"{prefix}.{k}" if prefix else str(k), v)
                else:
                    flat[prefix] = obj

            for key, val in value.items():
                if str(key).startswith("_comment") or key in _OPEN_SECTIONS:
                    continue
                descend(str(key), val)
            return flat, mod, node.lineno
    return {}, mod, 1


# -- loader clamps -------------------------------------------------------

class Clamp:
    def __init__(self, section: str, key: str, default: object,
                 node: ast.AST):
        self.section = section
        self.key = key
        self.default = default
        self.node = node

    @property
    def dotted(self) -> str:
        return f"{self.section}.{self.key}" if self.section else self.key


def _get_call_clamp(node: ast.Call) -> tuple[str, object] | None:
    """``params.get("key", default)`` (const default) -> (key, default)."""
    if not (isinstance(node.func, ast.Attribute)
            and node.func.attr == "get" and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)):
        return None
    receiver = qualname(node.func.value) or ""
    if receiver.split(".")[-1] not in ("params", "_raw"):
        return None
    key = node.args[0].value
    if len(node.args) >= 2:
        ok, default = const_fold(node.args[1])
        return (key, default if ok else _UNPARSED)
    return (key, _UNPARSED)


def extract_clamps(ctx: ContractContext) -> tuple[list[Clamp],
                                                  ParsedModule | None]:
    """Hardcoded fallbacks in config/loader.py: ``params.get(key,
    default)`` / ``params.get(key) or default`` call sites and the
    ``for key, default[, lo] in ((...), ...)`` clamp tables, attributed
    to their getter's section; plus the ``_FALLBACK_ENDPOINTS`` ports."""
    mod = ctx.module(os.path.join("config", "loader.py"))
    if mod is None:
        return [], None
    clamps: list[Clamp] = []
    for cls, func in walk_functions(mod.tree):
        section = _GETTER_SECTION.get(func.name)
        if cls != "ConfigLoader" or section is None:
            continue
        for node in ast.walk(func):
            # the clamp-table idiom: for key, default[, lo] in ((...),)
            if (isinstance(node, ast.For)
                    and isinstance(node.target, ast.Tuple)
                    and isinstance(node.iter, (ast.Tuple, ast.List))):
                names = [t.id for t in node.target.elts
                         if isinstance(t, ast.Name)]
                if len(names) < 2 or names[0] != "key" \
                        or names[1] != "default":
                    continue
                for entry in node.iter.elts:
                    ok, row = const_fold(entry)
                    if ok and isinstance(row, tuple) and len(row) >= 2 \
                            and isinstance(row[0], str):
                        clamps.append(Clamp(section, row[0], row[1],
                                            entry))
            elif isinstance(node, ast.BoolOp) and isinstance(node.op,
                                                             ast.Or):
                # params.get("key") or default
                first = node.values[0]
                if isinstance(first, ast.Call):
                    got = _get_call_clamp(first)
                    if got and got[1] is _UNPARSED:
                        ok, default = const_fold(node.values[-1])
                        if ok:
                            clamps.append(Clamp(section, got[0], default,
                                                first))
            elif isinstance(node, ast.Call):
                got = _get_call_clamp(node)
                if got and got[1] is not _UNPARSED:
                    clamps.append(Clamp(section, got[0], got[1], node))
    # endpoint fallbacks: _FALLBACK_ENDPOINTS = {"name": Endpoint(port=..)}
    for node in mod.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_FALLBACK_ENDPOINTS"
                and isinstance(node.value, ast.Dict)):
            for k, v in zip(node.value.keys, node.value.values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(v, ast.Call)):
                    continue
                for kw in v.keywords:
                    if kw.arg == "port":
                        ok, port = const_fold(kw.value)
                        if ok:
                            clamps.append(Clamp(
                                "server", f"{k.value}.port", port, v))
    return clamps, mod


# -- read sites ----------------------------------------------------------

class ReadSite:
    def __init__(self, section: str, key: str, has_default: bool,
                 module: ParsedModule, node: ast.AST):
        self.section = section
        self.key = key
        self.has_default = has_default
        self.module = module
        self.node = node


_GETTER_NAMES = {name: sec for name, sec in _GETTER_SECTION.items()
                 if sec and name.endswith("_params")}


def extract_read_sites(ctx: ContractContext) -> list[ReadSite]:
    """Reads of keys on section dicts obtained from ``get_*_params()``:
    both local variables (``p = cfg.get_serving_params(); p["x"]``) and
    instance attributes assigned anywhere in the same class."""
    sites: list[ReadSite] = []
    for mod in ctx.package_modules():
        if mod.relpath.endswith("config/loader.py"):
            continue  # the loader's own reads are the clamp extraction
        for node in ast.iter_child_nodes(mod.tree):
            if isinstance(node, ast.ClassDef):
                sites.extend(_class_sites(mod, node))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sites.extend(_function_sites(mod, node, {}))
    return sites


def _getter_section_of(call: ast.Call) -> str | None:
    if isinstance(call.func, ast.Attribute):
        return _GETTER_NAMES.get(call.func.attr)
    return None


def _class_sites(mod: ParsedModule, cls: ast.ClassDef) -> list[ReadSite]:
    attr_sections: dict[str, str] = {}
    for node in ast.walk(cls):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.value, ast.Call)):
            section = _getter_section_of(node.value)
            target = qualname(node.targets[0])
            if section and target and target.startswith("self."):
                attr_sections[target] = section
    out: list[ReadSite] = []
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.extend(_function_sites(mod, item, attr_sections))
    return out


def _function_sites(mod: ParsedModule, func: ast.AST,
                    outer: dict[str, str]) -> list[ReadSite]:
    env = dict(outer)
    for node in ast.walk(func):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.value, ast.Call)):
            section = _getter_section_of(node.value)
            target = qualname(node.targets[0])
            if section and target:
                env[target] = section
    out: list[ReadSite] = []
    for node in ast.walk(func):
        if (isinstance(node, ast.Subscript)
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            receiver = qualname(node.value)
            if receiver in env:
                out.append(ReadSite(env[receiver], node.slice.value,
                                    False, mod, node))
        elif isinstance(node, ast.Call):
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            receiver = qualname(node.func.value)
            if receiver in env:
                out.append(ReadSite(env[receiver], node.args[0].value,
                                    len(node.args) >= 2, mod, node))
    return out


# -- docs ----------------------------------------------------------------

_HEADING_SECTIONS = (
    ("guardrail", "guardrails"),
    ("serving", "serving"),
    ("relay", "relay"),
    ("rlhf", "rlhf"),
    ("telemetry", "telemetry"),
    ("observab", "telemetry"),
    ("model distribution", "transport"),
    ("wire", "transport"),
    ("transport", "transport"),
    ("learner", "learner"),
    ("actor", "actor"),
)


def _heading_section(heading: str) -> str | None:
    low = heading.lower()
    for needle, section in _HEADING_SECTIONS:
        if needle in low:
            return section
    return None


def parse_doc_value(text: str):
    """A knob table's default cell -> python value, or _UNPARSED for
    prose the comparison should skip."""
    raw = text.strip().strip("`").strip()
    raw = raw.split(" (")[0].strip().strip("`").strip()
    if not raw or " " in raw:
        return _UNPARSED
    low = raw.lower()
    if low in ("null", "none"):
        return None
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    if len(raw) >= 2 and raw[0] == raw[-1] and raw[0] in "\"'":
        return raw[1:-1]
    return raw


class DocKnob:
    def __init__(self, dotted: str, value: object, doc_path: str,
                 line: int):
        self.dotted = dotted
        self.value = value
        self.doc_path = doc_path
        self.line = line


def extract_doc_knobs(ctx: ContractContext) -> list[DocKnob]:
    knobs: list[DocKnob] = []
    if ctx.docs_root is None:
        return knobs
    for doc in KNOB_DOCS:
        path = os.path.join(ctx.docs_root, doc)
        text = ctx.read_text(path)
        if text is None:
            continue
        rel = ctx.rel(path)
        for heading, header, rows in iter_md_tables(text):
            if not header or header[0].lower() not in ("knob", "key"):
                continue
            section = _heading_section(heading)
            for line_no, cells in rows:
                if len(cells) < 2:
                    continue
                names = code_spans(cells[0])
                defaults = [c.strip() for c in cells[1].split(" / ")] \
                    if len(names) > 1 else [cells[1]]
                for i, name in enumerate(names):
                    if "." not in name and section is None:
                        continue
                    dotted = name if "." in name else f"{section}.{name}"
                    cell = defaults[i] if i < len(defaults) else ""
                    knobs.append(DocKnob(dotted, parse_doc_value(cell),
                                         rel, line_no))
    return knobs


# -- value comparison ----------------------------------------------------

def _values_agree(doc: object, actual: object) -> bool:
    if doc is _UNPARSED:
        return True
    if isinstance(actual, bool) or isinstance(doc, bool):
        return doc is actual
    if isinstance(doc, (int, float)) and isinstance(actual, (int, float)):
        return float(doc) == float(actual)
    return doc == actual


def _fmt(value: object) -> str:
    return "null" if value is None else repr(value)


# -- the pass ------------------------------------------------------------

def run(ctx: ContractContext) -> tuple[list[Finding], dict]:
    findings: list[Finding] = []

    def add(code: str, name: str, message: str, **kw) -> None:
        f = ctx.finding(code, name, message, **kw)
        if f is not None:
            findings.append(f)

    defaults, defaults_mod, _line = extract_defaults(ctx)
    if not defaults:
        return [], {}
    clamps, loader_mod = extract_clamps(ctx)
    read_sites = extract_read_sites(ctx)

    # CFG01/CFG03 against the loader's clamps
    depth1 = {k for k in defaults}
    for clamp in clamps:
        dotted = clamp.dotted
        if dotted not in defaults:
            # a clamp for a whole sub-dict (e.g. retry) is not a leaf
            if any(k.startswith(dotted + ".") for k in defaults):
                continue
            add("CFG01", "config-read-no-default",
                f"loader falls back for `{dotted}` but default_config.py "
                f"ships no such key — users cannot discover this knob "
                f"from the default config",
                module=loader_mod, node=clamp.node)
        elif clamp.default is not _UNPARSED \
                and not _values_agree(clamp.default, defaults[dotted]):
            add("CFG03", "config-clamp-drift",
                f"loader hardcodes {_fmt(clamp.default)} for `{dotted}` "
                f"but default_config.py ships {_fmt(defaults[dotted])} — "
                f"behavior now depends on whether the user's file has the "
                f"section at all",
                module=loader_mod, node=clamp.node)

    # CFG01 against package read sites on section dicts
    for site in read_sites:
        dotted = f"{site.section}.{site.key}"
        if dotted in depth1:
            continue
        if any(k.startswith(dotted + ".") for k in defaults):
            continue
        how = ("with an inline fallback" if site.has_default
               else "with no fallback")
        add("CFG01", "config-read-no-default",
            f"`{site.section}` section key `{site.key}` is read here "
            f"{how} but default_config.py ships no such key",
            module=site.module, node=site.node)

    # CFG02: dead knobs — the key name appears nowhere in the package
    referenced: set[str] = set()
    for mod in ctx.package_modules():
        if mod is defaults_mod:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                            str):
                referenced.add(node.value)
    for dotted in sorted(defaults):
        leaf = dotted.split(".")[-1]
        if leaf in referenced or dotted in referenced:
            continue
        add("CFG02", "config-dead-knob",
            f"default config ships `{dotted}` but the key name appears "
            f"nowhere in the package — a knob nothing reads",
            module=defaults_mod,
            node=_default_key_node(defaults_mod, leaf) or defaults_mod.tree)

    # docs: CFG04 / CFG05 / CFG06
    doc_knobs = extract_doc_knobs(ctx)
    documented: set[str] = set()
    if doc_knobs:
        for knob in doc_knobs:
            documented.add(knob.dotted)
            if knob.dotted not in defaults:
                if any(k.startswith(knob.dotted + ".")
                       for k in defaults):
                    continue
                add("CFG06", "config-doc-unknown-knob",
                    f"docs document knob `{knob.dotted}` but "
                    f"default_config.py ships no such key",
                    path=knob.doc_path, line=knob.line,
                    snippet=knob.dotted)
            elif not _values_agree(knob.value, defaults[knob.dotted]):
                add("CFG04", "config-doc-drift",
                    f"docs say `{knob.dotted}` defaults to "
                    f"{_fmt(knob.value)} but default_config.py ships "
                    f"{_fmt(defaults[knob.dotted])}",
                    path=knob.doc_path, line=knob.line,
                    snippet=knob.dotted)
        for dotted in sorted(defaults):
            parts = dotted.split(".")
            if parts[0] not in DOC_SECTIONS or len(parts) != 2:
                continue  # nested sub-policies document with the consumer
            if dotted not in documented:
                add("CFG05", "config-undocumented-knob",
                    f"operational knob `{dotted}` has no knob-table row "
                    f"in docs/operations.md or docs/observability.md",
                    module=defaults_mod,
                    node=_default_key_node(defaults_mod, parts[1])
                    or defaults_mod.tree)

    inventory = {
        "defaults": {k: _jsonable(v) for k, v in sorted(defaults.items())},
        "clamps": {c.dotted: _jsonable(c.default) for c in clamps
                   if c.default is not _UNPARSED},
        "documented_knobs": sorted(documented),
    }
    return findings, inventory


def _default_key_node(mod: ParsedModule | None, leaf: str) -> ast.AST | None:
    """The literal key node inside DEFAULT_CONFIG, for a precise anchor."""
    if mod is None:
        return None
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Constant) and node.value == leaf:
            return node
    return None


def _jsonable(value: object) -> object:
    if isinstance(value, tuple):
        return [_jsonable(v) for v in value]
    if isinstance(value, list):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return repr(value)
