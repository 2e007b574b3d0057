"""Wire/ABI parity: Python framing constants vs ``native/*.cc`` literals.

The codec is implemented twice — ``types/columnar.py`` / ``types/
tensor.py`` on the Python side and ``native/codec.cc`` + the transport
shims on the C++ side — and the two only interoperate while every
magic, version id, kind byte, dtype tag, and header layout agrees.
This pass folds the Python constants out of the AST and scrapes the
same literals out of the native sources (nothing is hardcoded in the
checker: mutate a byte in either artifact and the check fails), then
asserts pairwise equality:

* WIRE01 — a value disagrees between the two sides (or a Python-side
  self-consistency pair disagrees, e.g. ``MAGIC_BYTES`` vs the folded
  little-endian ``_BLOB_MAGIC``).
* WIRE02 — a symbol one side of a parity pair relies on cannot be
  extracted any more (renamed/deleted): the check would silently stop
  checking, so the disappearance is itself a finding.

Python-only constants with no native twin (``RLW2``/``RLS1``/``RLB1``
magics, nack codes, heartbeat codes) are inventoried so the committed
``contracts.json`` pins them, and their 4-byte-ascii shape is checked.

When ``native/`` is absent (installed wheel), the native half degrades
to inventory-only.
"""

from __future__ import annotations

import ast
import os
import re
import struct

from relayrl_tpu_torch.analysis.contracts.base import (
    ContractContext,
    ParsedModule,
    const_fold,
)
from relayrl_tpu_torch.analysis.engine import Finding, qualname

NATIVE_SOURCES = ("codec.cc", "transport.cc", "grpc_server.cc",
                  "event_hub.h")

_STRUCT_TO_NATIVE = {"u8": "B", "u16": "H", "u32": "I", "u64": "Q"}


# -- python side ---------------------------------------------------------

class PyConst:
    def __init__(self, value: object, module: ParsedModule,
                 node: ast.AST):
        self.value = value
        self.module = module
        self.node = node


def module_constants(mod: ParsedModule) -> dict[str, PyConst]:
    """Module- and class-level constant assignments, including tuple
    unpacking (``_HB_ALIVE, _HB_SLOW, _HB_DEAD = 0, 1, 2``) and
    ``struct.Struct("<fmt")`` (recorded as the format string)."""
    out: dict[str, PyConst] = {}
    scopes: list[list[ast.stmt]] = [mod.tree.body]
    scopes.extend(n.body for n in mod.tree.body
                  if isinstance(n, ast.ClassDef))
    for body in scopes:
        for node in body:
            if not isinstance(node, ast.Assign):
                continue
            if (len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                name = node.targets[0].id
                value = node.value
                if (isinstance(value, ast.Call)
                        and (qualname(value.func) or "").endswith("Struct")
                        and value.args
                        and isinstance(value.args[0], ast.Constant)
                        and isinstance(value.args[0].value, str)):
                    out[name] = PyConst(value.args[0].value, mod, node)
                    continue
                ok, folded = const_fold(value)
                if ok:
                    out[name] = PyConst(folded, mod, node)
            elif (len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Tuple)
                    and isinstance(node.value, ast.Tuple)):
                names = node.targets[0].elts
                values = node.value.elts
                if len(names) != len(values):
                    continue
                for tgt, val in zip(names, values):
                    if isinstance(tgt, ast.Name):
                        ok, folded = const_fold(val)
                        if ok:
                            out[tgt.id] = PyConst(folded, mod, node)
    return out


def extract_dtype_tags(ctx: ContractContext) -> tuple[
        dict[int, str], ParsedModule | None, ast.AST | None]:
    """The ``DType`` IntEnum: tag value -> member name."""
    mod = ctx.module(os.path.join("types", "dtypes.py"))
    if mod is None:
        return {}, None, None
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "DType":
            tags: dict[int, str] = {}
            for item in node.body:
                if (isinstance(item, ast.Assign)
                        and len(item.targets) == 1
                        and isinstance(item.targets[0], ast.Name)):
                    ok, value = const_fold(item.value)
                    if ok and isinstance(value, int):
                        tags[value] = item.targets[0].id
            return tags, mod, node
    return {}, mod, None


def _python_itemsizes(tags: dict[int, str]) -> dict[int, int]:
    """Per-tag numpy itemsize via the dtypes module's own mapping.
    Importing types/dtypes.py is the one exception to the no-import
    rule: it is a leaf module (stdlib + numpy) and the itemsize truth
    lives in numpy, not in any literal we could fold. Degrades to {}
    when numpy/ml_dtypes is unavailable on the analysis host."""
    try:
        from relayrl_tpu_torch.types import dtypes as _dt

        return {tag: int(_dt.itemsize(_dt.DType(tag))) for tag in tags}
    except Exception:
        return {}


# -- native side ---------------------------------------------------------

class NativeText:
    def __init__(self, relpath: str, text: str):
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()

    def line_of(self, pattern: str) -> int:
        rx = re.compile(pattern)
        for i, line in enumerate(self.lines, start=1):
            if rx.search(line):
                return i
        return 1


def load_native(ctx: ContractContext) -> dict[str, NativeText]:
    out: dict[str, NativeText] = {}
    if ctx.native_root is None:
        return out
    for name in NATIVE_SOURCES:
        path = os.path.join(ctx.native_root, name)
        text = ctx.read_text(path)
        if text is not None:
            out[name] = NativeText(ctx.rel(path), text)
    return out


def scrape_int(native: NativeText, pattern: str) -> tuple[int, int] | None:
    """First regex capture as an int (hex or decimal) plus its 1-based
    line number."""
    rx = re.compile(pattern)
    for i, line in enumerate(native.lines, start=1):
        m = rx.search(line)
        if m:
            return int(m.group(1), 0), i
    return None


def scrape_case_table(native: NativeText,
                      func_name: str) -> dict[int, int]:
    """``case N: return M;`` rows inside one function body."""
    body = _function_body(native, func_name)
    return {int(m.group(1)): int(m.group(2))
            for m in re.finditer(r"case\s+(\d+)\s*:\s*return\s+(\d+)\s*;",
                                 body)}


def _function_body(native: NativeText, func_name: str) -> str:
    start = None
    for i, line in enumerate(native.lines):
        if func_name in line and "(" in line:
            start = i
            break
    if start is None:
        return ""
    depth = 0
    out: list[str] = []
    for line in native.lines[start:]:
        out.append(line)
        depth += line.count("{") - line.count("}")
        if depth <= 0 and "{" in "".join(out):
            break
    return "\n".join(out)


def scrape_writer_layout(native: NativeText, func_name: str) -> str:
    """A ``BlobWriter`` function's fixed-header field sequence as a
    little-endian struct format (``w.u32(..) w.u8(..)`` -> ``<IB``;
    stops at the first variable-length ``raw(id, ..)``). ``raw(&v, 2)``
    of a u16 lvalue counts as ``H``."""
    body = _function_body(native, func_name)
    fmt = ""
    for m in re.finditer(
            r"w\.(u8|u16|u32|u64)\(|w\.raw\(\s*&\w+\s*,\s*(\d+)\s*\)"
            r"|w\.raw\(", body):
        if m.group(1):
            fmt += _STRUCT_TO_NATIVE[m.group(1)]
        elif m.group(2):
            fmt += {1: "B", 2: "H", 4: "I", 8: "Q"}[int(m.group(2))]
        else:
            break  # variable-length payload: fixed header ends here
    return "<" + fmt


def scrape_call_args(native: NativeText,
                     call: str) -> list[tuple[int, int]]:
    """Every ``call(N, ...)`` site with a literal first argument ->
    ``(value, line)`` (the definition ``call(int type`` never matches)."""
    rx = re.compile(re.escape(call) + r"\(\s*(\d+)\s*,")
    return [(int(m.group(1)), i)
            for i, line in enumerate(native.lines, start=1)
            for m in [rx.search(line)] if m]


# -- the pass ------------------------------------------------------------

def run(ctx: ContractContext) -> tuple[list[Finding], dict]:
    findings: list[Finding] = []

    def add(code: str, name: str, message: str, **kw) -> None:
        f = ctx.finding(code, name, message, **kw)
        if f is not None:
            findings.append(f)

    mods = {
        "columnar": ctx.module(os.path.join("types", "columnar.py")),
        "tensor": ctx.module(os.path.join("types", "tensor.py")),
        "modelwire": ctx.module(os.path.join("transport", "modelwire.py")),
        "tbase": ctx.module(os.path.join("transport", "base.py")),
        "aggregate": ctx.module(os.path.join("telemetry", "aggregate.py")),
        "bindings": ctx.module(os.path.join("transport",
                                            "native_bindings.py")),
    }
    consts = {key: (module_constants(m) if m is not None else {})
              for key, m in mods.items()}

    def need(modkey: str, name: str) -> PyConst | None:
        got = consts[modkey].get(name)
        if got is None and mods[modkey] is not None:
            add("WIRE02", "wire-symbol-missing",
                f"expected constant `{name}` is no longer extractable "
                f"from {mods[modkey].relpath} — the parity check went "
                f"blind on it",
                path=mods[modkey].relpath, line=1, snippet=name)
        return got

    # -- python self-consistency pairs ----------------------------------
    blob_magic = need("columnar", "_BLOB_MAGIC")
    magic_bytes = need("columnar", "MAGIC_BYTES")
    if blob_magic and magic_bytes \
            and isinstance(blob_magic.value, int) \
            and isinstance(magic_bytes.value, bytes):
        if struct.pack("<I", blob_magic.value) != magic_bytes.value:
            add("WIRE01", "wire-parity-mismatch",
                f"columnar MAGIC_BYTES {magic_bytes.value!r} is not the "
                f"little-endian encoding of _BLOB_MAGIC "
                f"{blob_magic.value:#x}",
                module=magic_bytes.module, node=magic_bytes.node)

    for modkey, name in (("columnar", "MAGIC_BYTES"),
                         ("modelwire", "MAGIC"),
                         ("tbase", "BATCH_MAGIC"),
                         ("aggregate", "SNAP_MAGIC")):
        c = need(modkey, name)
        if c and (not isinstance(c.value, bytes) or len(c.value) != 4
                  or not c.value.isascii()):
            add("WIRE01", "wire-parity-mismatch",
                f"{name} {c.value!r} must be exactly 4 ascii bytes — "
                f"every peer sniffs frames on a 4-byte magic prefix",
                module=c.module, node=c.node)

    # -- native parity ---------------------------------------------------
    native = load_native(ctx)
    codec = native.get("codec.cc")
    inventory_native: dict[str, object] = {}

    def native_int(src: NativeText | None, symbol: str,
                   pattern: str) -> tuple[int, int] | None:
        if src is None:
            return None
        got = scrape_int(src, pattern)
        if got is None:
            add("WIRE02", "wire-symbol-missing",
                f"`{symbol}` is no longer extractable from {src.relpath} "
                f"— the parity check went blind on it",
                path=src.relpath, line=1, snippet=symbol)
        return got

    def parity(py: PyConst | None, native_got: tuple[int, int] | None,
               src: NativeText, what: str) -> None:
        if py is None or native_got is None:
            return
        value, line = native_got
        if py.value != value:
            add("WIRE01", "wire-parity-mismatch",
                f"{what}: python side has {py.value!r} but "
                f"{src.relpath}:{line} has {value:#x} ({value}) — the "
                f"two codecs no longer interoperate",
                module=py.module, node=py.node)

    if codec is not None:
        k_blob = native_int(codec, "kBlobMagic",
                            r"kBlobMagic\s*=\s*(0x[0-9A-Fa-f]+|\d+)")
        parity(blob_magic, k_blob, codec, "blob magic (RLD1)")
        if k_blob:
            inventory_native["kBlobMagic"] = k_blob[0]

        k_tensor = native_int(codec, "kTensorMagic",
                              r"kTensorMagic\s*=\s*(0x[0-9A-Fa-f]+|\d+)")
        parity(need("tensor", "_MAGIC"), k_tensor, codec,
               "tensor frame magic")
        if k_tensor:
            inventory_native["kTensorMagic"] = k_tensor[0]

        n_version = native_int(codec, "tensor version check",
                               r"buf\[2\]\s*!=\s*(\d+)")
        parity(need("tensor", "_VERSION"), n_version, codec,
               "tensor frame version")

        # raw-blob kind bytes: `is_envelope ? 3 : 1`
        kinds = scrape_int(codec, r"is_envelope\s*\?\s*(\d+)")
        plain = scrape_int(codec, r"is_envelope\s*\?\s*\d+\s*:\s*(\d+)")
        if kinds is None or plain is None:
            add("WIRE02", "wire-symbol-missing",
                "write_raw_blob's `is_envelope ? K : K` kind bytes are "
                f"no longer extractable from {codec.relpath}",
                path=codec.relpath, line=1, snippet="is_envelope")
        else:
            parity(need("columnar", "KIND_RAW_ENVELOPE"), kinds, codec,
                   "raw-envelope blob kind byte")
            parity(need("columnar", "KIND_RAW"), plain, codec,
                   "raw blob kind byte")

        # blob header layout: u32 magic | u8 kind | u32 id_len
        hdr = need("columnar", "_HDR")
        layout = scrape_writer_layout(codec, "write_blob_header")
        if hdr is not None:
            if layout == "<":
                add("WIRE02", "wire-symbol-missing",
                    f"write_blob_header's field sequence is no longer "
                    f"extractable from {codec.relpath}",
                    path=codec.relpath, line=1,
                    snippet="write_blob_header")
            elif hdr.value != layout:
                add("WIRE01", "wire-parity-mismatch",
                    f"blob header layout: python _HDR is "
                    f"{hdr.value!r} but {codec.relpath}'s "
                    f"write_blob_header emits {layout!r}",
                    module=hdr.module, node=hdr.node)

        # tensor frame header: u32 frame length, then the _HEADER fields
        theader = need("tensor", "_HEADER")
        tlayout = scrape_writer_layout(codec, "write_tensor_frame")
        if theader is not None and tlayout.startswith("<I"):
            tlayout = "<" + tlayout[2:]  # drop the frame-length prefix
            if tlayout[:len(str(theader.value))] != theader.value:
                add("WIRE01", "wire-parity-mismatch",
                    f"tensor header layout: python _HEADER is "
                    f"{theader.value!r} but {codec.relpath}'s "
                    f"write_tensor_frame emits {tlayout!r} after the "
                    f"frame-length prefix",
                    module=theader.module, node=theader.node)

        # dtype tag -> itemsize table
        tags, dtypes_mod, dtypes_node = extract_dtype_tags(ctx)
        table = scrape_case_table(codec, "dtype_itemsize")
        if not table:
            add("WIRE02", "wire-symbol-missing",
                f"dtype_itemsize's case table is no longer extractable "
                f"from {codec.relpath}",
                path=codec.relpath, line=1, snippet="dtype_itemsize")
        elif tags and dtypes_mod is not None:
            for tag in sorted(set(tags) - set(table)):
                add("WIRE01", "wire-parity-mismatch",
                    f"dtype tag {tag} ({tags[tag]}) has no itemsize row "
                    f"in {codec.relpath}'s dtype_itemsize — native peers "
                    f"reject frames python emits",
                    module=dtypes_mod, node=dtypes_node)
            for tag in sorted(set(table) - set(tags)):
                add("WIRE01", "wire-parity-mismatch",
                    f"{codec.relpath}'s dtype_itemsize knows tag {tag} "
                    f"but the python DType enum does not",
                    path=codec.relpath,
                    line=codec.line_of(rf"case\s+{tag}\s*:"),
                    snippet=f"case {tag}")
            sizes = _python_itemsizes(tags)
            for tag in sorted(set(tags) & set(table)):
                if tag in sizes and sizes[tag] != table[tag]:
                    add("WIRE01", "wire-parity-mismatch",
                        f"dtype tag {tag} ({tags[tag]}) is "
                        f"{sizes[tag]} bytes in python but "
                        f"{codec.relpath}'s dtype_itemsize says "
                        f"{table[tag]}",
                        module=dtypes_mod, node=dtypes_node)
            inventory_native["dtype_itemsize"] = {
                str(k): v for k, v in sorted(table.items())}

    # event-kind bytes pushed by the native ingest paths
    push_sites: list[tuple[int, int, NativeText]] = []
    for name in ("transport.cc", "grpc_server.cc"):
        src = native.get(name)
        if src is not None:
            push_sites.extend((v, ln, src)
                              for v, ln in scrape_call_args(src,
                                                            "push_event"))
    if push_sites:
        pushed = sorted({v for v, _ln, _src in push_sites})
        ev = {n: need("bindings", n) for n in
              ("_EV_TRAJECTORY", "_EV_REGISTER", "_EV_UNREGISTER")}
        expected = sorted(c.value for c in ev.values()
                          if c is not None and isinstance(c.value, int))
        if expected and pushed != expected:
            first_v, first_ln, first_src = push_sites[0]
            add("WIRE01", "wire-parity-mismatch",
                f"native ingest pushes event-type bytes {pushed} but "
                f"transport/native_bindings.py expects {expected} "
                f"(_EV_TRAJECTORY/_EV_REGISTER/_EV_UNREGISTER)",
                path=first_src.relpath, line=first_ln,
                snippet=f"push_event({first_v}, ...)")
        inventory_native["push_event_types"] = pushed

    hub = native.get("event_hub.h")
    if hub is not None:
        m = re.search(r"e\.type\s*==\s*(\d+)\s*\?\s*(\d+)\s*:\s*(\d+)",
                      hub.text)
        if m is None:
            add("WIRE02", "wire-symbol-missing",
                f"event_hub's register/unregister kind mapping is no "
                f"longer extractable from {hub.relpath}",
                path=hub.relpath, line=1, snippet="e.type")
        else:
            reg, unreg = int(m.group(2)), int(m.group(3))
            line = hub.line_of(r"e\.type\s*==")
            for pyname, nval in (("KIND_REGISTER", reg),
                                 ("KIND_UNREGISTER", unreg)):
                c = need("columnar", pyname)
                if c is not None and c.value != nval:
                    add("WIRE01", "wire-parity-mismatch",
                        f"{hub.relpath}:{line} maps the "
                        f"{pyname.split('_')[1].lower()} event to blob "
                        f"kind {nval} but types/columnar.py's {pyname} "
                        f"is {c.value!r}",
                        module=c.module, node=c.node)
            inventory_native["event_hub_kinds"] = {"register": reg,
                                                  "unregister": unreg}

    # -- inventory -------------------------------------------------------
    def py_inv(modkey: str, names: tuple[str, ...]) -> dict[str, object]:
        out: dict[str, object] = {}
        for name in names:
            c = consts[modkey].get(name)
            if c is not None:
                out[name] = (c.value.decode("ascii", "replace")
                             if isinstance(c.value, bytes) else c.value)
        return out

    inventory = {
        "python": {
            "columnar": py_inv("columnar", (
                "_BLOB_MAGIC", "MAGIC_BYTES", "KIND_COLUMNAR", "KIND_RAW",
                "KIND_REGISTER", "KIND_RAW_ENVELOPE", "KIND_UNREGISTER",
                "FRAME_VERSION", "FLAG_FOOTER", "_HDR", "_COL_FIXED",
                "_META", "_FOOTER")),
            "tensor": py_inv("tensor", ("_MAGIC", "_VERSION", "_HEADER")),
            "modelwire": py_inv("modelwire", (
                "MAGIC", "KIND_KEYFRAME", "KIND_DELTA", "KIND_CHUNK")),
            "transport_base": py_inv("tbase", (
                "BATCH_MAGIC", "BATCH_KIND_ENVELOPES", "BATCH_KIND_FRAMES",
                "NACK_OK", "NACK_MALFORMED", "NACK_QUARANTINED",
                "NACK_OVERLOADED", "NACK_UNAVAILABLE")),
            "aggregate": py_inv("aggregate", ("SNAP_MAGIC",
                                              "FRAME_VERSION")),
            "native_bindings": py_inv("bindings", (
                "_EV_TRAJECTORY", "_EV_REGISTER", "_EV_UNREGISTER",
                "_HB_ALIVE", "_HB_SLOW", "_HB_DEAD")),
        },
        "native": {k: inventory_native[k]
                   for k in sorted(inventory_native)},
    }
    return findings, inventory
