"""The port's contracts engine (relayrl_tpu_torch.analysis.contracts),
held to the JAX package's on the same fixtures.

Each contract code has a positive and a negative case. The passes are
copies, so on a synthetic fixture both engines must report the same
findings (rule, path, line, message) once package names are normalised;
the one extension, the telemetry pass's fold of ``(name, help)`` tuple
constants, is shown clearing the two false MET06s the reference reports
on the port. The gate tests pin the port's committed ``contracts.json``
to a fresh extraction.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import textwrap

import pytest

from relayrl_tpu.analysis import contracts as ref_contracts
from relayrl_tpu.analysis.contracts import (
    concurrency_pass as ref_concurrency,
    config_pass as ref_config,
    markers_pass as ref_markers,
    telemetry_pass as ref_telemetry,
    wire_pass as ref_wire,
)
from relayrl_tpu_torch.analysis import contracts as port_contracts
from relayrl_tpu_torch.analysis.contracts import (
    CONTRACT_RULES,
    ContractContext,
    concurrency_pass,
    config_pass,
    markers_pass,
    run_contracts,
    serialize_inventory,
    telemetry_pass,
    wire_pass,
)
from relayrl_tpu_torch.analysis.contracts.inventory import DEFAULT_INVENTORY

pytestmark = pytest.mark.contracts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")

# -- fixtures ------------------------------------------------------------

TELEMETRY_SRC = {
    "telemetry/__init__.py": "",
    "telemetry/events.py": """
        EVENT_TYPES = ("a_event", "b_event")
    """,
    "m.py": """
        from fixpkg import telemetry

        _GEN = ("relayrl_tuple_total", "registered through a tuple")

        def register(reg, journal):
            reg.counter("relayrl_ok_total", "documented")
            reg.counter("relayrl_bad", "no _total")
            reg.histogram("relayrl_lat", "no unit")
            reg.gauge("oops", "no prefix")
            reg.histogram("relayrl_h_seconds", "grid a", buckets=(1, 2))
            reg.histogram("relayrl_h_seconds", "grid b", buckets=(1, 3))
            reg.counter("relayrl_undoc_total", "missing from the docs")
            reg.counter("relayrl_kind_total", "a counter documented as a gauge")
            reg.counter(*_GEN)
            journal.emit("a_event")
            journal.emit("c_event")
    """,
}

OBSERVABILITY_MD = """
    # Observability

    ## Metrics

    | metric | kind | meaning |
    |---|---|---|
    | `relayrl_ok_total` | counter | documented |
    | `relayrl_bad` | counter | x |
    | `relayrl_lat` | histogram | x |
    | `oops` | gauge | x |
    | `relayrl_h_seconds` | histogram | x |
    | `relayrl_kind_total` | gauge | drift |
    | `relayrl_tuple_total` | counter | through a tuple |
    | `relayrl_gone_total` | counter | no registration |

    ## Events

    | event | meaning |
    |---|---|
    | `a_event` | x |
    | `z_event` | not in EVENT_TYPES |
"""

TELEMETRY_CLEAN = {
    "telemetry/__init__.py": "",
    "telemetry/events.py": """
        EVENT_TYPES = ("a_event",)
    """,
    "m.py": """
        def register(reg, journal):
            reg.counter("relayrl_ok_total", "documented")
            journal.emit("a_event")
    """,
}

OBSERVABILITY_CLEAN = """
    # Observability

    | metric | kind | meaning |
    |---|---|---|
    | `relayrl_ok_total` | counter | documented |

    | event | meaning |
    |---|---|
    | `a_event` | x |
"""

CONFIG_SRC = {
    "config/__init__.py": "",
    "config/default_config.py": """
        DEFAULT_CONFIG = {
            "actor": {"alpha": 1, "beta": 2, "gamma": 3, "dead_knob": 4},
            "algorithms": {"anything": 1},
        }
    """,
    "config/loader.py": """
        class ConfigLoader:
            def get_actor_params(self, params):
                return {
                    "alpha": params.get("alpha", 5),
                    "nokey": params.get("nokey", 1),
                    "beta": params.get("beta", 2),
                    "gamma": params.get("gamma", 3),
                }
    """,
    "reader.py": """
        def read(cfg):
            p = cfg.get_actor_params()
            return p["alpha"], p["missing"]
    """,
}

OPERATIONS_MD = """
    # Operations

    ## Actor knobs

    | knob | default | meaning |
    |---|---|---|
    | `alpha` | 1 | x |
    | `beta` | 9 | drifted |
    | `ghost` | 0 | documented, not shipped |
"""

CONFIG_CLEAN = {
    "config/__init__.py": "",
    "config/default_config.py": """
        DEFAULT_CONFIG = {"actor": {"alpha": 1}}
    """,
    "config/loader.py": """
        class ConfigLoader:
            def get_actor_params(self, params):
                return {"alpha": params.get("alpha", 1)}
    """,
}

OPERATIONS_CLEAN = """
    # Operations

    ## Actor knobs

    | knob | default | meaning |
    |---|---|---|
    | `alpha` | 1 | x |
"""

CONCURRENCY_SRC = {
    "ab.py": """
        import threading
        import time

        _a = threading.Lock()
        _b = threading.Lock()

        def take_a():
            with _a:
                pass

        def settle():
            time.sleep(0.5)

        def forward():
            with _a:
                with _b:
                    pass

        def backward():
            with _b:
                take_a()

        def update():
            with _a:
                settle()
    """,
    "w.py": """
        import threading

        class Worker:
            def start(self):
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                pass
    """,
}

CONCURRENCY_CLEAN = {
    "ok.py": """
        import threading

        _a = threading.Lock()
        _b = threading.Lock()

        def one():
            with _a:
                with _b:
                    pass

        def spawn(fn):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            return t
    """,
}

TESTS_SRC = """
    import pytest

    pytestmark = pytest.mark.widget

    @pytest.mark.parametrize("n", [1])
    def test_one(n):
        pass
"""


def write_tree(root, sources: dict[str, str]) -> None:
    for rel, src in sources.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))


def contexts(tmp_path, sources: dict[str, str], docs: dict[str, str] = (),
             **roots):
    """The reference's and the port's ContractContext over one synthetic
    package (no repo markers above tmp_path: the cross-artifact halves
    run only where a root is passed)."""
    pkg = tmp_path / "fixpkg"
    pkg.mkdir()
    write_tree(pkg, sources)
    if docs:
        write_tree(tmp_path / "docs", dict(docs))
        roots["docs_root"] = str(tmp_path / "docs")
    return (ref_contracts.ContractContext(package_root=str(pkg), **roots),
            ContractContext(package_root=str(pkg), **roots))


def normalised(findings) -> list[tuple]:
    return sorted((f.rule, f.path.replace("relayrl_tpu_torch/", "relayrl_tpu/"),
                   f.line, f.message.replace("relayrl_tpu_torch", "relayrl_tpu"))
                  for f in findings)


def markers_roots(tmp_path, registered: str) -> dict:
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_x.py").write_text(textwrap.dedent(TESTS_SRC))
    ini = tmp_path / "pytest.ini"
    ini.write_text(f"[pytest]\nmarkers =\n    {registered}: a marker\n")
    return {"tests_root": str(tests), "pytest_ini": str(ini)}


def mutated_native(tmp_path, old: str, new: str) -> str:
    native = tmp_path / "native"
    native.mkdir()
    for name in wire_pass.NATIVE_SOURCES:
        src = os.path.join(NATIVE, name)
        if os.path.exists(src):
            shutil.copy(src, native / name)
    codec = native / "codec.cc"
    text = codec.read_text()
    assert old in text
    codec.write_text(text.replace(old, new))
    return str(native)


def run_telemetry(tmp_path, clean: bool):
    src, doc = ((TELEMETRY_CLEAN, OBSERVABILITY_CLEAN) if clean
                else (TELEMETRY_SRC, OBSERVABILITY_MD))
    ref_ctx, ctx = contexts(tmp_path, src, {"observability.md": doc})
    return ref_telemetry.run(ref_ctx)[0], telemetry_pass.run(ctx)[0]


def run_config(tmp_path, clean: bool):
    src, doc = ((CONFIG_CLEAN, OPERATIONS_CLEAN) if clean
                else (CONFIG_SRC, OPERATIONS_MD))
    ref_ctx, ctx = contexts(tmp_path, src, {"operations.md": doc})
    return ref_config.run(ref_ctx)[0], config_pass.run(ctx)[0]


def run_concurrency(tmp_path, clean: bool):
    ref_ctx, ctx = contexts(tmp_path,
                            CONCURRENCY_CLEAN if clean else CONCURRENCY_SRC)
    return ref_concurrency.run(ref_ctx)[0], concurrency_pass.run(ctx)[0]


def run_markers(tmp_path, clean: bool):
    roots = markers_roots(tmp_path, "widget" if clean else "gadget")
    ref_ctx, ctx = contexts(tmp_path, {}, **roots)
    return ref_markers.run(ref_ctx)[0], markers_pass.run(ctx)[0]


@functools.lru_cache(maxsize=None)
def whole_contexts():
    """The reference's context over the JAX package, the port's over the
    port and the reference's over the port: each parses its package
    once for every test of this file that reads a whole tree."""
    port = os.path.join(REPO, "relayrl_tpu_torch")
    return (ref_contracts.ContractContext(), ContractContext(),
            ref_contracts.ContractContext(package_root=port))


def run_wire(tmp_path, mutation):
    """Both engines' wire pass over their own packages, against a copy
    of ``native/`` with ``mutation`` applied to codec.cc (or the real
    tree when None)."""
    ref_ctx, ctx, _ = whole_contexts()
    native = NATIVE if mutation is None else mutated_native(tmp_path,
                                                            *mutation)
    ref_ctx.native_root = ctx.native_root = native
    try:
        return ref_wire.run(ref_ctx)[0], wire_pass.run(ctx)[0]
    finally:
        ref_ctx.native_root = ctx.native_root = NATIVE


def run_wire01(tmp_path, clean: bool):
    return run_wire(tmp_path, None if clean else (
        "kBlobMagic = 0x31444C52", "kBlobMagic = 0x31444C53"))


def run_wire02(tmp_path, clean: bool):
    return run_wire(tmp_path, None if clean else ("kBlobMagic",
                                                  "kRenamedMagic"))


def run_con01(tmp_path, clean: bool):
    """run_contracts with every root given (full context) over a small
    fixture, against an inventory written from a fresh extraction (and
    then, for the positive case, edited)."""
    roots = markers_roots(tmp_path, "widget")
    pkg_sources = dict(CONCURRENCY_CLEAN)
    ref_ctx, ctx = contexts(tmp_path, pkg_sources, {
        "observability.md": OBSERVABILITY_CLEAN}, native_root=NATIVE,
        repo_root=str(tmp_path), **roots)
    out = []
    for engine, context in ((ref_contracts, ref_ctx), (port_contracts, ctx)):
        inventory = tmp_path / "inventory.json"
        _f, doc = engine.run_contracts(context, check_inventory=False)
        if not clean:
            doc["concurrency"]["locks"].append("fixpkg.ok._gone")
        inventory.write_text(engine.serialize_inventory(doc))
        found, _doc = engine.run_contracts(context,
                                           inventory_path=str(inventory))
        out.append([f for f in found if f.rule == "CON01"])
    return out[0], out[1]


RUNNERS = {
    "MET": run_telemetry, "EVT": run_telemetry, "CFG": run_config,
    "LOCK": run_concurrency, "THR": run_concurrency, "PYT": run_markers,
    "WIRE01": run_wire01, "WIRE02": run_wire02, "CON01": run_con01,
}


def runner(code: str):
    return RUNNERS.get(code) or RUNNERS[code.rstrip("0123456789")]


CODES = [code for code, _n, _d in CONTRACT_RULES]


def test_catalog_is_the_references():
    assert CONTRACT_RULES == ref_contracts.CONTRACT_RULES


@pytest.mark.parametrize("code", CODES)
def test_contract_positive_matches_the_reference(tmp_path, code):
    theirs, ours = runner(code)(tmp_path, clean=False)
    mine = [f for f in ours if f.rule == code]
    assert mine, f"{code} did not fire: {normalised(ours)}"
    if code == "MET06":
        # the port folds the tuple registration the reference misses
        assert normalised(mine) == normalised(
            f for f in theirs if f.rule == code
            and "relayrl_tuple_total" not in f.message)
    else:
        assert normalised(mine) == normalised(
            f for f in theirs if f.rule == code)


@pytest.mark.parametrize("code", CODES)
def test_contract_negative_stays_silent(tmp_path, code):
    theirs, ours = runner(code)(tmp_path, clean=True)
    assert [f for f in ours if f.rule == code] == []
    assert [f for f in theirs if f.rule == code] == []


def test_fixtures_agree_on_every_other_code(tmp_path):
    """Beyond MET06's fold, the two engines report the same findings on
    each synthetic fixture."""
    for i, run in enumerate((run_telemetry, run_config, run_concurrency,
                             run_markers)):
        sub = tmp_path / str(i)
        sub.mkdir()
        theirs, ours = run(sub, clean=False)
        extra = [f for f in theirs if f.rule == "MET06"
                 and "relayrl_tuple_total" in f.message]
        assert normalised(ours) == normalised(
            f for f in theirs if f not in extra), run.__name__


# -- the tuple fold --------------------------------------------------------

def test_tuple_registration_folds(tmp_path):
    theirs, ours = run_telemetry(tmp_path, clean=False)
    assert any("relayrl_tuple_total" in f.message for f in theirs
               if f.rule == "MET06")
    assert not any("relayrl_tuple_total" in f.message for f in ours)


def test_tuple_fold_clears_the_ports_false_met06():
    _ref, ctx, ref_on_port = whole_contexts()
    theirs = ref_telemetry.run(ref_on_port)[0]
    ours = telemetry_pass.run(ctx)[0]
    assert sorted(f.snippet for f in theirs if f.rule == "MET06") == [
        "relayrl_rlhf_generated_tokens_total", "relayrl_rlhf_stage_seconds"]
    assert [f for f in ours if f.rule == "MET06"] == []


def test_tuple_fold_needs_a_module_level_string_tuple(tmp_path):
    ref_ctx, ctx = contexts(tmp_path, {"m.py": """
        def register(reg, names):
            local = ("relayrl_local_total", "not module level")
            reg.counter(*local)
            reg.counter(*names)
    """})
    assert telemetry_pass.extract_metrics(ctx) == []
    assert ref_telemetry.extract_metrics(ref_ctx) == []


# -- the real tree ---------------------------------------------------------

def test_wire_pass_reads_the_real_native_tree():
    findings, inventory = wire_pass.run(whole_contexts()[1])
    assert findings == []
    assert inventory["native"].get("kBlobMagic") == 0x31444C52
    # the port's itemsizes come from its own dtypes module
    assert wire_pass._python_itemsizes({4: "FLOAT32"}) == {4: 4}


def test_context_defaults_to_the_port():
    ctx = ContractContext()
    assert ctx.package_root == os.path.join(REPO, "relayrl_tpu_torch")
    assert ctx.docs_root == os.path.join(REPO, "docs")
    assert ctx.native_root == NATIVE
    assert DEFAULT_INVENTORY == os.path.join(
        REPO, "relayrl_tpu_torch", "analysis", "contracts.json")


def test_committed_inventory_matches_fresh_extraction():
    """The CON01 gate in test form: regenerate with ``python -m
    relayrl_tpu_torch.analysis --contracts --write-inventory`` whenever
    a contract of the port legitimately changes."""
    findings, doc = run_contracts(whole_contexts()[1])
    assert [f for f in findings if f.rule == "CON01"] == []
    with open(DEFAULT_INVENTORY, "r", encoding="utf-8") as f:
        assert f.read() == serialize_inventory(doc)
    # the shared artifacts give the same config, wire and markers slices
    # as the reference's committed inventory
    with open(ref_contracts.DEFAULT_INVENTORY, "r", encoding="utf-8") as f:
        ref_doc = json.load(f)
    for section in ("config", "wire", "markers"):
        assert doc[section] == ref_doc[section], section
