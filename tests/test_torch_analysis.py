"""torchlint (relayrl_tpu_torch.analysis) — the port's rule units, held
beside the JAX package's jaxlint where a rule is copied or has a
counterpart, suppression/baseline mechanics, the CLI contract, and the
port's own gate over ``relayrl_tpu_torch/`` and ``chip_smoke.py``.

Every rule has positive (fires) and negative (stays silent) cases, each
a case of one parametrised test. The copied rules (CONC01, CONC02,
TEL01) go through both engines on the same sources and must agree on
``(rule, line, col, message)``; each counterpart rule (TORCH01-03,
TORCH06, IMP01) fires on the torch translation of the reference's
positive snippet and stays silent on the translated negative.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from relayrl_tpu.analysis import analyze_source as ref_analyze_source
from relayrl_tpu_torch.analysis import (
    all_rules,
    analyze_paths,
    analyze_source,
    apply_baseline,
    load_baseline,
    main,
    rules_by_code,
    write_baseline,
)
from relayrl_tpu_torch.analysis.engine import (
    ModuleInfo,
    _suppressed_rules,
    statement_end_line,
)

pytestmark = pytest.mark.jaxlint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "relayrl_tpu_torch")
BASELINE = os.path.join(PKG, "analysis", "baseline.json")


def codes(src: str, path: str = "x.py") -> list[str]:
    return [f.rule for f in analyze_source(textwrap.dedent(src), path)]


class TestRegistry:
    def test_codes_unique_and_described(self):
        by_code = rules_by_code()  # raises on duplicates
        assert set(by_code) == {"TORCH01", "TORCH02", "TORCH03", "TORCH06",
                                "PORT01", "CONC01", "CONC02", "IMP01",
                                "TEL01"}
        for code, rule in by_code.items():
            assert code and rule.name and rule.description, code

    def test_no_jax_only_rule_carried_over(self):
        # JAX04/JAX05 have no counterpart (torch_rules' docstring says why)
        assert not any(r.code.startswith("JAX") for r in all_rules())


# -- every rule: positive and negative cases ---------------------------

RULE_CASES = [
    # TORCH01 implicit-global-rng
    ("TORCH01", "randn-no-generator", """
        import torch
        def noise(n):
            return torch.randn(n)
    """, 1),
    ("TORCH01", "inplace-uniform", """
        def fill(x):
            x.uniform_(-1.0, 1.0)
    """, 1),
    ("TORCH01", "generator-none-literal", """
        import torch
        def pick(p):
            return torch.multinomial(p, 1, generator=None)
    """, 1),
    ("TORCH01", "nn-init-normal", """
        import torch
        def init(w):
            torch.nn.init.normal_(w, std=0.02)
    """, 1),
    ("TORCH01", "aliased-randint", """
        from torch import randint
        def draw():
            return randint(0, 5, (3,))
    """, 1),
    ("TORCH01", "explicit-generator", """
        import torch
        def noise(n, gen):
            x = torch.randn(n, generator=gen)
            x.normal_(generator=gen)
            return torch.randperm(n, generator=gen)
    """, 0),
    ("TORCH01", "generator-through-kwargs", """
        import torch
        def noise(n, **kw):
            return torch.rand(n, **kw)
    """, 0),
    ("TORCH01", "numpy-generator-methods", """
        import numpy as np
        def noise(rng):
            a = np.random.default_rng(0).normal(size=3)
            return a + rng.multinomial(3, [0.5, 0.5])
    """, 0),
    # TORCH02 host-sync-in-capture
    ("TORCH02", "item-in-capture-block", """
        import torch
        def capture(g, x):
            with torch.cuda.graph(g):
                y = x.sum().item()
            return y
    """, 1),
    ("TORCH02", "cpu-in-method-captured-through-self", """
        import torch
        class Host:
            def _run(self, x):
                return x.cpu()
            def capture(self, g, x):
                with torch.cuda.graph(g):
                    self._run(x)
    """, 1),
    ("TORCH02", "transitive-tolist", """
        import torch
        def inner(x):
            return x.tolist()
        def helper(x):
            return inner(x)
        def capture(g, x):
            with torch.cuda.graph(g):
                helper(x)
    """, 1),
    ("TORCH02", "graphed-callable-cast-and-sync", """
        import torch
        def step(x):
            t = torch.ones(3, device=x.device) * x
            torch.cuda.synchronize()
            return float(t)
        graphed = torch.cuda.make_graphed_callables(step, (torch.ones(3),))
    """, 2),
    ("TORCH02", "scalar-copied-to-device", """
        import torch
        def capture(g, x, scale):
            with torch.cuda.graph(g):
                s = torch.tensor(scale, device="cuda")
                y = x * s
            return y
    """, 1),
    ("TORCH02", "readback-after-replay", """
        import torch
        def run(g, out):
            with torch.cuda.graph(g):
                out.add_(1)
            g.replay()
            return out.sum().item()
    """, 0),
    ("TORCH02", "static-shape-casts", """
        import torch
        def capture(g, x):
            with torch.cuda.graph(g):
                n = int(x.shape[0])
                y = x * float(len(x)) / n
            return y
    """, 0),
    ("TORCH02", "uncalled-nested-def-and-other-class", """
        import torch
        class Other:
            def _run(self, x):
                return x.item()
        class Host:
            def _run(self, x):
                return x * 2
            def capture(self, g, x):
                with torch.cuda.graph(g):
                    def later():
                        return x.item()
                    self._run(x)
                return later
    """, 0),
    # TORCH03 print-in-capture
    ("TORCH03", "print-in-capture", """
        import torch
        def capture(g, x):
            with torch.cuda.graph(g):
                print(x)
    """, 1),
    ("TORCH03", "print-on-the-host", """
        import torch
        def capture(g, x):
            with torch.cuda.graph(g):
                x.mul_(2)
            print("captured")
    """, 0),
    # TORCH06 untimed-cuda-dispatch
    ("TORCH06", "torch-op-timed", """
        import time, torch
        def bench(a, b):
            t0 = time.perf_counter()
            y = torch.matmul(a, b)
            return y, time.perf_counter() - t0
    """, 1),
    ("TORCH06", "graph-replay-timed", """
        import time
        def bench(self):
            t0 = time.perf_counter()
            self.graph.replay()
            return time.perf_counter() - t0
    """, 1),
    ("TORCH06", "kernel-wrapper-timed", """
        import time
        from relayrl_tpu_torch.ops.flash import flash_attention
        def bench(q, k, v):
            t0 = time.monotonic()
            out = flash_attention(q, k, v)
            return out, time.monotonic() - t0
    """, 1),
    ("TORCH06", "bound-module-timed", """
        import time, torch
        def bench(x):
            model = torch.nn.Linear(4, 4).cuda()
            t0 = time.perf_counter()
            y = model(x)
            return y, time.perf_counter() - t0
    """, 1),
    ("TORCH06", "synchronized", """
        import time, torch
        def bench(a, b):
            t0 = time.perf_counter()
            y = torch.matmul(a, b)
            torch.cuda.synchronize()
            return y, time.perf_counter() - t0
    """, 0),
    ("TORCH06", "readback-fence", """
        import time, torch
        def bench(a, b):
            t0 = time.perf_counter()
            y = torch.matmul(a, b).sum().item()
            return y, time.perf_counter() - t0
    """, 0),
    ("TORCH06", "event-timing", """
        import time, torch
        def bench(a, b, start, end):
            t0 = time.perf_counter()
            start.record()
            y = torch.matmul(a, b)
            end.record()
            ms = start.elapsed_time(end)
            return y, ms, time.perf_counter() - t0
    """, 0),
    ("TORCH06", "non-graph-replay-is-host-work", """
        import time
        def drain(log, spool):
            t0 = time.perf_counter()
            checked = log.replay()
            spool.replay()
            return checked, time.perf_counter() - t0
    """, 0),
    ("TORCH06", "metadata-method-on-a-bound-tensor", """
        import time, torch
        def send(comm, like):
            flat = torch.cat(like).to("cpu")
            t0 = time.perf_counter()
            comm.broadcast(flat, 0)
            n = flat.numel()
            return n, time.perf_counter() - t0
    """, 0),
    ("TORCH06", "kernel-module-factory-is-not-a-launch", """
        import time
        from relayrl_tpu_torch.parallel import ring_flash as rf
        def main(mesh):
            t_run = time.perf_counter()
            ring = rf._make_ring_flash(mesh, "sp", True, ("dp",), None)
            make = rf.make_ring_flash_attention(mesh)
            return ring, make, time.perf_counter() - t_run
    """, 0),
    # PORT01 reference-import
    ("PORT01", "import-jax-in-function", """
        def f():
            import jax
            return jax
    """, 1),
    ("PORT01", "from-reference-package", """
        from relayrl_tpu.types import dtypes
    """, 1),
    ("PORT01", "flax-optax-orbax", """
        import flax.linen as nn
        import optax
        from orbax import checkpoint
    """, 3),
    ("PORT01", "module-scope-msgpack", """
        import msgpack
    """, 1),
    ("PORT01", "module-scope-ml-dtypes-under-try", """
        try:
            import ml_dtypes
        except ImportError:
            ml_dtypes = None
    """, 1),
    ("PORT01", "the-port-itself-and-lazy-imports", """
        import relayrl_tpu_torch.types
        from relayrl_tpu_torch.types import dtypes
        from . import sibling
        def encode(x):
            import msgpack
            import ml_dtypes
            return msgpack.packb(x), ml_dtypes
    """, 0),
    # IMP01 module-level-device-touch (torch semantics)
    ("IMP01", "set-device", """
        import torch
        torch.cuda.set_device(0)
    """, 1),
    ("IMP01", "cuda-allocation", """
        import torch
        ONES = torch.ones(3, device="cuda")
        BUF = torch.empty(4).cuda()
    """, 2),
    ("IMP01", "backends-assignment", """
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
    """, 1),
    ("IMP01", "seed-and-defaults", """
        import torch
        torch.manual_seed(0)
        torch.set_default_dtype(torch.float64)
        torch.set_default_device("cuda")
    """, 3),
    ("IMP01", "stream-in-class-body", """
        import torch
        class Pool:
            STREAM = torch.cuda.Stream()
    """, 1),
    ("IMP01", "inside-a-function", """
        import torch
        def setup():
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            return torch.zeros(3, device="cuda")
    """, 0),
    ("IMP01", "host-allocations", """
        import torch
        ZEROS = torch.zeros(3)
        HOST = torch.zeros(3, device="cpu")
        CPU = torch.ones(2, device=torch.device("cpu"))
    """, 0),
]


@pytest.mark.parametrize(
    "code,src,count",
    [pytest.param(code, src, count, id=f"{code}-{case}")
     for code, case, src, count in RULE_CASES])
def test_rule_case(code, src, count):
    got = codes(src)
    assert got.count(code) == count, got
    assert set(got) <= {code}, got


def test_every_rule_has_a_positive_and_a_negative_case():
    for rule in all_rules():
        counts = [count for code, _c, _s, count in RULE_CASES
                  if code == rule.code]
        assert rule.code in {"CONC01", "CONC02", "TEL01"} or (
            any(counts) and 0 in counts), rule.code


def test_imp01_exempts_init_and_conftest():
    src = "import torch\ntorch.cuda.set_device(0)\n"
    assert codes(src, "pkg/__init__.py") == []
    assert codes(src, "tests/conftest.py") == []


def test_captured_functions_of_the_port():
    """The port's one capture today: the anakin window."""
    path = os.path.join(PKG, "runtime", "anakin.py")
    with open(path, encoding="utf-8") as f:
        source = f.read()
    info = ModuleInfo(path, source, ast.parse(source))
    assert len(info.capture_blocks) == 1
    assert sorted(fn.name for fn in info.captured_functions) == ["_run"]


# -- copied rules: both engines agree exactly --------------------------

COPIED_CASES = [
    ("CONC01", "sleep", """
        import time, threading
        lock = threading.Lock()
        def f():
            with lock:
                time.sleep(1.0)
    """),
    ("CONC01", "recv-under-attr-lock", """
        class T:
            def f(self, sock):
                with self._pub_lock:
                    return sock.recv()
    """),
    ("CONC01", "thread-join-under-lock", """
        class T:
            def f(self):
                with self._lock:
                    self._listener_thread.join()
    """),
    ("CONC01", "subprocess-under-lock", """
        import subprocess, threading
        _lock = threading.Lock()
        def build(cmd):
            with _lock:
                return subprocess.run(cmd, check=True)
    """),
    ("CONC01", "sleep-outside-lock", """
        import time
        def f(lock):
            with lock:
                x = 1
            time.sleep(0.1)
            return x
    """),
    ("CONC01", "string-and-path-join", """
        import os
        def f(lock, items):
            with lock:
                name = ", ".join(items)
                return os.path.join("a", name)
    """),
    ("CONC01", "nested-def-not-under-lock", """
        import time
        def f(lock):
            with lock:
                def cb():
                    time.sleep(1.0)
            return cb
    """),
    ("CONC02", "bare-except", """
        def f():
            try:
                pass
            except:
                pass
    """),
    ("CONC02", "typed-except", """
        def f():
            try:
                pass
            except Exception:
                pass
    """),
    ("TEL01", "inline-interval", """
        import time
        def f(hist, work):
            t0 = time.time()
            work()
            hist.observe(time.time() - t0)
    """),
    ("TEL01", "named-interval-through-set", """
        import time
        def f(gauge, work):
            start = time.time()
            work()
            elapsed = time.time() - start
            gauge.set(elapsed)
    """),
    ("TEL01", "monotonic-interval", """
        import time
        def f(hist, work):
            t0 = time.monotonic()
            work()
            hist.observe(time.monotonic() - t0)
    """),
    ("TEL01", "wall-timestamp-not-interval", """
        import time
        def f(gauge):
            gauge.set(time.time())
    """),
]


def _shape(findings, code):
    return [(f.rule, f.line, f.col, f.name, f.message, f.snippet)
            for f in findings if f.rule == code]


@pytest.mark.parametrize(
    "code,src",
    [pytest.param(code, src, id=f"{code}-{case}")
     for code, case, src in COPIED_CASES])
def test_copied_rule_matches_the_reference(code, src):
    src = textwrap.dedent(src)
    ours = _shape(analyze_source(src, "x.py"), code)
    theirs = _shape(ref_analyze_source(src, "x.py"), code)
    assert ours == theirs


def test_copied_rules_have_positive_and_negative_cases():
    for code in ("CONC01", "CONC02", "TEL01"):
        fired = [bool(_shape(analyze_source(textwrap.dedent(src), "x.py"),
                             code))
                 for c, _case, src in COPIED_CASES if c == code]
        assert True in fired and False in fired, code


# -- counterpart rules: the reference's snippets, translated ------------

COUNTERPARTS = [
    # (reference code, its snippet, port code, the torch translation,
    #  fires)
    ("JAX01", """
        import jax
        def f(rng):
            a = jax.random.normal(rng, (3,))
            b = jax.random.uniform(rng, (3,))
            return a + b
    """, "TORCH01", """
        import torch
        def f(gen):
            a = torch.randn((3,))
            b = torch.rand((3,))
            return a + b
    """, True),
    ("JAX01", """
        import jax
        def f(rng):
            rng, sub = jax.random.split(rng)
            a = jax.random.normal(sub, (3,))
            rng, sub = jax.random.split(rng)
            return a + jax.random.uniform(sub, (3,))
    """, "TORCH01", """
        import torch
        def f(gen):
            a = torch.randn((3,), generator=gen)
            return a + torch.rand((3,), generator=gen)
    """, False),
    ("JAX02", """
        import jax
        import numpy as np
        @jax.jit
        def f(x):
            y = np.asarray(x)
            return float(y)
    """, "TORCH02", """
        import torch
        import numpy as np
        def f(g, x):
            with torch.cuda.graph(g):
                y = torch.relu(x)
                z = np.asarray(y)
            return z
    """, True),
    ("JAX02", """
        import jax
        def body(c, x):
            c = c + x.item()
            return c, x
        def g(xs):
            return jax.lax.scan(body, 0.0, xs)
    """, "TORCH02", """
        import torch
        def body(c, x):
            c.add_(x.item())
            return c
        def g(graph, c, x):
            with torch.cuda.graph(graph):
                body(c, x)
    """, True),
    ("JAX02", """
        import jax
        @jax.jit
        def f(x):
            scale = float(len(x))
            n = int(x.shape[0])
            return x * scale / n
    """, "TORCH02", """
        import torch
        def f(g, x):
            with torch.cuda.graph(g):
                scale = float(len(x))
                n = int(x.shape[0])
                y = x * scale / n
            return y
    """, False),
    ("JAX03", """
        import jax
        @jax.jit
        def f(x):
            print(x)
            return x
    """, "TORCH03", """
        import torch
        def f(g, x):
            with torch.cuda.graph(g):
                print(x)
    """, True),
    ("JAX03", """
        import jax
        @jax.jit
        def f(x):
            jax.debug.print("x={x}", x=x)
            return x
        def host():
            print("hello")
    """, "TORCH03", """
        import torch
        def f(g, x):
            with torch.cuda.graph(g):
                x.mul_(2)
        def host():
            print("hello")
    """, False),
    ("JAX06", """
        import jax, time
        def g(x): return x
        f = jax.jit(g)
        def bench(x):
            t0 = time.perf_counter()
            y = f(x)
            return y, time.perf_counter() - t0
    """, "TORCH06", """
        import time, torch
        def bench(x):
            t0 = time.perf_counter()
            y = torch.nn.functional.relu(x)
            return y, time.perf_counter() - t0
    """, True),
    ("JAX06", """
        import jax, time
        def g(x): return x
        f = jax.jit(g)
        def bench(x):
            t0 = time.perf_counter()
            y = jax.block_until_ready(f(x))
            return y, time.perf_counter() - t0
    """, "TORCH06", """
        import time, torch
        def bench(x):
            t0 = time.perf_counter()
            y = torch.nn.functional.relu(x)
            torch.cuda.synchronize()
            return y, time.perf_counter() - t0
    """, False),
    ("JAX06", """
        import jax, time
        def g(x): return x
        f = jax.jit(g)
        def bench(x):
            t0 = time.perf_counter()
            y = f(x)
            float(y)
            return time.perf_counter() - t0
    """, "TORCH06", """
        import time, torch
        def bench(x):
            t0 = time.perf_counter()
            y = torch.nn.functional.relu(x)
            y.sum().item()
            return time.perf_counter() - t0
    """, False),
    ("IMP01", """
        import jax
        DEVICES = jax.devices()
    """, "IMP01", """
        import torch
        DEVICE = torch.cuda.current_device()
    """, True),
    ("IMP01", """
        import jax
        class Cfg:
            jax.config.update("jax_enable_x64", True)
    """, "IMP01", """
        import torch
        class Cfg:
            torch.set_default_dtype(torch.float64)
    """, True),
    ("IMP01", """
        import jax
        def devices():
            return jax.devices()
    """, "IMP01", """
        import torch
        def device():
            return torch.cuda.current_device()
    """, False),
]


@pytest.mark.parametrize(
    "ref_code,ref_src,code,src,fires",
    [pytest.param(*case, id=f"{case[2]}-{'pos' if case[4] else 'neg'}-{i}")
     for i, case in enumerate(COUNTERPARTS)])
def test_counterpart_fires_like_the_reference(ref_code, ref_src, code, src,
                                              fires):
    theirs = [f.rule for f in ref_analyze_source(textwrap.dedent(ref_src),
                                                 "x.py")]
    assert (ref_code in theirs) is fires, theirs
    ours = codes(src)
    assert (code in ours) is fires, ours
    assert set(ours) <= {code}, ours


# -- suppression ---------------------------------------------------------

BAD = "import torch\nDEV = torch.cuda.current_device()\n"


@pytest.mark.parametrize("src,want", [
    pytest.param(BAD.replace("()\n", "()  # torchlint: disable=IMP01\n"),
                 [], id="same-line"),
    pytest.param("import torch\n# torchlint: disable=module-level-device-"
                 "touch\nDEV = torch.cuda.current_device()\n", [],
                 id="line-above-and-slug"),
    pytest.param(BAD.replace("()\n", "()  # torchlint: disable=all\n"), [],
                 id="disable-all"),
    pytest.param(BAD.replace("()\n", "()  # torchlint: disable=IMP01 - "
                                     "entry script, card already chosen\n"),
                 [], id="trailing-reason"),
    pytest.param(BAD.replace("()\n", "()  # torchlint: disable=TORCH01\n"),
                 [("IMP01", 2)], id="wrong-code"),
    pytest.param(BAD.replace("()\n", "()  # jaxlint: disable=IMP01\n"),
                 [("IMP01", 2)], id="the-reference-prefix-does-not-count"),
    pytest.param("import torch\nDEV = torch.cuda.current_device()  "
                 "# torchlint: disable=IMP01\nD2 = torch.cuda."
                 "current_device()\n", [("IMP01", 3)],
                 id="inline-does-not-leak"),
    pytest.param("import torch\nx = 1  # torchlint: disable=IMP01\n"
                 "DEV = torch.cuda.current_device()\n", [("IMP01", 3)],
                 id="above-needs-a-comment-only-line"),
])
def test_suppression(src, want):
    assert [(f.rule, f.line) for f in analyze_source(src, "x.py")] == want


# -- engine mechanics ----------------------------------------------------

def test_syntax_error_is_a_parse_finding():
    assert [f.rule for f in analyze_source("def broken(:\n", "x.py")] \
        == ["PARSE"]


def test_paths_anchor_like_the_reference(tmp_path, monkeypatch):
    (tmp_path / "pyproject.toml").write_text("")
    pkg = tmp_path / "mypkg"
    pkg.mkdir()
    (pkg / "m.py").write_text(BAD)
    monkeypatch.chdir(tmp_path)
    from_root = analyze_paths(["mypkg"])
    monkeypatch.chdir(pkg)
    from_subdir = analyze_paths(["."])
    assert [f.path for f in from_root] == ["mypkg/m.py"]
    assert [f.key() for f in from_subdir] == [f.key() for f in from_root]


def test_baseline_roundtrip_match_and_stale(tmp_path):
    pkg = tmp_path / "p"
    pkg.mkdir()
    (pkg / "m.py").write_text(BAD + "D2 = torch.cuda.current_device()\n")
    findings = analyze_paths([str(pkg)])
    assert len(findings) == 2
    bl = tmp_path / "baseline.json"
    write_baseline(bl, findings)
    assert json.loads(bl.read_text())["tool"] == "torchlint"
    assert apply_baseline(findings, load_baseline(bl)) == ([], 2, [])
    (pkg / "m.py").write_text("import torch\n")
    new, matched, stale = apply_baseline(analyze_paths([str(pkg)]),
                                         load_baseline(bl))
    assert new == [] and matched == 0 and len(stale) == 2


# -- CLI -----------------------------------------------------------------

def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for code in ("TORCH01", "TORCH06", "PORT01", "CONC01", "IMP01", "MET01",
                 "CON01"):
        assert code in out


@pytest.mark.parametrize("argv", [
    pytest.param(["--select", "NOPE99", PKG], id="unknown-select"),
    pytest.param(["/no/such/dir-torchlint"], id="missing-path"),
    pytest.param(["--contracts", "--no-contracts"], id="exclusive-engines"),
    pytest.param(["--write-baseline"], id="write-baseline-needs-a-path"),
])
def test_cli_bad_invocation_exits_two(argv):
    assert main(argv) == 2


def test_cli_new_finding_exits_one_then_baselined_zero(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD)
    bl = tmp_path / "b.json"
    assert main([str(bad), "--baseline", str(bl)]) == 1
    assert main([str(bad), "--baseline", str(bl), "--write-baseline"]) == 0
    assert main([str(bad), "--baseline", str(bl)]) == 0
    corrupt = tmp_path / "broken.json"
    corrupt.write_text("{not json")
    assert main([str(bad), "--baseline", str(corrupt)]) == 2
    assert "cannot read baseline" in capsys.readouterr().err


def test_cli_json_format(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD)
    assert main([str(bad), "--no-baseline", "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["new"][0]["rule"] == "IMP01"
    assert payload["baselined"] == 0


# -- the port's gate -----------------------------------------------------

_GATE_SCRIPT = """
import json, sys
from relayrl_tpu_torch.analysis import main
rc = main(["--format", "json"])
loaded = sorted(m for m in ("jax", "torch", "relayrl_tpu") if m in sys.modules)
print(json.dumps({"rc": rc, "loaded": loaded}))
"""


@pytest.fixture(scope="module")
def gate_run():
    """The default invocation (torchlint over the port and chip_smoke.py,
    then the contracts engine against the committed inventory), in a
    fresh interpreter from the repo root: the report, the exit code and
    the heavy modules the run loaded."""
    proc = subprocess.run([sys.executable, "-c", _GATE_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    tail = json.loads(lines[-1])
    report = json.loads("\n".join(lines[:-1]))
    return report, tail


def test_gate_port_tree_has_no_new_finding(gate_run):
    report, tail = gate_run
    assert tail["rc"] == 0 and report["new"] == [], "\n".join(
        f"{f['path']}:{f['line']} {f['rule']} {f['message']}"
        for f in report["new"])


def test_gate_inventory_matches_a_fresh_extraction(gate_run):
    report, _tail = gate_run
    assert not [f for f in report["new"] if f["rule"] == "CON01"]
    assert report["stale_baseline_entries"] == []


def test_gate_loads_neither_jax_nor_torch_nor_the_reference(gate_run):
    _report, tail = gate_run
    assert tail["loaded"] == []


def test_baseline_is_empty():
    assert load_baseline(BASELINE) == {}


def _suppressed_at(path: str, line: int, code: str) -> bool:
    """Whether the port's engine suppresses ``code`` for the statement
    that starts at ``path:line``."""
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        source = f.read()
    lines = source.splitlines()
    end = line
    for node in ast.walk(ast.parse(source)):
        if getattr(node, "lineno", None) == line:
            end = max(end, statement_end_line(node))
    return code.lower() in _suppressed_rules(lines, line, end)


@pytest.fixture(scope="module")
def reference_on_port():
    """The JAX package's two engines run over the port's tree."""
    from relayrl_tpu.analysis import analyze_paths as ref_analyze_paths
    from relayrl_tpu.analysis.contracts import (
        ContractContext as RefContext,
        run_contracts as ref_run_contracts,
    )

    lint = ref_analyze_paths([PKG])
    contracts, _doc = ref_run_contracts(RefContext(package_root=PKG),
                                        check_inventory=False)
    return lint + contracts


def test_nothing_the_reference_sees_in_the_port_is_hidden(gate_run,
                                                          reference_on_port):
    from relayrl_tpu_torch.analysis.contracts import ContractContext
    from relayrl_tpu_torch.analysis.contracts.telemetry_pass import (
        extract_metrics,
    )

    report, _tail = gate_run
    reported = {(f["rule"], f["path"], f["line"]) for f in report["new"]}
    registered = {s.name for s in extract_metrics(ContractContext())}
    unaccounted = []
    for f in reference_on_port:
        if (f.rule, f.path, f.line) in reported:
            continue
        if f.path.startswith("relayrl_tpu_torch/") \
                and _suppressed_at(f.path, f.line, f.rule):
            continue
        if f.rule == "MET06" and f.snippet in registered:
            continue  # registered through a (name, help) tuple constant
        unaccounted.append(f.format())
    assert not unaccounted, "\n".join(unaccounted)
    # the reference sees the eight drifts it saw before the gate existed
    assert len(reference_on_port) >= 8


def test_jax_rules_find_nothing_in_the_port(reference_on_port):
    assert not [f for f in reference_on_port if f.rule.startswith("JAX")]
