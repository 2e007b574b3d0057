"""relayrl_tpu_torch.analysis — torchlint + contracts, the port's
static-analysis gate.

The port's counterpart of ``relayrl_tpu.analysis``, with the same
structure and names, aimed at ``relayrl_tpu_torch/`` and the repo's
``chip_smoke.py``. Its hazards are torch hazards: draws from torch's
process-wide RNG, host syncs and prints inside a CUDA-graph capture,
wall-clock pairs around asynchronous CUDA work, import-time CUDA
contexts, and imports of the JAX package. The second engine — contracts
— guards the cross-artifact agreements the port shares with the JAX
package: metric registrations vs the observability catalog, config
defaults vs loader clamps vs the ops knob tables, Python wire constants
vs ``native/*.cc`` (which the port compiles itself), the cross-module
lock graph, and tests/ markers vs pytest.ini. Its machine-readable
inventory is committed as ``contracts.json`` next to ``baseline.json``.

Rule catalog (torchlint), each beside its counterpart in the JAX
package's jaxlint:

========  ==========================  ===================================
Code      Name                        Counterpart, and what differs
========  ==========================  ===================================
TORCH01   implicit-global-rng         JAX01 prng-key-reuse: a sampling
                                      call (``torch.rand``/``randn``/
                                      ``randint``/``randperm``/
                                      ``multinomial``/``bernoulli``/
                                      ``normal``/``poisson``, in-place
                                      ``uniform_``/``normal_``/...) with no
                                      ``generator=``
TORCH02   host-sync-in-capture        JAX02 host-sync-in-jit: ``.item()``,
                                      ``.cpu()``, ``.tolist()``,
                                      ``.numpy()``, casts and
                                      ``np.asarray`` of a tensor,
                                      ``torch.cuda.synchronize()`` or a
                                      host-to-device copy inside captured
                                      code
TORCH03   print-in-capture            JAX03 print-in-jit
TORCH06   untimed-cuda-dispatch       JAX06 untimed-jit-dispatch: a
                                      ``time.*()`` pair around device work
                                      in a function with no CUDA sync
PORT01    reference-import            JAX07 direct-shard-map-binding (the
                                      package's own binding discipline):
                                      an import of ``relayrl_tpu``/``jax``/
                                      ``flax``/``optax``/``orbax``, or a
                                      module-scope ``msgpack``/
                                      ``ml_dtypes`` import
CONC01    blocking-under-lock         CONC01, copied
CONC02    bare-except                 CONC02, copied
IMP01     module-level-device-touch   IMP01 with torch semantics:
                                      module-scope ``torch.cuda`` context
                                      calls, device allocations,
                                      ``torch.manual_seed``,
                                      ``set_default_device``/``dtype``,
                                      ``torch.backends.*`` assignments
TEL01     wall-clock-latency          TEL01, copied
========  ==========================  ===================================

JAX04 and JAX05 have no counterpart (eager torch has no static
arguments and no buffer donation; see :mod:`.rules.torch_rules`).
"Captured code" is the body of a ``with torch.cuda.graph(...)`` block,
every function passed to ``torch.cuda.make_graphed_callables``, and the
functions either calls, transitively, within the module
(:class:`.engine.ModuleInfo`). The contracts catalog (MET, EVT, CFG,
WIRE, LOCK, THR, PYT, CON01) is the JAX package's, run over the port;
its telemetry pass also folds a metric registered through a
module-level ``(name, help)`` tuple (``reg.counter(*_GENERATED)``).

Usage::

    python -m relayrl_tpu_torch.analysis              # torchlint + contracts
    python -m relayrl_tpu_torch.analysis --contracts  # contracts only
    python -m relayrl_tpu_torch.analysis --contracts --write-inventory
    python -m relayrl_tpu_torch.analysis path/ --no-baseline
    python -m relayrl_tpu_torch.analysis --list-rules

Suppress one line with ``# torchlint: disable=TORCH01 - reason`` (any
line of the statement, or the comment-only line above); grandfathered
findings would live in ``baseline.json`` next to this file, which stays
empty.

The analyzer is stdlib-only: it never imports torch, jax or the JAX
package, nor the modules it audits (the wire pass reads the port's
``types/dtypes.py`` for itemsizes, inside a function: numpy only), so
the gate runs on any host, GPU or not.
"""

from relayrl_tpu_torch.analysis.cli import main  # noqa: F401
from relayrl_tpu_torch.analysis.contracts import (  # noqa: F401
    CONTRACT_RULES,
    ContractContext,
    run_contracts,
)
from relayrl_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    Rule,
    analyze_file,
    analyze_paths,
    analyze_source,
    apply_baseline,
    load_baseline,
    write_baseline,
)
from relayrl_tpu_torch.analysis.rules import all_rules, rules_by_code  # noqa: F401

__all__ = [
    "Finding",
    "Rule",
    "analyze_source",
    "analyze_file",
    "analyze_paths",
    "load_baseline",
    "write_baseline",
    "apply_baseline",
    "all_rules",
    "rules_by_code",
    "CONTRACT_RULES",
    "ContractContext",
    "run_contracts",
    "main",
]
