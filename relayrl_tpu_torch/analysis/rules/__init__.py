"""torchlint rule registry.

Rules are grouped by the layer they police:

* :mod:`torch_rules` — RNG, capture, dispatch-timing and import hazards
  of the port (the counterparts of the JAX package's ``jax_rules``).
* :mod:`concurrency_rules` — runtime/transport thread hazards.
* :mod:`import_rules` — import-time side effects.
* :mod:`telemetry_rules` — metric-recording hazards (clock choice).

Adding a rule: subclass :class:`relayrl_tpu_torch.analysis.engine.Rule`
in the right module, give it a unique ``code`` + ``name``, yield
``(ast_node, message)`` pairs from ``check``, append it to that module's
``RULES`` list, and add a positive + negative snippet to
``tests/test_torch_analysis.py`` (the registry test enforces code
uniqueness).
"""

from __future__ import annotations

from relayrl_tpu_torch.analysis.engine import Rule
from relayrl_tpu_torch.analysis.rules.concurrency_rules import RULES as _CONC
from relayrl_tpu_torch.analysis.rules.import_rules import RULES as _IMP
from relayrl_tpu_torch.analysis.rules.telemetry_rules import RULES as _TEL
from relayrl_tpu_torch.analysis.rules.torch_rules import RULES as _TORCH

__all__ = ["all_rules", "rules_by_code"]


def all_rules() -> list[Rule]:
    """Fresh instances of every registered rule, stable order."""
    return [cls() for cls in (*_TORCH, *_CONC, *_IMP, *_TEL)]


def rules_by_code() -> dict[str, Rule]:
    out: dict[str, Rule] = {}
    for rule in all_rules():
        if rule.code in out:
            raise ValueError(f"duplicate rule code {rule.code}")
        out[rule.code] = rule
    return out
