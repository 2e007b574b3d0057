"""Fault-injection plane (chaos engineering for the actor↔learner loop).

Process model mirrors :mod:`relayrl_tpu_torch.telemetry`: at most ONE
:class:`~relayrl_tpu_torch.faults.plan.FaultPlan` per process, installed
explicitly (:func:`install_plan`) or from the ``RELAYRL_FAULT_PLAN`` env
var — a path to a plan JSON — via :func:`maybe_install_from_env`, which
every config-bearing runtime component (TrainingServer, Agent,
VectorAgent) calls at construction. With no plan installed every hook
site resolves to ``None`` and the hot-path cost is one identity check
per operation; production processes that never set the env var pay
nothing and can never fault themselves.

Hook sites (see plan.KNOWN_SITES and docs/operations.md):

* ``agent.send``     — trajectory envelopes leaving an agent transport
* ``agent.model``    — model frames arriving at an agent transport
* ``agent.infer``    — serving-plane action requests leaving a thin
  client (RemoteActorClient; drop → timeout-retry, corrupt → service
  decode guard → error reply → retry)
* ``server.publish`` — model frames leaving the server transport
* ``server.ingest``  — trajectory envelopes arriving at the server
* ``actor.step``     — env-loop steps (kill_process drills)

Every injection increments ``relayrl_faults_injected_total{site,op}``
and lands a ``fault_injected`` event in the run journal, so a chaos
artifact carries its own injection ledger alongside the recovery
counters it provoked.

A copy of :mod:`relayrl_tpu.faults`.
"""

from __future__ import annotations

import os
import threading

from relayrl_tpu_torch.faults.plan import (  # noqa: F401
    FAULT_OPS,
    KNOWN_SITES,
    FaultPlan,
    FaultRule,
    SiteInjector,
    corrupt_bytes,
)

_lock = threading.Lock()
_plan: FaultPlan | None = None

ENV_VAR = "RELAYRL_FAULT_PLAN"


def install_plan(plan: FaultPlan | None) -> FaultPlan | None:
    """Install (or clear, with None) the process fault plan. Components
    constructed AFTER the install see its sites; the chaos harness
    installs before building agents/servers."""
    global _plan
    with _lock:
        _plan = plan
        return _plan


def get_plan() -> FaultPlan | None:
    return _plan


def maybe_install_from_env() -> FaultPlan | None:
    """Idempotently install the plan named by ``RELAYRL_FAULT_PLAN``
    (a JSON file path). A missing/unreadable file degrades loudly to
    no-plan: the fault plane must never take down the process it tests."""
    global _plan
    path = os.environ.get(ENV_VAR)
    if not path:
        return _plan
    with _lock:
        if _plan is not None:
            return _plan
        try:
            _plan = FaultPlan.from_file(path)
            print(f"[faults] plan installed from {path}: seed="
                  f"{_plan.seed}, {len(_plan.rules)} rule(s)", flush=True)
        except Exception as e:
            # ANY malformed plan (bad JSON, wrong types, a list root —
            # TypeError territory, not just ValueError) must degrade to
            # no-plan: this runs inside Agent/TrainingServer
            # constructors, and the fault plane must never take down the
            # process it tests.
            print(f"[faults] plan at {path} unusable ({e!r}) — running "
                  f"fault-free", flush=True)
        return _plan


def deactivate() -> None:
    """Stop all injection (cached site injectors pass through from the
    next op on). The chaos harness calls this before its convergence
    phase: faults stop, then the system must prove it heals."""
    plan = _plan
    if plan is not None:
        plan.active = False


def site(name: str) -> SiteInjector | None:
    """The installed plan's injector for ``name``, or None (the common
    case — hook points cache this at construction)."""
    plan = _plan
    return None if plan is None else plan.site(name)


def reset_for_tests() -> None:
    global _plan
    with _lock:
        _plan = None


__all__ = [
    "FAULT_OPS", "KNOWN_SITES", "FaultPlan", "FaultRule", "SiteInjector",
    "corrupt_bytes", "install_plan", "get_plan", "maybe_install_from_env",
    "site", "deactivate", "reset_for_tests", "ENV_VAR",
]
