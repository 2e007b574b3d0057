"""Bounded ingest admission: overload sheds gracefully instead of
ballooning the queue.

The raw ingest queue's hard cap (100k entries) exists to avoid OOM; by
the time it bites, the learner is minutes behind and every drop is
indiscriminate. The :class:`AdmissionController` adds a *soft* bound
with a configurable shed policy well before that cliff:

* **per-agent fairness first** — an agent holding more than
  ``agent_share`` of the soft limit sheds ITS OWN new arrivals (a
  flooding agent cannot starve the rest of the fleet; the ``flood``
  fault op drills exactly this);
* ``drop_oldest`` (default) — at the soft limit, the globally oldest
  queued trajectory is evicted to admit the new one (freshest-data-wins,
  the right default for on-policy learners). The victim's sequence
  number is retracted from the dedup ledger, so the owning actor's spool
  replay can redeliver it when pressure clears — a shed is backpressure,
  not loss;
* ``nack`` — the incoming send is refused with a typed
  retry-after nack (transports with a back-channel deliver it; the
  actor's spool keeps the entry and replays later, riding the existing
  RetryPolicy cadence).

The controller only tracks counts; the server owns the queue and hands
in an eviction callback, so queue discipline stays in one place.

A copy of :mod:`relayrl_tpu.guardrails.admission`.
"""

from __future__ import annotations

import threading

SHED_POLICIES = ("drop_oldest", "nack")


class AdmissionController:
    """Per-agent in-queue accounting + soft-bound shed decisions."""

    def __init__(self, soft_limit: int, policy: str = "drop_oldest",
                 agent_share: float = 0.5, retry_after_s: float = 1.0):
        from relayrl_tpu_torch import telemetry

        self.soft_limit = max(0, int(soft_limit))
        self.policy = policy if policy in SHED_POLICIES else "drop_oldest"
        self.agent_share = min(1.0, max(0.0, float(agent_share)))
        self.retry_after_s = max(0.0, float(retry_after_s))
        self._lock = threading.Lock()
        self._per_agent: dict[str, int] = {}
        self._depth = 0
        self.sheds = {"agent_share": 0, "drop_oldest": 0, "nack": 0}
        reg = telemetry.get_registry()
        self._m_shed = {
            kind: reg.counter(
                "relayrl_guard_shed_total",
                "trajectories shed by ingest backpressure",
                {"policy": kind})
            for kind in self.sheds
        }

    @property
    def agent_cap(self) -> int:
        """Max queue entries one agent may hold (0 = no per-agent cap)."""
        if not self.soft_limit or self.agent_share >= 1.0:
            return 0
        return max(1, int(self.soft_limit * self.agent_share))

    def admit(self, agent_id: str) -> str:
        """Decide for one arriving trajectory: ``"admit"``,
        ``"shed_agent"`` (sender over its fair share), ``"evict"``
        (admit after the caller evicts the global oldest), or
        ``"nack"``. The caller performs the queue action and then calls
        :meth:`note_enqueued` for admitted items."""
        if not self.soft_limit:
            return "admit"
        cap = self.agent_cap
        with self._lock:
            if cap and self._per_agent.get(agent_id, 0) >= cap:
                self.sheds["agent_share"] += 1
                verdict = "shed_agent"
            elif self._depth >= self.soft_limit:
                if self.policy == "nack":
                    self.sheds["nack"] += 1
                    verdict = "nack"
                else:
                    self.sheds["drop_oldest"] += 1
                    verdict = "evict"
            else:
                return "admit"
        kind = {"shed_agent": "agent_share", "nack": "nack",
                "evict": "drop_oldest"}[verdict]
        self._m_shed[kind].inc()
        return verdict

    def note_enqueued(self, agent_id: str) -> None:
        with self._lock:
            self._depth += 1
            self._per_agent[agent_id] = self._per_agent.get(agent_id, 0) + 1

    def note_dequeued(self, agent_id: str) -> None:
        with self._lock:
            self._depth = max(0, self._depth - 1)
            n = self._per_agent.get(agent_id, 0) - 1
            if n > 0:
                self._per_agent[agent_id] = n
            else:
                self._per_agent.pop(agent_id, None)

    def accounting(self) -> dict:
        with self._lock:
            return {"depth": self._depth, "sheds": dict(self.sheds),
                    "soft_limit": self.soft_limit, "policy": self.policy}


__all__ = ["AdmissionController", "SHED_POLICIES"]
