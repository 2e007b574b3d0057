"""Lightweight agent instrumentation (wire bytes + env steps).

One shared implementation for every harness that needs to know what an
actor actually puts on the wire (the e2e
byte-plane guard test): wrapping ``transport.send_trajectory`` counts
REAL serialized payload bytes identically on all three transports, and
wrapping ``request_for_action`` counts one per env step — dividing one
by the other gives the true per-step wire cost, framing and scalar
overhead included.
"""

from __future__ import annotations


def instrument_agent(agent) -> dict:
    """Wrap ``agent``'s send + step paths with counters, in place.

    Returns the live counter dict ``{"bytes", "sends", "steps"}``.
    Wrappers forward to the originals, so behavior is unchanged; safe
    because Agent's trajectory ``on_send`` hook late-binds
    ``self.transport.send_trajectory``."""
    counters = {"bytes": 0, "sends": 0, "steps": 0}
    inner_send = agent.transport.send_trajectory
    inner_step = agent.request_for_action

    def counting_send(raw: bytes, agent_id: str | None = None):
        # agent_id: the transports' logical-lane attribution kwarg — the
        # spool also rides its sequence tag on it; forward verbatim.
        counters["bytes"] += len(raw)
        counters["sends"] += 1
        return inner_send(raw, agent_id=agent_id)

    def counting_step(obs, **kw):
        counters["steps"] += 1
        return inner_step(obs, **kw)

    agent.transport.send_trajectory = counting_send
    agent.request_for_action = counting_step
    return counters
