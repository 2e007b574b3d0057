"""Deterministic, seed-driven fault plans (the chaos-engineering plane).

A :class:`FaultPlan` is a seed plus a list of :class:`FaultRule`\\ s, each
bound to a named hook *site* (``agent.send``, ``agent.model``,
``server.publish``, ``server.ingest``, ``actor.step`` — the sites the
transports and runtime expose; see docs/operations.md "Failure modes &
recovery"). Every decision is a pure function of ``(seed, site, op_index,
rule_index, salt)`` through BLAKE2b — no global RNG, no wall clock — so
the same plan JSON + seed reproduces the exact injection schedule in any
process, interpreter, or machine (``FaultPlan.schedule`` materializes it;
tests/test_faults.py asserts byte-identity).

Fault ops:

* ``drop``            — the frame never reaches the wire / the handler.
* ``delay``           — the frame is held ``delay_s`` before delivery.
* ``duplicate``       — the frame is delivered twice (retry storm shape).
* ``reorder``         — the frame is held back and emitted after the next
                        one (swap-with-next; network reordering shape).
* ``corrupt``         — ``corrupt_bytes`` flips bytes mid-frame (exercises
                        CRC rejection / decode-error narrowing).
* ``nan_poison``      — decodes the trajectory payload, patches finite
                        floats (rewards + tensor elements) to NaN/Inf,
                        and re-encodes — a VALID frame carrying poison
                        data, the guardrail ingest-validation drill
                        (corrupt breaks the envelope; this breaks the
                        *semantics*). Non-trajectory payloads pass
                        through untouched.
* ``flood``           — burst-amplifies the send ``flood_factor``× (the
                        ingest-backpressure / per-agent-fairness drill).
* ``kill_connection`` — the transport abruptly closes its live socket
                        (heal/redial paths take over).
* ``kill_process``    — the hosting process SIGKILLs itself (the actor
                        crash drill; honored only by loops that opt in
                        via ``take_kill_process``).

Rules fire per-op with probability ``prob``, or exactly at op index
``at``; ``after``/``until`` bound the active window and ``count`` caps
total firings. Injection never raises into the host code path — a fault
plane bug must degrade to "no fault", not take down the system under
test.

A copy of :mod:`relayrl_tpu.faults.plan`.
"""

from __future__ import annotations

import hashlib
import json
import struct
import threading
from dataclasses import dataclass, field

FAULT_OPS = ("drop", "delay", "duplicate", "reorder", "corrupt",
             "nan_poison", "flood", "kill_connection", "kill_process")

#: Hook sites the runtime/transports expose (free-form sites are legal —
#: a rule naming a site nobody hooks simply never fires).
#: ``agent.infer`` is the serving plane's request/response channel
#: (runtime/inference.RemoteActorClient): drop surfaces as a timeout →
#: retry, corrupt dies in the service's decode guard → error reply →
#: retry, delay stalls the attempt — the thin-client chaos drill.
#: The ``relay.*`` trio is the relay node's plane (relayrl_tpu_torch/relay/):
#: ``relay.model`` injects between the upstream subscription and the
#: downstream re-broadcast (corrupt dies in the per-hop CRC check, drop
#: exercises subtree resync-from-cache), ``relay.forward`` between
#: subtree ingest and the upstream batch-forward (spool replay + root
#: dedup must make the loop whole), and ``relay.step`` is where the
#: relay's run loop polls ``kill_process`` — the relay crash drill.
KNOWN_SITES = ("agent.send", "agent.model", "agent.infer",
               "server.publish", "server.ingest", "actor.step",
               "relay.model", "relay.forward", "relay.step")


def _u01(seed: int, site: str, op_index: int, rule_index: int,
         salt: int) -> float:
    """Uniform [0,1) from a keyed BLAKE2b — stable across processes and
    PYTHONHASHSEED (the determinism contract)."""
    h = hashlib.blake2b(
        f"{seed}:{site}:{op_index}:{rule_index}:{salt}".encode(),
        digest_size=8).digest()
    return struct.unpack(">Q", h)[0] / 2.0**64


def corrupt_bytes(payload: bytes, seed: int, site: str,
                  op_index: int) -> bytes:
    """Deterministically flip a few bytes mid-payload (never the first
    byte: frame-type sniffing should survive so the corruption lands in
    the decoder/CRC, the interesting failure)."""
    if len(payload) < 2:
        return b"\xff" + payload
    out = bytearray(payload)
    n_flips = 1 + len(payload) // 4096
    for i in range(n_flips):
        pos = 1 + int(_u01(seed, site, op_index, 10_000 + i, 0)
                      * (len(out) - 1))
        out[pos] ^= 0x5A
    return bytes(out)


def nan_poison_bytes(payload: bytes, seed: int, site: str,
                     op_index: int) -> bytes:
    """Deterministically patch a trajectory payload's finite floats to
    NaN/Inf and re-encode: a frame that stays wire-VALID (envelope, CRC,
    msgpack all intact) but carries semantically poisoned data — the
    guardrail ingest-validation drill. Handles both shapes the hook
    sites see: the ``agent.send`` envelope (``{"id", "traj"}``) and the
    bare ``server.ingest`` trajectory frame. Rewards become NaN and the
    first element of each float obs tensor becomes +/-Inf (alternating
    off the plan hash, so drills exercise both non-finite kinds).
    Anything that fails to decode as a Python-codec trajectory (native
    columnar frames, model bundles, junk) passes through untouched —
    injection must never raise into the host path."""
    try:
        import msgpack
        import numpy as np

        from relayrl_tpu_torch.types.trajectory import (
            deserialize_actions,
            serialize_actions,
        )

        agent_id = None
        body = payload
        try:
            env = msgpack.unpackb(bytes(payload), raw=False)
            if isinstance(env, dict) and "traj" in env:
                agent_id = str(env.get("id", "?"))
                body = env["traj"]
        except Exception:
            pass  # not an envelope: try the bare trajectory frame
        records = deserialize_actions(body)
        if not records:
            return payload
        bad = (np.inf if _u01(seed, site, op_index, 20_000, 0) < 0.5
               else -np.inf)
        for rec in records:
            rec.rew = float("nan")
            obs = rec.obs
            if (isinstance(obs, np.ndarray) and obs.dtype.kind == "f"
                    and obs.size):
                obs = obs.copy()
                obs.flat[0] = bad
                rec.obs = obs
        body = serialize_actions(records)
        if agent_id is not None:
            return msgpack.packb({"id": agent_id, "traj": body},
                                 use_bin_type=True)
        return body
    except Exception:
        return payload


@dataclass
class FaultRule:
    site: str
    op: str
    prob: float = 0.0          # per-op firing probability
    at: int | None = None      # fire exactly at this op index instead
    after: int = 0             # active window: op index >= after
    until: int | None = None   # active window: op index < until
    count: int | None = None   # cap on total firings (None = unbounded)
    delay_s: float = 0.0       # for op == "delay"
    flood_factor: int = 8      # for op == "flood": total copies delivered
    salt: int = 0              # decorrelates rules sharing (site, prob)

    def __post_init__(self):
        if self.op not in FAULT_OPS:
            raise ValueError(f"unknown fault op {self.op!r} "
                             f"(one of {FAULT_OPS})")
        if self.at is None and not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0,1], got {self.prob}")

    def to_dict(self) -> dict:
        d = {"site": self.site, "op": self.op}
        if self.at is not None:
            d["at"] = self.at
        else:
            d["prob"] = self.prob
        if self.after:
            d["after"] = self.after
        if self.until is not None:
            d["until"] = self.until
        if self.count is not None:
            d["count"] = self.count
        if self.delay_s:
            d["delay_s"] = self.delay_s
        if self.op == "flood" and self.flood_factor != 8:
            d["flood_factor"] = self.flood_factor
        if self.salt:
            d["salt"] = self.salt
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        return cls(site=str(d["site"]), op=str(d["op"]),
                   prob=float(d.get("prob", 0.0)),
                   at=(None if d.get("at") is None else int(d["at"])),
                   after=int(d.get("after", 0)),
                   until=(None if d.get("until") is None
                          else int(d["until"])),
                   count=(None if d.get("count") is None
                          else int(d["count"])),
                   delay_s=float(d.get("delay_s", 0.0)),
                   flood_factor=int(d.get("flood_factor", 8)),
                   salt=int(d.get("salt", 0)))

    def fires(self, seed: int, op_index: int, fired_so_far: int) -> bool:
        """Pure decision for one op — the determinism kernel."""
        if op_index < self.after:
            return False
        if self.until is not None and op_index >= self.until:
            return False
        if self.count is not None and fired_so_far >= self.count:
            return False
        if self.at is not None:
            return op_index == self.at
        if self.prob <= 0.0:
            return False
        return _u01(seed, self.site, op_index,
                    id_stable(self), self.salt) < self.prob


def id_stable(rule: FaultRule) -> int:
    """A rule's stable index-within-plan substitute: plans key decisions
    by the rule's position, set by FaultPlan at construction."""
    return getattr(rule, "_plan_index", 0)


@dataclass
class _Decision:
    """What a site injector decided for one op (returned by schedule)."""

    op_index: int
    ops: list  # fired op names, in rule order

    def to_dict(self) -> dict:
        return {"i": self.op_index, "ops": list(self.ops)}


#: Decision domains: each entry point advances its OWN op counter and
#: decides only the rules it can actually apply — ``inject`` the payload
#: ops, ``take_kill_connection``/``take_kill_process`` their kill op.
#: Without the split, a send site polling kills before injecting would
#: consume two indices per op, and a fired-but-unapplied rule would
#: corrupt the injection ledger (counted faults that never happened).
_OP_CLASS = {"drop": "payload", "delay": "payload",
             "duplicate": "payload", "reorder": "payload",
             "corrupt": "payload", "nan_poison": "payload",
             "flood": "payload", "kill_connection": "kill_connection",
             "kill_process": "kill_process"}


class SiteInjector:
    """Per-site fault applicator: owns per-domain op counters and the
    reorder hold-back buffer. Thread-safe (transports may hit one site
    from several threads). Obtain via :meth:`FaultPlan.site`."""

    def __init__(self, plan: "FaultPlan", site: str,
                 rules: list[FaultRule]):
        self._plan = plan
        self.site = site
        self._rules = rules
        self._lock = threading.Lock()
        self._op_index = {"payload": 0, "kill_connection": 0,
                          "kill_process": 0}
        self._fired = [0] * len(rules)
        self._held: list[bytes] = []  # reorder hold-back
        self.injected = 0  # total faults fired (observable for tests)
        from relayrl_tpu_torch import telemetry

        reg = telemetry.get_registry()
        self._m = {
            op: reg.counter(
                "relayrl_faults_injected_total",
                "fault-plan injections fired at hook sites",
                {"site": site, "op": op})
            for op in FAULT_OPS
        }

    def _decide(self, domain: str) -> list[FaultRule]:
        """Advance ``domain``'s op counter and return its fired rules
        (in rule order), so appliers see each rule's own parameters
        (delay_s). Every returned rule WILL be applied by the caller —
        the ledger invariant."""
        with self._lock:
            k = self._op_index[domain]
            self._op_index[domain] += 1
            fired = []
            for i, rule in enumerate(self._rules):
                if (_OP_CLASS[rule.op] == domain
                        and rule.fires(self._plan.seed, k, self._fired[i])):
                    self._fired[i] += 1
                    fired.append(rule)
            if fired:
                self.injected += len(fired)
        for rule in fired:
            self._m[rule.op].inc()
        if fired:
            from relayrl_tpu_torch import telemetry

            telemetry.emit("fault_injected", site=self.site,
                           ops=[r.op for r in fired], op_index=k)
        return fired

    def inject(self, payload: bytes) -> list[tuple[float, bytes]]:
        """Run one payload through the plan: returns ``[(delay_s,
        payload), ...]`` for the caller to deliver in order (empty =
        dropped). ``corrupt`` mutates bytes; ``duplicate`` doubles the
        entry; ``reorder`` holds this payload back and prepends it to the
        NEXT op's delivery; ``delay`` attaches a sleep the caller honors
        OUTSIDE any lock. kill ops are not applied here — poll
        :meth:`take_kill_connection` / :meth:`take_kill_process`."""
        if not self._plan.active:
            # deactivated plan: pass-through, but still release any
            # reorder hold-back so no frame is stranded
            with self._lock:
                held, self._held = self._held, []
            return [(0.0, h) for h in held] + [(0.0, payload)]
        fired = self._decide("payload")
        k = self._op_index["payload"] - 1
        delay = 0.0
        out_payload = payload
        copies = 1
        dropped = reordered = False
        for rule in fired:
            if rule.op == "drop":
                dropped = True
            elif rule.op == "delay":
                delay += rule.delay_s  # several delay rules stack
            elif rule.op == "duplicate":
                copies += 1
            elif rule.op == "reorder":
                reordered = True
            elif rule.op == "corrupt":
                out_payload = corrupt_bytes(out_payload, self._plan.seed,
                                            self.site, k)
            elif rule.op == "nan_poison":
                out_payload = nan_poison_bytes(out_payload,
                                               self._plan.seed,
                                               self.site, k)
            elif rule.op == "flood":
                # Burst-amplify: this op delivers flood_factor copies in
                # one call (stacks multiplicatively with duplicate — a
                # retry storm atop a flood is a legal drill).
                copies *= max(1, int(rule.flood_factor))
        with self._lock:
            held, self._held = self._held, []
        out: list[tuple[float, bytes]] = [(0.0, h) for h in held]
        if dropped:
            return out
        if reordered:
            with self._lock:
                self._held.append(out_payload)
            return out
        out.extend((delay, out_payload) for _ in range(copies))
        return out

    def _take_kill(self, op: str) -> bool:
        if not self._plan.active:
            return False
        # Cheap short-circuit: a site with no rules of this kill kind
        # must not advance the domain counter at all (the common case —
        # payload-only plans polled by send paths every op).
        if not any(_OP_CLASS[r.op] == op for r in self._rules):
            return False
        return any(rule.op == op for rule in self._decide(op))

    def take_kill_connection(self) -> bool:
        """Poll-style check for connection kills (its own op domain —
        polling it never perturbs the payload-op schedule)."""
        return self._take_kill("kill_connection")

    def take_kill_process(self) -> bool:
        """Poll-style check for process kills (its own op domain)."""
        return self._take_kill("kill_process")


class FaultPlan:
    """Seed + rules; JSON round-trippable; hands out per-site injectors."""

    def __init__(self, seed: int = 0, rules: list[FaultRule] | None = None):
        self.seed = int(seed)
        # Kill switch: hook sites cache their SiteInjector, so "stop
        # injecting" must be a flag those injectors consult — the chaos
        # harness deactivates the plan before its convergence phase
        # (faults stop, the system must heal; the standard chaos-
        # engineering shape).
        self.active = True
        self.rules = list(rules or [])
        for i, rule in enumerate(self.rules):
            rule._plan_index = i  # stable decision key (see id_stable)
        self._site_injectors: dict[str, SiteInjector] = {}
        self._lock = threading.Lock()

    # -- construction / serialization --
    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "rules": [r.to_dict() for r in self.rules]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(seed=int(d.get("seed", 0)),
                   rules=[FaultRule.from_dict(r)
                          for r in d.get("rules", [])])

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> "FaultPlan":
        with open(path, "r") as f:
            return cls.from_dict(json.load(f))

    # -- injector surface --
    def site(self, site: str) -> SiteInjector | None:
        """The injector for ``site``, or None when no rule targets it —
        hook points keep a None and pay a single identity check per op."""
        rules = [r for r in self.rules if r.site == site]
        if not rules:
            return None
        with self._lock:
            inj = self._site_injectors.get(site)
            if inj is None:
                inj = SiteInjector(self, site, rules)
                self._site_injectors[site] = inj
            return inj

    def injected_total(self) -> int:
        with self._lock:
            return sum(i.injected for i in self._site_injectors.values())

    # -- determinism surface --
    def schedule(self, site: str, n_ops: int) -> list[dict]:
        """Materialize the injection schedule for ``site`` over ops
        ``0..n_ops-1`` WITHOUT consuming any live injector state: the
        reproducibility artifact (same seed + plan → byte-identical
        ``json.dumps(schedule)``). Op indices are per decision DOMAIN
        (payload vs each kill kind — see _OP_CLASS), exactly matching
        the live injector's counters: entry ``{"i": k, "ops": [...]}``
        merges whatever fires at index ``k`` of any domain."""
        rules = [r for r in self.rules if r.site == site]
        fired = [0] * len(rules)
        by_index: dict[int, list[str]] = {}
        for domain in ("payload", "kill_connection", "kill_process"):
            for k in range(n_ops):
                for i, rule in enumerate(rules):
                    if (_OP_CLASS[rule.op] == domain
                            and rule.fires(self.seed, k, fired[i])):
                        fired[i] += 1
                        by_index.setdefault(k, []).append(rule.op)
        return [_Decision(k, by_index[k]).to_dict()
                for k in sorted(by_index)]


__all__ = ["FAULT_OPS", "KNOWN_SITES", "FaultRule", "FaultPlan",
           "SiteInjector", "corrupt_bytes", "nan_poison_bytes"]
