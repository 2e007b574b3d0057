"""The port's gRPC backend against the JAX package's, on localhost (CPU).

* The frames both ways are byte-equal: the servicer's replies
  (``SendActions`` acks and typed nacks, ``ClientPoll`` handshakes,
  metadata-only lane registrations and model deliveries, the serving
  plane's "not enabled" nack) and the agent's requests (trajectory
  envelopes, polls, lane registrations), for the same inputs.
* Interop both ways over a live gRPC pair: a port ``Agent`` trains a JAX
  ``TrainingServer`` (its pure-grpcio servicer) and installs its
  model-wire v2 frames bit-exactly; a JAX ``Agent`` trains a port server
  and installs the port's frames bit-exactly. Both servers run the
  default config, guardrails on.
* A live quarantine nack rides the wire (``TestGrpcNackLive`` of
  ``tests/test_guardrails.py``): a poisoned agent is quarantined, its next
  send comes back as a typed nack and its spool discards the entry — for
  a port agent against a port server and against a JAX server, and a
  JAX agent against a port server.

Tolerances: none — every comparison here is exact. Models are
``mlp_discrete`` 16x16 with 3 value iterations.
"""

import json
import os
import time

import jax
import msgpack
import numpy as np
import pytest

from relayrl_tpu import faults as jax_faults
from relayrl_tpu import telemetry as jax_telemetry
from relayrl_tpu.transport import base as jax_base
from relayrl_tpu.transport import grpc_backend as jax_grpc
from relayrl_tpu_torch import faults, telemetry
from relayrl_tpu_torch.transport import base as port_base
from relayrl_tpu_torch.transport import grpc_backend as port_grpc
from relayrl_tpu_torch.weights import params_to_jax, tree_digest
from tests._util import free_port

HP = {"traj_per_epoch": 2, "hidden_sizes": [16, 16], "train_vf_iters": 3,
      "with_vf_baseline": True, "bucket_lengths": [16], "seed_salt": 0}
CONFIG = {"transport": {"small_model_bytes": 0, "keyframe_interval": 3}}

BACKENDS = {"jax": (jax_grpc, jax_base), "port": (port_grpc, port_base)}


@pytest.fixture(autouse=True)
def _clean_planes():
    for mod in (faults, telemetry, jax_faults, jax_telemetry):
        mod.reset_for_tests()
    yield
    for mod in (faults, telemetry, jax_faults, jax_telemetry):
        mod.reset_for_tests()


# -- frames ----------------------------------------------------------------

class _Context:
    def is_active(self):
        return True


def _servicer(pkg, verdict=None, version=3):
    grpc_mod, _ = BACKENDS[pkg]
    owner = grpc_mod.GrpcServerTransport("127.0.0.1:0", idle_timeout_s=0.05)
    owner.received = []
    owner.registered = []
    owner.on_trajectory = lambda a, p: owner.received.append((a, p))
    owner.on_register = owner.registered.append
    owner.get_model = lambda: (version, b"full-bundle-bytes")
    owner.get_model_update = lambda known: (version,
                                            b"delta-from-%d" % known)
    owner.get_model_version = lambda: version
    if verdict is not None:
        owner.check_ingest = lambda agent_id: verdict
    return grpc_mod._Servicer(owner), owner


def _envelope(pkg, agent_id, payload):
    return BACKENDS[pkg][1].pack_trajectory_envelope(agent_id, payload)


@pytest.mark.parametrize("case", ["ack", "malformed", "quarantined",
                                  "overloaded"])
def test_send_actions_replies_byte_equal(case):
    replies, seen = {}, {}
    for pkg in BACKENDS:
        base = BACKENDS[pkg][1]
        verdict = {"quarantined": (base.NACK_QUARANTINED,
                                   "agent quarantined", 12.5),
                   "overloaded": (base.NACK_OVERLOADED, "ingest overloaded",
                                  1.0)}.get(case)
        servicer, owner = _servicer(pkg, verdict)
        request = (b"\x00not-an-envelope" if case == "malformed"
                   else _envelope(pkg, "agent#s3", b"traj-bytes"))
        replies[pkg] = servicer.send_actions(request, _Context())
        seen[pkg] = owner.received
    assert replies["port"] == replies["jax"]
    assert seen["port"] == seen["jax"]
    reply = msgpack.unpackb(replies["port"], raw=False)
    if case == "ack":
        assert reply == {"code": 1}
        assert seen["port"] == [("agent#s3", b"traj-bytes")]
    elif case in ("quarantined", "overloaded"):
        assert reply["code"] in (port_base.NACK_QUARANTINED,
                                 port_base.NACK_OVERLOADED)
        assert seen["port"] == []


@pytest.mark.parametrize("request_fields", [
    {"id": "a", "ver": -1, "first": True},
    {"id": "a.lane1", "ver": 3, "first": True},
    {"id": "a", "ver": -1, "first": False},
    {"id": "a", "ver": 1, "first": False},
    {"id": "a", "ver": 3, "first": False},
], ids=["handshake", "lane_registration", "resync", "delta", "idle"])
def test_client_poll_replies_byte_equal(request_fields):
    request = msgpack.packb(request_fields, use_bin_type=True)
    replies, registered = {}, {}
    for pkg in BACKENDS:
        servicer, owner = _servicer(pkg)
        replies[pkg] = servicer.client_poll(request, _Context())
        registered[pkg] = owner.registered
    assert replies["port"] == replies["jax"]
    assert registered["port"] == registered["jax"]


def test_serving_rpc_answers_not_enabled_byte_equal():
    replies = {}
    for pkg in BACKENDS:
        servicer, _ = _servicer(pkg)
        replies[pkg] = (servicer.get_actions(b"request", _Context()),
                        list(servicer.stream_actions(iter([b"r"]),
                                                     _Context())))
    assert replies["port"] == replies["jax"]
    reply = msgpack.unpackb(replies["port"][0], raw=False)
    assert reply["code"] == port_base.NACK_UNAVAILABLE


def test_agent_requests_byte_equal(monkeypatch):
    sent = {}
    for pkg in BACKENDS:
        grpc_mod, _ = BACKENDS[pkg]
        agent = grpc_mod.GrpcAgentTransport("127.0.0.1:1", identity="agent-x")
        calls = []

        def send(req, timeout=None, calls=calls):
            calls.append(("send", req))
            return msgpack.packb({"code": 1})

        def poll(req, timeout=None, calls=calls):
            calls.append(("poll", req))
            return msgpack.packb({"code": 1, "ver": 0})

        agent._send, agent._poll = send, poll
        agent.send_trajectory(b"traj-bytes", agent_id="agent-x.lane0#s4")
        assert agent.register("agent-x.lane0")
        agent._known_version = 7
        assert agent.register("agent-x.lane1")
        sent[pkg] = calls
        agent.close()
    assert sent["port"] == sent["jax"]
    assert len(sent["port"]) == 3


def test_agent_raises_typed_nack():
    agent = port_grpc.GrpcAgentTransport("127.0.0.1:1", identity="x")
    agent._send = lambda req, timeout=None: msgpack.packb(
        {"code": port_base.NACK_QUARANTINED, "error": "agent quarantined",
         "retry_after_s": 9.0})
    with pytest.raises(port_base.IngestNack) as err:
        agent.send_trajectory(b"traj")
    assert err.value.quarantined and err.value.retry_after_s == 9.0
    agent.close()


def test_factories_build_grpc_and_refuse_native(tmp_cwd):
    from relayrl_tpu_torch.config import ConfigLoader
    from relayrl_tpu_torch.transport import (
        make_agent_transport,
        make_server_transport,
    )

    config = ConfigLoader(None, None, create_if_missing=False)
    addr = f"127.0.0.1:{free_port()}"
    server = make_server_transport("grpc", config, bind_addr=addr)
    agent = make_agent_transport("grpc", config, server_addr=addr,
                                 probe=False, identity="fx")
    assert isinstance(server, port_grpc.GrpcServerTransport)
    assert isinstance(agent, port_grpc.GrpcAgentTransport)
    assert agent._poll_timeout_s == config.get_grpc_idle_timeout_s() + 5.0
    agent.close()
    for maker in (make_server_transport, make_agent_transport):
        with pytest.raises(NotImplementedError, match="item 4"):
            maker("native", config)


# -- live pairs ------------------------------------------------------------

def _config(tmp, **sections) -> str:
    path = os.path.join(str(tmp), "grpc_config.json")
    with open(path, "w") as f:
        json.dump({**CONFIG, **sections}, f)
    return path


def _port_server(tmp, addr, config_path):
    from relayrl_tpu_torch.runtime.server import TrainingServer

    return TrainingServer("REINFORCE", obs_dim=4, act_dim=2,
                          env_dir=str(tmp), config_path=config_path,
                          hyperparams=dict(HP), server_type="grpc",
                          bind_addr=addr, device="cpu")


def _jax_server(tmp, addr, config_path):
    from relayrl_tpu.runtime.server import TrainingServer as JaxServer

    # native_grpc=False pins the pure-grpcio servicer: the plane that
    # carries the typed nack back-channel.
    return JaxServer("REINFORCE", obs_dim=4, act_dim=2, env_dir=str(tmp),
                     config_path=config_path, hyperparams=dict(HP),
                     server_type="grpc", bind_addr=addr, native_grpc=False)


def _drive(agent, rng, n, steps=5, rew=1.0):
    for _ in range(n):
        for _ in range(steps):
            agent.request_for_action(rng.standard_normal(4).astype(np.float32))
        agent.flag_last_action(rew, terminated=True)


def _wait(pred, what, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_port_agent_trains_jax_server(tmp_cwd):
    from relayrl_tpu_torch.runtime.agent import Agent

    addr = f"127.0.0.1:{free_port()}"
    config_path = _config(tmp_cwd)
    server = _jax_server(tmp_cwd, addr, config_path)
    try:
        server.wait_warmup(timeout=120)
        agent = Agent(server_type="grpc", server_addr=addr,
                      config_path=config_path, seed=0, probe=False,
                      device="cpu")
        try:
            rng = np.random.default_rng(1)
            for target in (1, 2, 3):
                _drive(agent, rng, 2)
                _wait(lambda: agent.model_version == target
                      == server.stats["updates"],
                      f"the port agent to install version {target}")
            assert server.drain(timeout=30)
            version, _arch, host = server._bundle_host
            assert version == agent.model_version == 3
            assert tree_digest(params_to_jax(agent.actor.params)) == \
                tree_digest(host)
            dec = agent.actor._wire_decoder
            assert dec.keyframes_applied >= 1 and dec.deltas_applied >= 1
            row = server.ingest_accounting()["agents"][agent.transport.identity]
            assert row == {"max_seq": 6, "accepted": 6, "contiguous": True}
            assert server.guardrails_accounting()["quarantine"][
                "quarantines_total"] == 0
        finally:
            agent.disable_agent()
    finally:
        server.disable_server()


def test_jax_agent_trains_port_server(tmp_cwd):
    from relayrl_tpu.runtime.agent import Agent as JaxAgent

    addr = f"127.0.0.1:{free_port()}"
    config_path = _config(tmp_cwd)
    server = _port_server(tmp_cwd, addr, config_path)
    try:
        assert server.guardrails is not None
        agent = JaxAgent(server_type="grpc", server_addr=addr,
                         config_path=config_path, seed=0, probe=False)
        try:
            rng = np.random.default_rng(2)
            for target in (1, 2, 3):
                _drive(agent, rng, 2)
                _wait(lambda: agent.model_version == target
                      == server.stats["updates"],
                      f"the JAX agent to install version {target}")
            assert server.drain(timeout=30)
            got_version, digest = server.published_digest()
            assert agent.model_version == got_version == 3
            assert tree_digest(jax.device_get(agent.actor.params)) == digest
            dec = agent.actor._wire_decoder
            assert dec.keyframes_applied >= 1 and dec.deltas_applied >= 1
            row = server.ingest_accounting()["agents"][agent.transport.identity]
            assert row == {"max_seq": 6, "accepted": 6, "contiguous": True}
            assert server.stats["learner_errors"] == 0
            assert server.guardrails_accounting()["watchdog"][
                "trips_total"] == 0
        finally:
            agent.disable_agent()
    finally:
        server.disable_server()


@pytest.mark.parametrize("pair", ["port->port", "port->jax", "jax->port"])
def test_quarantine_nack_rides_the_wire(pair, tmp_cwd):
    """A poison stream quarantines the agent server-side; its next (clean)
    send comes back as a typed nack, and the agent's spool discards the
    entry instead of retaining poison for replay."""
    agent_pkg, server_pkg = pair.split("->")
    tel = telemetry if agent_pkg == "port" else jax_telemetry
    tel.set_registry(tel.Registry(run_id=f"grpc-nack-{pair}"))
    config_path = _config(tmp_cwd, guardrails={
        "strike_threshold": 1, "quarantine_cooldown_s": 300.0})
    addr = f"127.0.0.1:{free_port()}"
    server = (_port_server if server_pkg == "port" else _jax_server)(
        tmp_cwd, addr, config_path)
    try:
        if agent_pkg == "port":
            from relayrl_tpu_torch.runtime.agent import Agent

            agent = Agent(server_type="grpc", server_addr=addr,
                          config_path=config_path, seed=0, probe=False,
                          device="cpu")
        else:
            from relayrl_tpu.runtime.agent import Agent as JaxAgent

            agent = JaxAgent(server_type="grpc", server_addr=addr,
                             config_path=config_path, seed=0, probe=False)
        try:
            rng = np.random.default_rng(3)
            _drive(agent, rng, 1, steps=2, rew=float("nan"))
            _wait(lambda: server.guardrails.quarantine.quarantines_total
                  == 1, "the quarantine")
            depth_before = agent.spool.depth
            _drive(agent, rng, 2, steps=2)
            snap = tel.get_registry().snapshot()
            nacked = sum(m["value"] for m in snap["metrics"]
                         if m["name"] == "relayrl_spool_nacked_total")
            assert nacked == 2, "the typed nacks never reached the spool"
            assert agent.spool.depth == depth_before
            assert agent.spool.breaker.allow()
            acct = server.guardrails_accounting()
            assert acct["quarantine"]["quarantined"] == [
                agent.transport.identity]
            assert server.stats["trajectories"] == 0
        finally:
            agent.disable_agent()
    finally:
        server.disable_server()
