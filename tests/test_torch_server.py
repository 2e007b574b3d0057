"""The port's distributed loop over ZMQ on localhost, on the CPU.

* The full loop: a port ``TrainingServer`` trains from a port ``Agent`` /
  ``VectorAgent`` and the agent installs every publish (model-wire v2
  keyframes and deltas) bit for bit (sha256 of the params tree).
* Replay never trains twice (twin of ``tests/test_recovery.py``'s live
  idempotent-ingest test); drain, then shutdown; checkpoint and resume;
  what the server refuses.
* Interop both ways: a port ``Agent`` feeds a JAX ``TrainingServer`` and
  installs its v2 frames bit-exactly; a JAX ``Agent`` (per-record wire)
  and a JAX anakin ``VectorAgent`` (columnar wire) feed a port server and
  install its frames bit-exactly.
* The same fixed records, sent as bytes to a JAX server and to a port
  server holding the same initial params, give the same first update at
  the learner tests' f32 bars (metrics rtol 1e-4, atol 1e-6 for AdvMean; params atol
  1e-5).
* The learner SIGKILL drill on ``relayrl_tpu_torch/examples/
  chaos_server.py``, with ``tests/test_recovery.py``'s assertions.

Models are ``mlp_discrete`` 16x16 with 3 value iterations, so an update
takes milliseconds; ``transport.small_model_bytes: 0`` makes even these
small models publish v2 frames.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from relayrl_tpu import faults as jax_faults
from relayrl_tpu import telemetry as jax_telemetry
from relayrl_tpu_torch import faults, telemetry
from relayrl_tpu_torch.weights import params_to_jax, tree_digest
from tests._util import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = {"traj_per_epoch": 2, "hidden_sizes": [16, 16], "train_vf_iters": 3,
      "with_vf_baseline": True, "bucket_lengths": [16], "seed_salt": 0}
CONFIG = {"guardrails": {"enabled": False},
          "transport": {"small_model_bytes": 0, "keyframe_interval": 3}}
F32_METRIC_RTOL, F32_METRIC_ATOL, F32_PARAM_ATOL = 1e-4, 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _clean_planes():
    for mod in (faults, telemetry, jax_faults, jax_telemetry):
        mod.reset_for_tests()
    yield
    for mod in (faults, telemetry, jax_faults, jax_telemetry):
        mod.reset_for_tests()


def _config(tmp, **sections) -> str:
    path = os.path.join(str(tmp), "loop_config.json")
    config = {**CONFIG, **sections}
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def _addrs():
    ports = [free_port() for _ in range(3)]
    server = {"agent_listener_addr": f"tcp://127.0.0.1:{ports[0]}",
              "trajectory_addr": f"tcp://127.0.0.1:{ports[1]}",
              "model_pub_addr": f"tcp://127.0.0.1:{ports[2]}"}
    agent = {"agent_listener_addr": server["agent_listener_addr"],
             "trajectory_addr": server["trajectory_addr"],
             "model_sub_addr": server["model_pub_addr"]}
    return server, agent


def _port_server(tmp, server_addrs, config_path, **kw):
    from relayrl_tpu_torch.runtime.server import TrainingServer

    return TrainingServer("REINFORCE", obs_dim=4, act_dim=2,
                          env_dir=str(tmp), config_path=config_path,
                          hyperparams=dict(HP), device="cpu",
                          **server_addrs, **kw)


def _drive(agent, rng, n, steps=5):
    for _ in range(n):
        for _ in range(steps):
            agent.request_for_action(rng.standard_normal(4).astype(np.float32))
        agent.flag_last_action(1.0, terminated=True)


def _wait(pred, what, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _jax_digest(params) -> str:
    return tree_digest(jax.device_get(params))


@pytest.mark.parametrize("vector", [False, True], ids=["Agent", "VectorAgent"])
def test_full_loop_hot_swaps_bit_exact(vector, tmp_cwd):
    from relayrl_tpu_torch.runtime.agent import Agent, VectorAgent

    server_addrs, agent_addrs = _addrs()
    config_path = _config(tmp_cwd)
    server = _port_server(tmp_cwd, server_addrs, config_path)
    rng = np.random.default_rng(0)
    try:
        if vector:
            agent = VectorAgent(num_envs=2, config_path=config_path, seed=0,
                                probe=False, device="cpu", **agent_addrs)
            actor = agent.host
        else:
            agent = Agent(config_path=config_path, seed=0, probe=False,
                          device="cpu", **agent_addrs)
            actor = agent.actor
        try:
            for target in range(1, 5):
                if vector:
                    for _ in range(5):
                        agent.request_for_actions(
                            rng.standard_normal((2, 4)).astype(np.float32))
                    for lane in range(2):
                        agent.flag_last_action(lane, 1.0, terminated=True)
                else:
                    _drive(agent, rng, 2)
                _wait(lambda: agent.model_version == target
                      == server.stats["updates"],
                      f"the agent to install version {target}")
            assert server.stats["updates"] == 4
            assert server.drain(timeout=30)
            version, digest = server.published_digest()
            assert version == agent.model_version == 4
            assert tree_digest(params_to_jax(actor.params)) == digest
            assert tree_digest(params_to_jax(server.algorithm.state.params)) \
                == digest
            dec = actor._wire_decoder
            assert dec.keyframes_applied >= 1 and dec.deltas_applied >= 1
            assert {k for k, v in server.publish_bytes.items() if v} == \
                {"keyframe", "delta"}
            assert server.stats["learner_errors"] == 0
            acct = server.ingest_accounting()["agents"]
            for aid, sent in agent.spool.sent_counts().items():
                assert acct[aid] == {"max_seq": sent, "accepted": sent,
                                     "contiguous": True}
        finally:
            agent.disable_agent()
    finally:
        server.disable_server()


def test_replay_never_double_trains(tmp_cwd):
    from relayrl_tpu_torch.runtime.agent import Agent

    server_addrs, agent_addrs = _addrs()
    config_path = _config(tmp_cwd)
    server = _port_server(tmp_cwd, server_addrs, config_path)
    server.algorithm.traj_per_epoch = 100
    server.algorithm.buffer.traj_per_epoch = 100
    try:
        agent = Agent(config_path=config_path, seed=0, probe=False,
                      device="cpu", **agent_addrs)
        try:
            n_episodes = 6
            _drive(agent, np.random.default_rng(0), n_episodes, steps=3)
            assert agent.spool.replay() == n_episodes
            agent.spool.replay()
            _wait(lambda: server.ingest_accounting()["duplicates"]
                  >= 2 * n_episodes, "the duplicates")
            assert server.drain(timeout=30)
            acct = server.ingest_accounting()
            row = acct["agents"][agent.transport.identity]
            assert row == {"max_seq": n_episodes, "accepted": n_episodes,
                           "contiguous": True}
            assert acct["duplicates"] == 2 * n_episodes
            assert server.stats["trajectories"] == n_episodes
        finally:
            agent.disable_agent()
    finally:
        server.disable_server()


def test_drain_then_shutdown_then_restart(tmp_cwd):
    from relayrl_tpu_torch.runtime.agent import Agent

    server_addrs, agent_addrs = _addrs()
    config_path = _config(tmp_cwd)
    server = _port_server(tmp_cwd, server_addrs, config_path)
    assert server.wait_warmup(timeout=30)
    agent = Agent(config_path=config_path, seed=0, probe=False, device="cpu",
                  **agent_addrs)
    try:
        _drive(agent, np.random.default_rng(1), 6)
        _wait(lambda: server.stats["trajectories"] == 6, "the episodes")
        assert server.drain(timeout=30)
        assert server._learner_pending() == 0
        assert server.stats["updates"] == 3 == server.algorithm.version
        assert server.latest_model_version == 3
        assert server.algorithm.inflight.fenced_count == 3
        assert server.algorithm.epoch == 3  # every deferred log dumped
        server.disable_server()
        assert not server.active and server._learner_thread is None
        server.restart_server()
        _drive(agent, np.random.default_rng(2), 2)
        _wait(lambda: server.stats["updates"] == 4, "an update after restart")
        assert server.drain(timeout=30)
    finally:
        agent.disable_agent()
        server.disable_server()


def test_checkpoint_and_resume(tmp_cwd):
    from relayrl_tpu_torch.runtime.agent import Agent

    server_addrs, agent_addrs = _addrs()
    config_path = _config(tmp_cwd, learner={"checkpoint_every_epochs": 1})
    server = _port_server(tmp_cwd, server_addrs, config_path)
    agent = Agent(config_path=config_path, seed=0, probe=False, device="cpu",
                  **agent_addrs)
    try:
        _drive(agent, np.random.default_rng(3), 4)
        _wait(lambda: server.stats["updates"] == 2, "two updates")
        assert server.drain(timeout=30)
        digest = tree_digest(params_to_jax(server.algorithm.state.params))
        acct = server.ingest_accounting()
    finally:
        agent.disable_agent()
        server.disable_server()
    ckpt = os.path.join(str(tmp_cwd), "checkpoints")
    assert sorted(int(d) for d in os.listdir(ckpt) if d.isdigit()) == [1, 2]
    assert os.path.isfile(os.path.join(ckpt, "ingest_ledger_2.json"))
    resumed = _port_server(tmp_cwd, _addrs()[0], config_path, resume=True,
                           start=False)
    assert resumed.algorithm.version == 2
    assert tree_digest(params_to_jax(resumed.algorithm.state.params)) == digest
    assert resumed.ingest_accounting() == acct
    assert resumed.algorithm.state.pi_opt.state_dict()["state"][0]["step"] == 2


def test_refusals(tmp_cwd):
    from relayrl_tpu_torch.runtime.agent import Agent, VectorAgent
    from relayrl_tpu_torch.runtime.server import TrainingServer

    server_addrs, agent_addrs = _addrs()
    base = {"obs_dim": 4, "act_dim": 2, "env_dir": str(tmp_cwd),
            "device": "cpu", **server_addrs}
    # The reference's default config (guardrails on) constructs.
    default_path = os.path.join(str(tmp_cwd), "default.json")
    with open(default_path, "w") as f:
        json.dump({}, f)
    server = TrainingServer(config_path=default_path, start=False, **base)
    try:
        assert server.guardrails is not None
        assert server.guardrails.validation_mode == "enforce"
        assert server.algorithm._guard_probes is not None
        assert server.transport.check_ingest == server._check_ingest
    finally:
        server.disable_server()
    cases = [({"serving": {"enabled": True}}, {}, "item 9"),
             ({}, {"serving": True}, "item 9"),
             ({"telemetry": {"trace_sample_rate": 0.5}}, {}, "item 12"),
             ({"telemetry": {"fleet_interval_s": 1.0}}, {}, "item 12"),
             ({"learner": {"distributed": {"coordinator": "h:1",
                                           "num_processes": 2}}}, {},
              "item 11"),
             ({}, {"tensorboard": True}, "item 12"),
             ({}, {"server_type": "native"}, "item 4")]
    for sections, kwargs, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            TrainingServer(config_path=_config(tmp_cwd, **sections),
                           **base, **kwargs)
    config_path = _config(tmp_cwd)
    with pytest.raises(NotImplementedError, match="item 8"):
        VectorAgent(num_envs=2, config_path=config_path, host_mode="anakin",
                    device="cpu", start=False)
    if not __import__("torch").cuda.is_available():
        # Entry points run on the card unless the caller names the CPU.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TrainingServer(config_path=config_path,
                           **{k: v for k, v in base.items() if k != "device"})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Agent(config_path=config_path, probe=False, **agent_addrs)


def _jax_server(tmp, server_addrs, config_path):
    from relayrl_tpu.runtime.server import TrainingServer as JaxServer

    return JaxServer("REINFORCE", obs_dim=4, act_dim=2, env_dir=str(tmp),
                     config_path=config_path, hyperparams=dict(HP),
                     **server_addrs)


def test_port_agent_feeds_jax_server(tmp_cwd):
    from relayrl_tpu_torch.runtime.agent import Agent

    server_addrs, agent_addrs = _addrs()
    config_path = _config(tmp_cwd)
    server = _jax_server(tmp_cwd, server_addrs, config_path)
    try:
        server.wait_warmup(timeout=120)
        agent = Agent(config_path=config_path, seed=0, probe=False,
                      device="cpu", **agent_addrs)
        try:
            rng = np.random.default_rng(4)
            for target in (1, 2, 3):
                _drive(agent, rng, 2)
                _wait(lambda: agent.model_version == target == server.stats[
                    "updates"], f"the port agent to install version {target}")
            assert server.drain(timeout=30)
            version, _arch, host = server._bundle_host
            assert version == agent.model_version == 3
            assert tree_digest(params_to_jax(agent.actor.params)) == \
                tree_digest(host)
            dec = agent.actor._wire_decoder
            assert dec.keyframes_applied >= 1 and dec.deltas_applied >= 1
            row = server.ingest_accounting()["agents"][agent.transport.identity]
            assert row == {"max_seq": 6, "accepted": 6, "contiguous": True}
        finally:
            agent.disable_agent()
    finally:
        server.disable_server()


@pytest.mark.parametrize("wire", ["per_record", "columnar"])
def test_jax_agent_feeds_port_server(wire, tmp_cwd):
    from relayrl_tpu.runtime.agent import Agent as JaxAgent
    from relayrl_tpu.runtime.agent import VectorAgent as JaxVectorAgent

    server_addrs, agent_addrs = _addrs()
    config_path = _config(tmp_cwd)
    server = _port_server(tmp_cwd, server_addrs, config_path)
    try:
        if wire == "columnar":
            agent = JaxVectorAgent(
                num_envs=2, config_path=config_path, seed=0, probe=False,
                host_mode="anakin", jax_env="CartPole-v1", unroll_length=16,
                columnar_wire=True, identity="jaxcol", **agent_addrs)
            actor = agent.host

            def play():
                agent.rollout()
        else:
            agent = JaxAgent(config_path=config_path, seed=0, probe=False,
                             **agent_addrs)
            actor = agent.actor
            rng = np.random.default_rng(5)

            def play():
                _drive(agent, rng, 2)
        try:
            deadline = time.monotonic() + 120
            while (server.stats["updates"] < 3 and time.monotonic() < deadline):
                play()
                time.sleep(0.05)
            assert server.stats["updates"] >= 3
            version = server.stats["updates"]
            _wait(lambda: agent.model_version == server.latest_model_version
                  and server._learner_pending() == 0,
                  "the JAX agent to install the port's publish")
            got_version, digest = server.published_digest()
            assert agent.model_version == got_version >= version
            assert _jax_digest(actor.params) == digest
            dec = actor._wire_decoder
            assert dec.keyframes_applied >= 1 and dec.deltas_applied >= 1
            if wire == "columnar":
                frames = sum(
                    m["value"] for m in telemetry.get_registry().snapshot()[
                        "metrics"]
                    if m["name"] == "relayrl_server_columnar_frames_total")
                assert frames >= 6 or not telemetry.get_registry().enabled
            assert server.stats["learner_errors"] == 0
            assert server.stats["dropped"] == 0
        finally:
            agent.disable_agent()
    finally:
        server.disable_server()


def test_same_records_same_first_update(tmp_cwd):
    """Two fixed episodes, sent as the same bytes to a JAX server and to a
    port server that holds the JAX server's initial params."""
    from relayrl_tpu.transport import make_agent_transport as jax_agent_transport
    from relayrl_tpu.types.action import ActionRecord
    from relayrl_tpu.types.trajectory import serialize_actions
    from relayrl_tpu_torch.config import ConfigLoader
    from relayrl_tpu_torch.transport import make_agent_transport
    from relayrl_tpu_torch.weights import load_flat, params_from_jax

    config_path = _config(tmp_cwd)
    jax_addrs, jax_agent_addrs = _addrs()
    port_addrs, port_agent_addrs = _addrs()
    jax_server = _jax_server(tmp_cwd, jax_addrs, config_path)
    port_server = _port_server(tmp_cwd, port_addrs, config_path)
    try:
        jax_server.wait_warmup(timeout=120)
        load_flat(port_server.algorithm.state.params,
                  params_from_jax(jax.device_get(
                      jax_server.algorithm.state.params)))
        rng = np.random.default_rng(6)
        payloads = []
        for n in (7, 11):
            recs = [ActionRecord(
                obs=rng.standard_normal(4).astype(np.float32),
                act=np.array(int(rng.integers(2)), np.int32),
                rew=float(rng.standard_normal()),
                data={"logp_a": np.asarray(-0.69, np.float32),
                      "v": np.asarray(rng.standard_normal(), np.float32)})
                for _ in range(n)]
            recs.append(ActionRecord(rew=0.5, done=True))
            payloads.append(serialize_actions(recs))
        from relayrl_tpu.config import ConfigLoader as JaxConfigLoader

        sends = [
            (jax_agent_transport("zmq", JaxConfigLoader(None, config_path),
                                 probe=False, **jax_agent_addrs), jax_server),
            (make_agent_transport("zmq", ConfigLoader(None, config_path),
                                  probe=False, **port_agent_addrs),
             port_server)]
        for transport, server in sends:
            transport.fetch_model(30)  # the connection is up
            for i, payload in enumerate(payloads):
                transport.send_trajectory(payload, agent_id=f"fixed#s{i + 1}")
        for _, server in sends:
            _wait(lambda s=server: s.stats["updates"] == 1, "the first update")
            assert server.drain(timeout=30)
        want = {k: float(v) for k, v in jax_server.algorithm._last_metrics.items()}
        got = dict(port_server.algorithm._last_metrics)
        assert got.keys() == want.keys()
        for key in want:
            atol = F32_METRIC_ATOL if key == "AdvMean" else 0.0
            assert got[key] == pytest.approx(want[key], rel=F32_METRIC_RTOL,
                                             abs=atol), key
        mine = params_to_jax(port_server.algorithm.state.params)
        theirs = jax.device_get(jax_server.algorithm.state.params)
        from relayrl_tpu_torch.types.model_bundle import leaf_manifest

        (m1, l1), (m2, l2) = leaf_manifest(mine), leaf_manifest(theirs)
        assert m1 == m2
        for entry, a, b in zip(m1, l1, l2):
            np.testing.assert_allclose(a, b, atol=F32_PARAM_ATOL, rtol=0,
                                       err_msg=str(entry[0]))
        for transport, _ in sends:
            transport.close()
    finally:
        jax_server.disable_server()
        port_server.disable_server()


# -- the learner SIGKILL drill (tests/test_recovery.py:325-440) -------------

def _spawn_chaos(scratch: str, addrs: dict, resume: bool) -> subprocess.Popen:
    cfg = {"algorithm": "REINFORCE", "obs_dim": 6, "act_dim": 3,
           "hyperparams": {"traj_per_epoch": 4, "hidden_sizes": [16, 16],
                           "with_vf_baseline": False, "train_vf_iters": 3},
           "device": "cpu", "scratch": scratch, "checkpoint_every": 1,
           "resume": resume,
           "status_path": os.path.join(scratch, "status.json"), **addrs}
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "relayrl_tpu_torch.examples.chaos_server",
         json.dumps(cfg)],
        env=env, cwd=scratch, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _read_status(scratch: str, proc=None) -> dict | None:
    try:
        with open(os.path.join(scratch, "status.json")) as f:
            status = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if proc is not None and status.get("pid") != proc.pid:
        return None  # a killed predecessor's file
    return status


def _wait_status(scratch, proc, pred, timeout_s, what) -> dict:
    deadline = time.monotonic() + timeout_s
    status = None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            out, _ = proc.communicate()
            raise AssertionError(f"chaos server died waiting for {what} "
                                 f"(rc={proc.returncode}):\n{out[-3000:]}")
        status = _read_status(scratch, proc)
        if status is not None and pred(status):
            return status
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}; last={status}")


def _drive6(agent, rng, n: int, steps: int = 4) -> None:
    for _ in range(n):
        for _ in range(steps):
            agent.request_for_action(rng.standard_normal(6).astype(np.float32))
        agent.flag_last_action(1.0, terminated=True)


def test_learner_sigkill_resume_zero_loss_zero_dup(tmp_path, tmp_cwd):
    from relayrl_tpu_torch.runtime.agent import Agent

    scratch = str(tmp_path)
    server_addrs, agent_addrs = _addrs()
    config_path = _config(tmp_cwd)
    proc = _spawn_chaos(scratch, server_addrs, resume=False)
    agent = None
    try:
        _wait_status(scratch, proc, lambda s: True, 120, "server up")
        agent = Agent(config_path=config_path, handshake_timeout_s=60, seed=0,
                      probe=False, device="cpu", **agent_addrs)
        rng = np.random.default_rng(0)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            _drive6(agent, rng, 2)
            status = _read_status(scratch, proc)
            if (status and status["version"] >= 2
                    and status["accounting"]["agents"]):
                break
            time.sleep(0.1)
        status = _read_status(scratch, proc)
        assert status and status["version"] >= 2, "no training before kill"
        v_before = status["version"]
        agent_v_before = agent.model_version

        proc.kill()  # SIGKILL: no shutdown path runs
        proc.wait(timeout=30)
        _drive6(agent, rng, 8)
        sent_during_outage = agent.spool.sent_counts()[
            agent.transport.identity]

        proc = _spawn_chaos(scratch, server_addrs, resume=True)
        status = _wait_status(scratch, proc, lambda s: True, 120,
                              "server restart")
        assert status["resume"]["version"] >= 1
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            _drive6(agent, rng, 2)
            status = _read_status(scratch, proc)
            if (status and status["version"] > v_before
                    and agent.model_version > agent_v_before):
                break
            time.sleep(0.1)
        assert status["version"] > v_before, (
            f"server never trained past the crash: {status['version']} "
            f"<= {v_before}")
        assert agent.model_version > agent_v_before, (
            "actor never resynced to the post-crash model line")

        agent.spool.replay()
        ident = agent.transport.identity
        sent_total = agent.spool.sent_counts()[ident]
        assert sent_total >= sent_during_outage

        def recovered(s):
            row = s["accounting"]["agents"].get(ident)
            return (row is not None and row["max_seq"] == sent_total
                    and row["contiguous"])

        status = _wait_status(scratch, proc, recovered, 120,
                              "zero-loss accounting")
        row = status["accounting"]["agents"][ident]
        assert row["accepted"] == sent_total, (
            f"double-training or loss: {row} vs sent={sent_total}")
        assert status["accounting"]["duplicates"] >= 1
        assert status["stats"]["learner_errors"] == 0
        names = {m["name"] for m in status["telemetry"]["metrics"]}
        assert "relayrl_server_duplicate_trajectories_total" in names
    finally:
        if agent is not None:
            agent.disable_agent()
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
