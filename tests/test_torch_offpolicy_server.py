"""The off-policy family through the port's TrainingServer, on the CPU.

* The list branch: one ingest past warmup trains every batch
  ``accumulate`` returns (``train_on_batches``), staged first; the
  watchdog and the epoch log see the list's last update.
* The loop over ZMQ: a port ``VectorAgent`` of CartPole lanes feeds a port
  DQN server, more than one gradient update per ingest; the agent installs
  every publish bit for bit, the annealed epsilon with it.
* Interop both ways, params byte-equal across: a port ``VectorAgent``
  feeds a JAX DQN server, and a JAX ``Agent`` installs a port DQN server's
  publishes.

Models are 16x16 Q-nets at batch 8, so an update takes a millisecond.
"""

import json
import os
import time

import jax
import numpy as np
import pytest

from relayrl_tpu import faults as jax_faults
from relayrl_tpu import telemetry as jax_telemetry
from relayrl_tpu_torch import faults, telemetry
from relayrl_tpu_torch.weights import params_to_jax, tree_digest
from tests._util import free_port

HP = {"hidden_sizes": [16, 16], "batch_size": 8, "update_after": 20,
      "buffer_size": 2000, "max_updates_per_ingest": 3, "traj_per_epoch": 2,
      "epsilon_decay_steps": 200, "seed_salt": 0}
CONFIG = {"guardrails": {"enabled": False},
          "transport": {"small_model_bytes": 0, "keyframe_interval": 3}}


@pytest.fixture(autouse=True)
def _clean_planes():
    for mod in (faults, telemetry, jax_faults, jax_telemetry):
        mod.reset_for_tests()
    yield
    for mod in (faults, telemetry, jax_faults, jax_telemetry):
        mod.reset_for_tests()


def _config(tmp, **sections) -> str:
    path = os.path.join(str(tmp), "offpolicy_config.json")
    with open(path, "w") as f:
        json.dump({**CONFIG, **sections}, f)
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


def _wait(pred, what, timeout_s=60.0, poll=None):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        if poll is not None:
            poll()
        else:
            time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _episode(n, seed):
    from relayrl_tpu_torch.types.action import ActionRecord

    rng = np.random.default_rng(seed)
    return [ActionRecord(obs=rng.standard_normal(4).astype(np.float32),
                         act=np.int32(rng.integers(2)), rew=1.0, done=(i == n - 1))
            for i in range(n)]


def test_server_trains_the_list_per_ingest(tmp_cwd):
    """``_process_one`` on a DQN server: each ingest past warmup trains
    ``max_updates_per_ingest`` updates through ``train_on_batches``, every
    batch staged first, as one publish; the watchdog's queue and the
    epoch log hold the last update's metrics."""
    from relayrl_tpu_torch.runtime.server import TrainingServer

    server_addrs, _ = _addrs()
    config_path = _config(tmp_cwd, guardrails={"enabled": True})
    server = TrainingServer("DQN", obs_dim=4, act_dim=2, env_dir=str(tmp_cwd),
                            config_path=config_path, hyperparams=dict(HP),
                            device="cpu", start=False, **server_addrs)
    try:
        algo = server.algorithm
        staged, lists, updates, logged = [], [], [], []
        stage, train, update, log = (algo.stage_batch, algo.train_on_batches,
                                     algo._update, algo.log_epoch)
        algo.stage_batch = lambda b: (staged.append(b), stage(b))[1]
        algo.train_on_batches = lambda bs: (lists.append(len(bs)), train(bs))[1]

        def spy_update(state, batch, noise):
            state, metrics = update(state, batch, noise)
            updates.append({k: float(v) for k, v in metrics.items()})
            return state, metrics

        algo._update = spy_update
        algo.log_epoch = lambda stats=None, metrics=None: (
            logged.append(dict(metrics)), log(stats=stats, metrics=metrics))[1]
        watchdog = server.guardrails.watchdog
        server._process_one(_episode(15, 0))  # warmup: stored, no update
        assert server.stats["updates"] == 0 and algo.version == 0
        for i in range(1, 4):
            server._process_one(_episode(15, i))
            assert server.stats["updates"] == i
            assert algo.version == 3 * i and lists == [3] * i
            assert len(staged) == 3 * i
            _, observed = watchdog._pending[-1]
            assert observed is algo._last_metrics
            assert {k: observed[k] for k in updates[-1]} == updates[-1]
            assert "GuardParamNorm" in observed  # the probes ride along
        server._pipeline_quiesce()  # fence the window: the deferred logs dump
        assert len(logged) == 2
        assert {k: logged[-1][k] for k in updates[-1]} == updates[-1]
        assert server.stats["learner_errors"] == 0
    finally:
        server.disable_server()


def _cartpole_venv(n):
    from relayrl_tpu_torch.envs import SyncVectorEnv, make

    return SyncVectorEnv([lambda: make("CartPole-v1")] * n)


def test_vector_agent_trains_port_dqn_server(tmp_cwd):
    from relayrl_tpu_torch.runtime.agent import VectorAgent
    from relayrl_tpu_torch.runtime.server import TrainingServer
    from relayrl_tpu_torch.runtime.vector_actor import run_vector_gym_loop

    server_addrs, agent_addrs = _addrs()
    config_path = _config(tmp_cwd)
    server = TrainingServer("DQN", obs_dim=4, act_dim=2, env_dir=str(tmp_cwd),
                            config_path=config_path, hyperparams=dict(HP),
                            device="cpu", **server_addrs)
    try:
        agent = VectorAgent(num_envs=2, config_path=config_path, seed=0,
                            probe=False, device="cpu", **agent_addrs)
        venv = _cartpole_venv(2)
        try:
            wave = iter(range(1000))
            _wait(lambda: server.stats["updates"] >= 4
                  and server.algorithm.version > server.stats["updates"],
                  "four ingests that trained", 90,
                  poll=lambda: run_vector_gym_loop(agent.host, venv, 40,
                                                   seed=next(wave)))
            assert server.drain(timeout=30)
            _wait(lambda: agent.model_version == server.latest_model_version,
                  "the agent to install the last publish")
            version, digest = server.published_digest()
            assert agent.model_version == version == server.algorithm.version
            assert tree_digest(params_to_jax(agent.host.params)) == digest
            assert agent.host.arch["epsilon"] == pytest.approx(
                server.algorithm.current_epsilon())
            assert agent.host.arch["epsilon"] < 1.0
            assert server.stats["learner_errors"] == 0
            acct = server.ingest_accounting()["agents"]
            for aid, sent in agent.spool.sent_counts().items():
                assert acct[aid] == {"max_seq": sent, "accepted": sent,
                                     "contiguous": True}
        finally:
            agent.disable_agent()
    finally:
        server.disable_server()


def test_port_vector_agent_feeds_jax_dqn_server(tmp_cwd):
    from relayrl_tpu.runtime.server import TrainingServer as JaxServer
    from relayrl_tpu_torch.runtime.agent import VectorAgent
    from relayrl_tpu_torch.runtime.vector_actor import run_vector_gym_loop

    server_addrs, agent_addrs = _addrs()
    config_path = _config(tmp_cwd)
    server = JaxServer("DQN", obs_dim=4, act_dim=2, env_dir=str(tmp_cwd),
                       config_path=config_path, hyperparams=dict(HP),
                       **server_addrs)
    try:
        server.wait_warmup(timeout=120)
        agent = VectorAgent(num_envs=2, config_path=config_path, seed=0,
                            probe=False, device="cpu", **agent_addrs)
        venv = _cartpole_venv(2)
        try:
            wave = iter(range(1000))
            _wait(lambda: server.stats["updates"] >= 3, "three JAX ingests that trained",
                  120, poll=lambda: run_vector_gym_loop(agent.host, venv, 40,
                                                        seed=next(wave)))
            assert server.drain(timeout=30)
            _wait(lambda: agent.model_version == server._bundle_host[0],
                  "the port agent to install the JAX publish")
            version, arch, host = server._bundle_host
            assert agent.model_version == version and version > server.stats["updates"]
            assert tree_digest(params_to_jax(agent.host.params)) == tree_digest(host)
            assert agent.host.arch == dict(arch)
        finally:
            agent.disable_agent()
    finally:
        server.disable_server()


def test_jax_agent_installs_port_dqn_server_publish(tmp_cwd):
    from relayrl_tpu.runtime.agent import Agent as JaxAgent
    from relayrl_tpu_torch.runtime.server import TrainingServer

    server_addrs, agent_addrs = _addrs()
    config_path = _config(tmp_cwd)
    server = TrainingServer("DQN", obs_dim=4, act_dim=2, env_dir=str(tmp_cwd),
                            config_path=config_path, hyperparams=dict(HP),
                            device="cpu", **server_addrs)
    try:
        agent = JaxAgent(config_path=config_path, seed=0, probe=False, **agent_addrs)
        rng = np.random.default_rng(5)

        def play():
            for _ in range(12):
                agent.request_for_action(rng.standard_normal(4).astype(np.float32))
            agent.flag_last_action(1.0, terminated=True)

        try:
            _wait(lambda: server.stats["updates"] >= 3, "three port ingests that trained",
                  90, poll=play)
            assert server.drain(timeout=30)
            _wait(lambda: agent.model_version == server.latest_model_version,
                  "the JAX agent to install the port's publish")
            version, digest = server.published_digest()
            assert agent.model_version == version > server.stats["updates"]
            assert tree_digest(jax.device_get(agent.actor.params)) == digest
            assert agent.actor.arch["kind"] == "qnet_discrete"
            assert agent.actor.arch["epsilon"] == pytest.approx(
                server.algorithm.current_epsilon())
            assert server.stats["learner_errors"] == 0
        finally:
            agent.disable_agent()
    finally:
        server.disable_server()
