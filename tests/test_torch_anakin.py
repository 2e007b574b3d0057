"""The port's Anakin tier (``relayrl_tpu_torch/runtime/anakin.py``) on the
CPU, where the window runs uncaptured (the CUDA graph is the card's:
``chip_smoke.py`` phase 17 holds it to this eager window).

- ``window_advance`` against the JAX package's, row for row;
- the unstacker against the JAX host's, byte for byte: windows a JAX
  ``AnakinActorHost`` produced go through both hosts' emit paths (per
  record and columnar, coalesced, on the emitter thread, ``record_bver``);
- the fused tier against the port's vector tier, byte for byte: a
  ``VectorActorHost`` stepping the same device env through
  ``run_vector_gym_loop`` from the same generators, MLP and windowed
  transformer, across terminations and time-limit truncations;
- the swap gates, the refusals and the config knobs;
- over ZMQ, a port anakin ``VectorAgent`` feeding a port server and a JAX
  server.

About 40 s on the CPU.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu import telemetry as jax_telemetry
from relayrl_tpu_torch import telemetry
from relayrl_tpu_torch.types.model_bundle import ModelBundle
from relayrl_tpu_torch.weights import params_to_jax
from tests._util import free_port

MLP = {"kind": "mlp_discrete", "obs_dim": 4, "act_dim": 2, "hidden_sizes": [16]}
SEQ = {"kind": "transformer_discrete", "obs_dim": 4, "act_dim": 2, "d_model": 16,
       "n_layers": 1, "n_heads": 2, "max_seq_len": 8}


@pytest.fixture(autouse=True)
def _clean_planes():
    for mod in (telemetry, jax_telemetry):
        mod.reset_for_tests()
    yield
    for mod in (telemetry, jax_telemetry):
        mod.reset_for_tests()


def _bundle(arch=MLP, seed=0, version=0) -> ModelBundle:
    from relayrl_tpu_torch.models import build_policy

    params = build_policy(arch, "cpu").init_params(torch.Generator().manual_seed(seed))
    return ModelBundle(version=version, arch=dict(arch), params=params_to_jax(params))


def _host(arch=MLP, env="CartPole-v1", **kw):
    from relayrl_tpu_torch.runtime.anakin import AnakinActorHost

    kw.setdefault("num_envs", 2)
    kw.setdefault("unroll_length", 8)
    return AnakinActorHost(_bundle(arch, version=kw.pop("version", 0)), env,
                           device="cpu", **kw)


def test_window_advance_matches_jax():
    """The batched twin of ``push_window`` equals the JAX package's
    ``window_advance`` (vmapped) row for row, through fill, roll and
    per-lane resets."""
    from relayrl_tpu.runtime.policy_actor import window_advance as jax_advance
    from relayrl_tpu_torch.runtime.policy_actor import push_window, window_advance

    rng = np.random.default_rng(0)
    n, cap, d = 5, 4, 3
    win, wlen = torch.zeros((n, cap, d)), torch.zeros(n, dtype=torch.int32)
    jwin, jlen = jnp.zeros((n, cap, d), jnp.float32), jnp.zeros(n, jnp.int32)
    host = np.zeros((n, cap, d), np.float32)
    host_len = [0] * n
    adv = jax.jit(jax.vmap(jax_advance))
    for step in range(13):
        obs = rng.standard_normal((n, d)).astype(np.float32)
        win, wlen = window_advance(win, wlen, torch.as_tensor(obs))
        jwin, jlen = adv(jwin, jlen, jnp.asarray(obs))
        for lane in range(n):
            host_len[lane], _ = push_window(host[lane], host_len[lane], obs[lane])
        np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
        np.testing.assert_array_equal(win.numpy(), host)
        assert wlen.tolist() == np.asarray(jlen).tolist() == host_len
        if step == 6:  # lanes 1 and 3 start a new episode
            for lane in (1, 3):
                win[lane], wlen[lane], host[lane], host_len[lane] = 0.0, 0, 0.0, 0
                jwin, jlen = jwin.at[lane].set(0.0), jlen.at[lane].set(0)


# -- the unstacker against the JAX host --------------------------------------

UNSTACK_CASES = {
    "records": {"columnar_wire": False},
    "records_async_bver": {"columnar_wire": False, "async_emit": True, "record_bver": True},
    "columnar": {"columnar_wire": True},
    "columnar_coalesce3_async_bver": {"columnar_wire": True, "emit_coalesce_frames": 3,
                                      "async_emit": True, "record_bver": True},
}


@pytest.mark.parametrize("case", sorted(UNSTACK_CASES))
def test_unstacker_bytes_equal_jax_host(case, tmp_cwd):
    """Windows from a JAX host (CartPole cut at 12 steps: terminations and
    time-limit truncations, the bootstrap obs) go through the JAX host's
    emit path and the port host's: every payload, per lane and in order,
    and ``episode_returns`` are equal."""
    from relayrl_tpu.envs.jax import JaxCartPole
    from relayrl_tpu.models import build_policy as jax_build_policy
    from relayrl_tpu.runtime.anakin import AnakinActorHost as JaxHost
    from relayrl_tpu.types.model_bundle import ModelBundle as JaxBundle
    from relayrl_tpu_torch.envs.device import DeviceCartPole

    flags = UNSTACK_CASES[case]
    n, unroll, windows = 3, 40, 2
    jax_sent = {lane: [] for lane in range(n)}
    port_sent = {lane: [] for lane in range(n)}
    jparams = jax_build_policy(MLP).init_params(jax.random.PRNGKey(0))
    jhost = JaxHost(JaxBundle(version=5, arch=dict(MLP), params=jparams),
                    JaxCartPole(max_steps=12), num_envs=n, unroll_length=unroll,
                    max_traj_length=16,
                    on_send=lambda lane, p: jax_sent[lane].append(p), seed=1, **flags)
    produced = []
    rollout_fn = jhost._rollout_fn

    def spy(*args):
        carry, window = rollout_fn(*args)
        produced.append(jax.device_get(window))
        return carry, window

    jhost._rollout_fn = spy
    for _ in range(windows):
        jhost.rollout()
    jhost.flush_emits()
    port = _host(MLP, DeviceCartPole(max_steps=12, device="cpu"), num_envs=n,
                 unroll_length=unroll, max_traj_length=16, version=5,
                 on_send=lambda lane, p: port_sent[lane].append(p), **flags)
    for window in produced:
        port._emit({k: (dict(v) if k == "aux" else np.asarray(v))
                    for k, v in window.items()}, 5)
    port.flush_emits()
    port.close()
    jhost.close()
    kinds = [bool(w["term"].any()) for w in produced] + [
        bool((w["trunc"] & ~w["term"]).any()) for w in produced]
    assert any(kinds[:windows]) and any(kinds[windows:]), "both episode ends"
    assert port_sent == jax_sent
    assert sum(map(len, port_sent.values())) >= n
    assert port.episode_returns == jhost.episode_returns


# -- the fused tier against the port's vector tier ---------------------------

class _VectorTwin:
    """Gym-like vector facade over the same device-env stream the fused
    host runs: the env generator seeded alike, the same initial reset and
    the same ``step_autoreset`` per step, so a vector host driven through
    ``run_vector_gym_loop`` sees the fused window's exact steps."""

    def __init__(self, env, num_envs: int, seed: int):
        from relayrl_tpu_torch.runtime.anakin import env_seed

        self.env, self.num_envs = env, num_envs
        self._gen = torch.Generator().manual_seed(env_seed(seed))
        self._state = None

    def reset(self, seed=None):
        self._state, obs = self.env.reset(self._gen, self.num_envs)
        return obs.numpy(), [{} for _ in range(self.num_envs)]

    def step(self, actions):
        from relayrl_tpu_torch.envs.device import step_autoreset

        act = torch.as_tensor(np.asarray(actions, np.int32))
        self._state, obs, rew, term, trunc, final = step_autoreset(
            self.env, self._state, act, self._gen)
        term, trunc = term.numpy(), trunc.numpy()
        infos = [({"final_observation": final[i].numpy()} if term[i] or trunc[i] else {})
                 for i in range(self.num_envs)]
        return obs.numpy(), rew.numpy(), term, trunc, infos


@pytest.mark.parametrize("arch", [MLP, SEQ], ids=["mlp", "transformer"])
def test_fused_bytes_equal_vector_tier(arch, tmp_cwd):
    """Per-record payloads of the fused window equal a port vector host's
    on the same steps, byte for byte, lane for lane, across autoresets (the
    transformer's window empties at each) and both ending kinds; columnar
    frames of the same window carry the same steps."""
    from relayrl_tpu_torch.envs.device import DeviceCartPole
    from relayrl_tpu_torch.runtime.vector_actor import VectorActorHost, run_vector_gym_loop
    from relayrl_tpu_torch.types.columnar import parse_frame
    from relayrl_tpu_torch.types.trajectory import deserialize_actions

    n, unroll, seed = 2, 120, 3
    env = DeviceCartPole(max_steps=18, device="cpu")
    fused = {lane: [] for lane in range(n)}
    _host(arch, env, num_envs=n, unroll_length=unroll, seed=seed, columnar_wire=False,
          on_send=lambda lane, p: fused[lane].append(p)).rollout()
    vector = {lane: [] for lane in range(n)}
    vhost = VectorActorHost(_bundle(arch), num_envs=n, seed=seed, device="cpu",
                            on_send=lambda lane, p: vector[lane].append(p))
    run_vector_gym_loop(vhost, _VectorTwin(env, n, seed), steps=unroll)
    markers = []
    for lane in range(n):
        assert len(fused[lane]) >= 2, "need autoreset boundaries"
        assert fused[lane] == vector[lane], f"lane {lane}"
        markers += [deserialize_actions(p)[-1] for p in fused[lane]]
    assert any(m.truncated for m in markers) and any(not m.truncated for m in markers)
    frames = {lane: [] for lane in range(n)}
    _host(arch, env, num_envs=n, unroll_length=unroll, seed=seed, columnar_wire=True,
          on_send=lambda lane, p: frames[lane].append(p)).rollout()
    for lane in range(n):
        assert len(frames[lane]) == len(vector[lane])
        for frame, payload in zip(frames[lane], vector[lane]):
            dt, records = parse_frame(frame, agent_id="x"), deserialize_actions(payload)
            steps, marker = records[:-1], records[-1]
            assert dt.n_steps == len(steps) and dt.n_records == len(records)
            assert dt.marker_truncated == marker.truncated
            np.testing.assert_array_equal(dt.columns["o"], np.stack([r.obs for r in steps]))
            np.testing.assert_array_equal(dt.columns["a"], np.stack([r.act for r in steps]))
            np.testing.assert_array_equal(dt.aux["logp_a"],
                                          np.stack([r.data["logp_a"] for r in steps]))
            assert dt.columns["r"][-1] == marker.rew
            if marker.truncated:
                np.testing.assert_array_equal(dt.final_obs, marker.obs)


def test_generators_advance_and_stay_apart(tmp_cwd):
    """Consecutive windows draw fresh actions and resets (both generators
    advance), the policy and env streams differ, and the same seed gives
    the same windows."""
    from relayrl_tpu_torch.runtime.anakin import env_seed

    assert env_seed(0) != 0 and env_seed(1) != env_seed(0)
    a, b = _host(seed=7, num_envs=4, unroll_length=16), _host(seed=7, num_envs=4,
                                                               unroll_length=16)
    windows = []
    for host in (a, b):
        for _ in range(2):
            host.produce()
            windows.append(host.window_to_host())
    first, second, again = windows[0], windows[1], windows[2]
    assert not np.array_equal(first["act"], second["act"])
    assert not np.array_equal(first["obs"], second["obs"])
    for key in ("obs", "act", "rew", "final_obs"):
        np.testing.assert_array_equal(first[key], again[key])
    # final_obs equals the next obs wherever a lane did not end.
    going = ~(first["term"] | first["trunc"])[:, :-1]
    np.testing.assert_array_equal(first["final_obs"][:, :-1][going],
                                  first["obs"][:, 1:][going])


def test_run_anakin_loop_returns_per_lane(tmp_cwd):
    """``run_anakin_loop`` drives whole windows and hands back each lane's
    completed returns (drained from the emitter thread first), which add
    up to the rewards of the episodes that ended."""
    from relayrl_tpu_torch.runtime.anakin import run_anakin_loop

    host = _host(num_envs=3, unroll_length=30, async_emit=True)
    returns = run_anakin_loop(host, windows=2)
    host.close()
    assert len(returns) == 3 and all(returns)
    assert returns == host.episode_returns
    assert all(r == int(r) and 1 <= r <= 60 for lane in returns for r in lane)


# -- swap gates, refusals, config knobs ---------------------------------------

def test_swap_gates(tmp_cwd):
    """Stale and arch-changing bundles are refused; a newer one is copied
    into the module the window reads (its tensors stay in place, as a
    captured graph needs), and ``swap_from_bytes`` installs a bundle."""
    host = _host(version=3)
    live = host._live
    weight = next(live.parameters())
    host.rollout()
    assert not host.maybe_swap(_bundle(version=3))
    newer = _bundle(seed=9, version=7)
    assert host.maybe_swap(newer) and host.version == 7
    host.rollout()
    assert host._live is live and next(live.parameters()) is weight
    assert json.dumps(params_to_jax(live), default=lambda a: a.tolist()) == \
        json.dumps(newer.params, default=lambda a: np.asarray(a).tolist())
    with pytest.raises(ValueError, match="arch"):
        host.maybe_swap(_bundle({**MLP, "act_dim": 3}, version=9))
    assert host.swap_from_bytes(_bundle(seed=4, version=11).to_bytes())
    assert host.version == 11


def test_refusals_and_window_size(tmp_cwd, monkeypatch):
    import dataclasses

    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.runtime import anakin as anakin_mod

    with pytest.raises(ValueError, match="obs_dim"):
        _host({**MLP, "obs_dim": 6})
    with pytest.raises(ValueError, match="num_envs"):
        _host(num_envs=0)
    with pytest.raises(ValueError, match="unroll_length"):
        _host(unroll_length=0)
    with pytest.raises(ValueError, match="unknown device env"):
        _host(env="Pong-v5")
    assert _host(SEQ, window_size=512)._window_size == 8
    assert _host(SEQ, window_size=0)._window_size == 1
    assert _host(SEQ, window_size=3)._carry["win"].shape == (2, 3, 4)

    def cache_only(arch, device=None):
        return dataclasses.replace(build_policy(arch, device), step_window=None,
                                   mode_window=None)

    monkeypatch.setattr(anakin_mod, "build_policy", cache_only)
    with pytest.raises(ValueError, match="KV-cache"):
        _host(SEQ, validate=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            anakin_mod.AnakinActorHost(_bundle(), "CartPole-v1", num_envs=1)


def test_config_knobs(tmp_path):
    """``VectorAgent`` reads the anakin keys from the actor section, and
    ``columnar_wire: "auto"`` resolves to columnar frames on the anakin tier
    only."""
    from relayrl_tpu_torch.runtime.agent import VectorAgent

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"actor": {
        "host_mode": "anakin", "num_envs": 8, "unroll_length": 128,
        "jax_env": "Pendulum-v1", "async_emit": True, "emit_coalesce_frames": 2,
        "window_size": 12}}))
    agent = VectorAgent(config_path=str(path), device="cpu", start=False)
    assert (agent.host_mode, agent.num_envs, agent.unroll_length, agent.jax_env) == \
        ("anakin", 8, 128, "Pendulum-v1")
    assert agent.columnar_wire and agent.async_emit
    assert (agent.emit_coalesce_frames, agent.window_size) == (2, 12)
    vector = VectorAgent(config_path=str(path), device="cpu", start=False,
                         host_mode="vector")
    assert vector.host_mode == "vector" and not vector.columnar_wire
    forced = VectorAgent(config_path=str(path), device="cpu", start=False,
                         columnar_wire=False, unroll_length=4)
    assert not forced.columnar_wire and forced.unroll_length == 4


# -- over ZMQ -------------------------------------------------------------------

HP = {"traj_per_epoch": 2, "hidden_sizes": [16, 16], "train_vf_iters": 3,
      "with_vf_baseline": True, "bucket_lengths": [16], "seed_salt": 0}
CONFIG = {"guardrails": {"enabled": False},
          "transport": {"small_model_bytes": 0, "keyframe_interval": 3}}


def _addrs():
    ports = [free_port() for _ in range(3)]
    server = {"agent_listener_addr": f"tcp://127.0.0.1:{ports[0]}",
              "trajectory_addr": f"tcp://127.0.0.1:{ports[1]}",
              "model_pub_addr": f"tcp://127.0.0.1:{ports[2]}"}
    agent = {"agent_listener_addr": server["agent_listener_addr"],
             "trajectory_addr": server["trajectory_addr"],
             "model_sub_addr": server["model_pub_addr"]}
    return server, agent


@pytest.mark.parametrize("side", ["port", "jax"])
def test_anakin_agent_feeds_server(side, tmp_cwd):
    """A port anakin ``VectorAgent`` (CartPole cut at 12 steps, 2 lanes,
    columnar frames, ``record_bver``) trains a port server and a JAX server
    over ZMQ: every lane registers and streams contiguously, the server
    decodes columnar frames, and the agent installs the publish bit for
    bit; the per-step surface is refused on this tier."""
    from relayrl_tpu_torch.runtime.agent import VectorAgent
    from relayrl_tpu_torch.weights import tree_digest

    server_addrs, agent_addrs = _addrs()
    config_path = os.path.join(str(tmp_cwd), "cfg.json")
    with open(config_path, "w") as f:
        json.dump(CONFIG, f)
    if side == "port":
        from relayrl_tpu_torch.runtime.server import TrainingServer

        server = TrainingServer("REINFORCE", obs_dim=4, act_dim=2, env_dir=str(tmp_cwd),
                                config_path=config_path, hyperparams=dict(HP),
                                device="cpu", **server_addrs)
        registry = telemetry.get_registry()
        published = server.published_digest
    else:
        from relayrl_tpu.runtime.server import TrainingServer

        server = TrainingServer("REINFORCE", obs_dim=4, act_dim=2, env_dir=str(tmp_cwd),
                                config_path=config_path, hyperparams=dict(HP),
                                **server_addrs)
        registry = jax_telemetry.get_registry()
        server.wait_warmup(timeout=120)

        def published():
            version, _arch, host = server._bundle_host
            return version, tree_digest(host)
    try:
        agent = VectorAgent(num_envs=2, config_path=config_path, seed=0, device="cpu",
                            host_mode="anakin", jax_env="CartPole-v1",
                            jax_env_kwargs={"max_steps": 12}, unroll_length=16,
                            record_bver=True, identity=f"anakin-{side}", **agent_addrs)
        try:
            assert agent.columnar_wire and agent.host.graph is None
            deadline = time.monotonic() + 120
            while server.stats["updates"] < 3 and time.monotonic() < deadline:
                agent.rollout()
                time.sleep(0.05)
            assert server.stats["updates"] >= 3
            assert server.drain(timeout=30)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and agent.model_version != published()[0]:
                time.sleep(0.05)
            version, digest = published()
            assert agent.model_version == version >= 3
            assert tree_digest(params_to_jax(agent.host.params)) == digest
            rows = {aid: row for aid, row in server.ingest_accounting()["agents"].items()
                    if aid.startswith(f"anakin-{side}.lane")}
            assert len(rows) == 2
            assert all(row["accepted"] >= 1 and row["contiguous"] for row in rows.values())
            frames = sum(m["value"] for m in registry.snapshot()["metrics"]
                         if m["name"] == "relayrl_server_columnar_frames_total")
            assert frames >= 2 or not registry.enabled
            assert server.stats.get("learner_errors", 0) == 0
            with pytest.raises(RuntimeError, match="rollout"):
                agent.request_for_actions(np.zeros((2, 4), np.float32))
            with pytest.raises(RuntimeError, match="autoreset"):
                agent.flag_last_action(0, 1.0)
        finally:
            agent.disable_agent()
    finally:
        server.disable_server()
