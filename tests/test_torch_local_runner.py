"""The local loop on the CPU: the port's LocalRunner, agent helpers,
ApplicationAbstract and example twins, against the JAX package's types.

* Two updates of ``mlp_discrete`` on CartPole: every episode crosses the
  wire codec, and its bytes decode with the JAX package's
  ``deserialize_actions`` and re-encode to the same bytes; the learner,
  the actor and the runner advance one version per update; the bundle
  loads into the JAX package and its policy gives the port's values.
* ``evaluate`` records nothing: no bytes, no buffered steps, no update.
* The time-limit rule: an episode cut by ``max_steps`` ships a truncated
  marker with the post-step observation, a terminal one does not.
* ``mlp_continuous`` on Pendulum: float32 actions on the wire.
* The recall_transformer golden's flash transformer for one update.
* The example twins and the recall seed sweep run end to end with
  ``--device cpu``.

Sizes: hidden (16, 16), 2 episodes per update, 2 value iterations.
"""

import re

import jax
import numpy as np
import pytest
import torch

from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu.runtime.agent import coerce_env_action as jax_coerce_env_action
from relayrl_tpu.types.model_bundle import ModelBundle as JaxModelBundle
from relayrl_tpu.types.trajectory import deserialize_actions as jax_deserialize
from relayrl_tpu.types.trajectory import serialize_actions as jax_serialize
from relayrl_tpu_torch.envs import Box, Discrete, RecallEnv, make
from relayrl_tpu_torch.examples import recall_seeds, train_local, train_memory
from relayrl_tpu_torch.runtime import ApplicationAbstract, LocalRunner, reward_threshold_reached
from relayrl_tpu_torch.runtime.agent import coerce_env_action
from relayrl_tpu_torch.types import deserialize_actions, serialize_actions

HP = {"traj_per_epoch": 2, "train_vf_iters": 2, "hidden_sizes": [16, 16]}
# f32, the same arithmetic in another order (tests/test_torch_mlp.py).
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this module from crowding the other test workers' CPUs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _runner(tmp_path, env, **hp):
    return LocalRunner(env, "REINFORCE", config_path=str(tmp_path / "absent.json"),
                       env_dir=str(tmp_path), seed=0, device="cpu", **{**HP, **hp})


def _record_sends(runner) -> list[bytes]:
    """Every payload the runner's actor ships, in order."""
    sent, hook = [], runner.actor.trajectory._on_send
    runner.actor.trajectory._on_send = lambda buf: (sent.append(buf), hook(buf))
    return sent


def test_two_updates_cross_the_wire_and_advance_versions(tmp_path):
    runner = _runner(tmp_path, make("CartPole-v1"), with_vf_baseline=True)
    sent = _record_sends(runner)
    result = runner.train(epochs=2)
    assert result["updates"] == runner.updates == 2
    assert runner.algorithm.version == runner.actor.version == 2
    assert result["episodes"] == len(sent) == len(result["returns"]) == 4
    assert result["avg_return_last_window"] == np.mean(result["returns"])
    for buf in sent:
        records = deserialize_actions(buf)
        assert jax_serialize(jax_deserialize(buf)) == buf == serialize_actions(records)
        assert records[-1].done and all(np.asarray(r.act).dtype == np.int32
                                        for r in records[:-1])
        # CartPole pays 1 per step: the episode's return is its length.
        assert sum(r.rew for r in records) == len(records) - 1

    bundle = JaxModelBundle.from_bytes(runner.algorithm.bundle().to_bytes(),
                                       params_template=JaxModelBundle.RAW_TREE)
    assert bundle.version == 2 and bundle.arch["kind"] == "mlp_discrete"
    obs = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    act = np.array([0, 1, 1], np.int32)
    want = jax_build_policy(bundle.arch).evaluate(bundle.params, obs, act)
    with torch.no_grad():
        got = runner.algorithm.policy.evaluate(runner.algorithm.state.params, obs, act)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


def test_evaluate_records_nothing(tmp_path):
    runner = _runner(tmp_path, make("CartPole-v1"))
    runner.train(epochs=1)
    sent = _record_sends(runner)
    buffered = len(runner.algorithm.buffer)
    out = runner.evaluate(episodes=2, max_steps=50)
    assert out["episodes"] == 2 and len(out["returns"]) == 2
    assert out["avg_return"] == np.mean(out["returns"])
    assert sent == [] and runner.actor.trajectory.get_actions() == []
    assert runner.updates == runner.algorithm.version == 1
    assert len(runner.algorithm.buffer) == buffered
    runner.actor.request_for_action(np.zeros(4, np.float32))
    with pytest.raises(RuntimeError, match="mid-episode"):
        runner.evaluate(episodes=1)


class _TwoStepEnv:
    """Terminates after two steps; observation [t, 0, 0, 0]."""

    observation_space = Box(-1.0, 1.0, (4,))
    action_space = Discrete(2)

    def reset(self, seed=None):
        self.t = 0
        return np.zeros(4, np.float32), {}

    def step(self, act):
        self.t += 1
        obs = np.array([self.t, 0, 0, 0], np.float32)
        return obs, 1.0, self.t >= 2, False, {}


@pytest.mark.parametrize("env,max_steps,truncated", [
    (_TwoStepEnv(), 1000, False), (make("CartPole-v1"), 3, True)])
def test_time_limit_ships_the_post_step_observation(tmp_path, env, max_steps, truncated):
    runner = _runner(tmp_path, env)
    sent = _record_sends(runner)
    ep_ret, ep_len = runner.run_episode(max_steps=max_steps)
    (buf,) = sent
    marker = deserialize_actions(buf)[-1]
    assert marker.done and marker.truncated == truncated
    assert ep_len == (3 if truncated else 2) and ep_ret == ep_len
    assert (marker.obs is not None) == truncated


def test_continuous_policy_ships_float_actions(tmp_path):
    runner = _runner(tmp_path, make("Pendulum-v1"), discrete=False, with_vf_baseline=True)
    assert runner.algorithm.arch["kind"] == "mlp_continuous"
    sent = _record_sends(runner)
    runner.train(epochs=1)
    records = jax_deserialize(sent[0])
    for rec in records[:-1]:
        act = np.asarray(rec.act)
        assert act.dtype == np.float32 and act.shape == (1,)
    greedy = runner.actor.deterministic_action(np.zeros(3, np.float32))
    assert greedy.dtype == np.float32 and greedy.shape == (1,)


def test_flash_transformer_trains_through_the_loop(tmp_path):
    """The recall_transformer golden's arch (flash attention, plain
    versions on the CPU) for one update of two episodes."""
    runner = _runner(tmp_path, RecallEnv(horizon=4), model_kind="transformer_discrete",
                     d_model=32, n_layers=1, n_heads=2, max_seq_len=8, attention="flash",
                     attention_block=8, bucket_lengths=(8,), gamma=1.0, lam=0.95,
                     with_vf_baseline=True)
    result = runner.train(epochs=1)
    assert runner.updates == runner.actor.version == 1 and result["episodes"] == 2


@pytest.mark.parametrize("act", [np.int32(1), np.float32(0.5), np.array([0.5, -1.0], np.float32)])
def test_coerce_env_action_matches_jax(act):
    got, want = coerce_env_action(act), jax_coerce_env_action(act)
    assert type(got) is type(want) and np.array_equal(got, want)


def test_reward_threshold_reached():
    assert reward_threshold_reached({"avg_return_last_window": 475.0}, 475.0)
    assert not reward_threshold_reached({"avg_return_last_window": 474.9}, 475.0)


class _Application(ApplicationAbstract):
    def run_application(self, env, episodes):
        return [self.drive_episode(env, max_steps=5) for _ in range(episodes)]

    def build_observation(self, raw):
        return raw, np.ones(2, np.float32)

    def calculate_performance_return(self, last_reward, terminated, truncated):
        return last_reward


class _RawEnv:
    """``reset() -> raw``, ``step(act) -> (raw, reward, terminated,
    truncated)``: CartPole without the info dicts."""

    def __init__(self):
        self.env = make("CartPole-v1")

    def reset(self):
        return self.env.reset(seed=0)[0]

    def step(self, act):
        return self.env.step(act)[:4]


def test_application_drives_an_episode_through_the_actor(tmp_path):
    runner = _runner(tmp_path, make("CartPole-v1"))
    sent = _record_sends(runner)
    totals = _Application(runner.actor).run_application(_RawEnv(), 2)
    assert totals == [5.0, 5.0] and len(sent) == 2
    records = deserialize_actions(sent[0])
    assert len(records) == 6 and records[-1].truncated and records[-1].obs is not None
    assert all(np.array_equal(r.mask, np.ones(2, np.float32)) for r in records[:-1])


def test_example_twins_run_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    train_local.main(["--baseline", "--updates", "2", "--device", "cpu", "--eval-episodes",
                      "1", "--hp", "traj_per_epoch=2", "--hp", "train_vf_iters=2"])
    out = capsys.readouterr().out
    assert "[local] updates=2" in out and "greedy eval over 1 episodes" in out
    train_memory.main(["--model", "mlp", "--epochs", "1", "--device", "cpu",
                       "--env-dir", str(tmp_path / "mem")])
    assert "[memory/mlp] updates=1" in capsys.readouterr().out
    recall_seeds.main(["--seeds", "1", "--updates", "1", "--device", "cpu",
                       "--env-dir", str(tmp_path / "seeds")])
    assert re.search(r"\[recall-seeds\] [01] of 1 runs at >= 0\.98 after 1 updates",
                     capsys.readouterr().out)


def test_runner_is_seeded(tmp_path):
    """An explicit seed seeds the learner's init and the actor's stream:
    two runners at one seed give the same first update."""
    params = []
    for run in range(2):
        runner = _runner(tmp_path / str(run), _TwoStepEnv(), seed_salt=0)
        runner.train(epochs=1)
        params.append(jax.tree.leaves(runner.algorithm.bundle().params))
    for a, b in zip(*params):
        np.testing.assert_array_equal(a, b)
