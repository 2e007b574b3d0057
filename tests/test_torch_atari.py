"""The port's Atari-style pixel pipeline (``relayrl_tpu_torch/envs/atari.py``)
against the JAX package's, on the CPU.

* Frames and rewards byte-equal over a few episodes of the synthetic catch
  toy behind the full preprocessing, float32 and uint8 frames, under both
  of ``_resize_bilinear``'s branches: cv2 when it imports, the numpy
  sampling grid when it does not (``cv2`` is made unimportable in both
  packages). The two branches round differently, so the test also shows
  that their frames differ: a host without cv2 sees other pixels.
* ``make_atari`` with a real ALE id raises the port's named error.
* A ``PolicyActor`` over the CNN keeps byte frames as bytes in its records,
  and its trajectory's wire bytes equal the JAX package's for the same
  records; the columnar frame of byte frames is byte-equal too and parses
  back to bytes; the on-policy epoch buffer widens them to f32 exactly as
  the JAX package's does.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from relayrl_tpu.data import EpochBuffer as JaxEpochBuffer
from relayrl_tpu.envs import make_atari as jax_make_atari
from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu.runtime.policy_actor import normalize_obs as jax_normalize_obs
from relayrl_tpu.types import action as jax_action
from relayrl_tpu.types import columnar as jax_columnar
from relayrl_tpu.types import trajectory as jax_trajectory
from relayrl_tpu_torch.data import EpochBuffer
from relayrl_tpu_torch.envs import ALEUnavailableError, make_atari
from relayrl_tpu_torch.runtime import PolicyActor
from relayrl_tpu_torch.runtime.policy_actor import normalize_obs
from relayrl_tpu_torch.types import ModelBundle, columnar, serialize_actions

GOLDEN_ENV = {"frame_size": 36, "frame_stack": 2, "frame_skip": 2,
              "raw_size": 48, "shaped": True}


def _rollout(make, obs_dtype, episodes=3, seed=5):
    env = make("synthetic", obs_dtype=obs_dtype, seed=seed, **GOLDEN_ENV)
    rng = np.random.default_rng(seed)
    frames, rewards, ends = [], [], []
    for ep in range(episodes):
        obs, _ = env.reset(seed=seed + ep)
        frames.append(obs)
        done = False
        while not done:
            obs, rew, term, trunc, _ = env.step(int(rng.integers(3)))
            frames.append(obs)
            rewards.append(rew)
            ends.append((term, trunc))
            done = term or trunc
    return env, frames, rewards, ends


@pytest.fixture(params=["cv2", "numpy"])
def resize_branch(request, monkeypatch):
    """Which branch of ``_resize_bilinear`` both packages take."""
    if request.param == "cv2":
        pytest.importorskip("cv2")
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)  # import raises
    return request.param


@pytest.mark.parametrize("obs_dtype", ["float32", "uint8"])
def test_frames_and_rewards_byte_equal(resize_branch, obs_dtype):
    env, frames, rewards, ends = _rollout(make_atari, obs_dtype)
    jax_env, jax_frames, jax_rewards, jax_ends = _rollout(jax_make_atari, obs_dtype)
    assert env.obs_shape == jax_env.obs_shape == (36, 36, 2)
    assert env.observation_space.shape == jax_env.observation_space.shape
    assert env.observation_space.dtype == jax_env.observation_space.dtype
    assert env.action_space.n == jax_env.action_space.n == 3
    assert len(frames) == len(jax_frames) > 3 * 4
    for got, want in zip(frames, jax_frames):
        assert got.dtype == want.dtype == np.dtype(obs_dtype)
        assert got.shape == want.shape == (36 * 36 * 2,)
        assert got.tobytes() == want.tobytes()
    assert rewards == jax_rewards and ends == jax_ends
    assert any(r != 0.0 for r in rewards)


def test_resize_branches_differ(monkeypatch):
    pytest.importorskip("cv2")
    _, with_cv2, _, _ = _rollout(make_atari, "uint8", episodes=1)
    monkeypatch.setitem(sys.modules, "cv2", None)
    _, with_numpy, _, _ = _rollout(make_atari, "uint8", episodes=1)
    assert any(a.tobytes() != b.tobytes() for a, b in zip(with_cv2, with_numpy))


def test_north_star_shape():
    env = make_atari("synthetic")
    obs, _ = env.reset(seed=0)
    assert env.obs_shape == (84, 84, 4) and obs.shape == (84 * 84 * 4,)
    obs, *_ = make_atari("synthetic", obs_dtype="uint8").reset(seed=0)
    assert obs.dtype == np.uint8 and obs.nbytes == 28224


def test_real_ale_id_refused():
    with pytest.raises(ALEUnavailableError, match="ALE/Pong-v5"):
        make_atari("ALE/Pong-v5")
    with pytest.raises(ValueError, match="obs_dtype"):
        make_atari("synthetic", obs_dtype="float16")


def test_actor_keeps_byte_frames_and_matches_jax_wire():
    arch = {"kind": "cnn_discrete", "obs_shape": [36, 36, 2], "act_dim": 3,
            "conv_spec": [[4, 8, 4], [8, 4, 2]], "dense": 16}
    params = jax.tree.map(np.asarray, jax_build_policy(arch).init_params(
        jax.random.PRNGKey(0)))
    actor = PolicyActor(ModelBundle(1, arch, params), device="cpu")
    env = make_atari("synthetic", obs_dtype="uint8", seed=1, **GOLDEN_ENV)
    obs, _ = env.reset(seed=1)
    for i in range(4):
        frame = normalize_obs(obs)
        want = jax_normalize_obs(obs)
        assert frame.dtype == want.dtype == np.uint8 and np.array_equal(frame, want)
        act = actor.request_for_action(obs, reward=0.5 * i)
        assert np.asarray(act.obs).dtype == np.uint8
        obs, *_ = env.step(int(act.act))
    actor.flag_last_action(1.0)
    records = actor.trajectory.get_actions()
    assert all(np.asarray(r.obs).dtype == np.uint8 for r in records if r.obs is not None)
    rebuilt = [jax_action.ActionRecord(
        obs=r.obs, act=r.act, mask=r.mask, rew=r.rew, data=r.data, done=r.done,
        reward_updated=r.reward_updated, truncated=r.truncated) for r in records]
    assert serialize_actions(records) == jax_trajectory.serialize_actions(rebuilt)
    with torch.no_grad():
        assert int(actor.policy.mode(actor.params, obs)) in (0, 1, 2)


def test_byte_frames_through_columnar_frames_and_the_epoch_buffer():
    env = make_atari("synthetic", obs_dtype="uint8", seed=2, **GOLDEN_ENV)
    obs, _ = env.reset(seed=2)
    frames = [obs]
    for _ in range(5):
        obs, *_ = env.step(1)
        frames.append(obs)
    n = len(frames) - 1

    def decoded(mod):
        return mod.DecodedTrajectory(
            agent_id="lane0", n_steps=n, n_records=n + 1, marker_truncated=True,
            columns={"o": np.stack(frames[:n]), "a": np.ones(n, np.int32),
                     "r": np.linspace(-1, 1, n).astype(np.float32),
                     "t": np.zeros(n, np.uint8), "u": np.ones(n, np.uint8),
                     "x": np.zeros(n, np.uint8)},
            aux={"v": np.zeros(n, np.float32), "logp_a": np.zeros(n, np.float32)},
            final_obs=frames[n])

    ours = columnar.encode_columnar_frame(decoded(columnar))
    assert ours == jax_columnar.encode_columnar_frame(decoded(jax_columnar))
    back = columnar.parse_frame(ours)
    assert back.columns["o"].dtype == np.uint8
    assert np.array_equal(back.columns["o"], np.stack(frames[:n]))
    flat = len(frames[0])
    port_buf = EpochBuffer(flat, 3, traj_per_epoch=1, buckets=(8,))
    jax_buf = JaxEpochBuffer(flat, 3, traj_per_epoch=1, buckets=(8,))
    assert port_buf.add_episode(back) and jax_buf.add_episode(
        jax_columnar.parse_frame(ours))
    got, want = port_buf.drain().as_dict(), jax_buf.drain().as_dict()
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    assert got["obs"].dtype == np.float32 and got["obs"][0].max() > 1.0  # bytes, widened
