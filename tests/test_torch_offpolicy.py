"""The off-policy family: the port's step ring, Q-networks, DQN, C51, DDPG,
TD3 and SAC against the JAX package's, on the CPU.

* The ring: the same episodes give the same stored transitions (markers,
  truncation bootstraps, the columnar ``add_decoded`` path, the scrub, the
  checkpoint arrays), and, seeded alike, the same sample indices bit for
  bit, so every batch below is the JAX ring's.
* The projection, each policy kind's ``evaluate`` and ``mode`` (atol 1e-6)
  and the squashed-Gaussian sample on the JAX draw; epsilon-greedy and the
  Gaussian exploration by their distribution (the two packages' random
  streams differ).
* One update of each algorithm, twice in a row (TD3's policy delay takes
  its actor branch, then skips it), from the JAX learner's params carried
  across by ``weights.py`` with targets that differ from them, on the same
  batches, with the JAX update's own noise injected. Bars are
  ``tests/test_torch_reinforce.py``'s: metrics at rtol 1e-4 (atol 1e-6 for
  the metrics that sit near 0), params at atol 1e-5, with the Adam-floor
  rule: an element whose RMS gradient on the port's side fell below 1e-6
  at some step takes Adam's normalized step on f32 rounding noise, so it is
  held to Adam's step bound, the learning rate per step taken (its target
  copy likewise).
* The cases of ``tests/test_offpolicy.py`` on the port: bandit learning,
  epsilon into the bundle, bundle round trips (into the JAX package too),
  the uint8 ring, dispatch fusion (bit-equal), the exploration hot swap and
  burst bounding; the checkpoint aux round trip and the refusals (the
  pixel q-trunk itself: ``tests/test_torch_cnn.py``).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.algorithms import build_algorithm as jax_build_algorithm
from relayrl_tpu.algorithms.c51 import categorical_projection as jax_projection
from relayrl_tpu.data import StepReplayBuffer as JaxStepReplayBuffer
from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu.models.q_networks import (
    squashed_gaussian_sample as jax_squashed_sample,
)
from relayrl_tpu.types.action import ActionRecord as JaxActionRecord
from relayrl_tpu.types.columnar import DecodedTrajectory as JaxDecoded
from relayrl_tpu_torch.algorithms import build_algorithm, registered_algorithms
from relayrl_tpu_torch.algorithms.c51 import categorical_projection
from relayrl_tpu_torch.algorithms.offpolicy import OffPolicyAlgorithm
from relayrl_tpu_torch.data import StepReplayBuffer
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.models.q_networks import squashed_gaussian_sample
from relayrl_tpu_torch.types import ActionRecord, ModelBundle
from relayrl_tpu_torch.types.columnar import DecodedTrajectory
from relayrl_tpu_torch.weights import params_to_jax

OBS_DIM = 4
METRIC_RTOL, METRIC_ATOL, PARAM_ATOL = 1e-4, 1e-6, 1e-5
ADAM_FLOOR = 1e-6
FIELDS = ("obs", "act", "rew", "obs2", "mask2", "done")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this module from crowding the other test workers' CPUs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _discrete_episode(n, act_fn, obs_dim=OBS_DIM, seed=0, record=ActionRecord,
                      with_mask=False, act_dim=2):
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        obs = rng.standard_normal(obs_dim).astype(np.float32)
        act = int(act_fn(rng))
        mask = None
        if with_mask:
            mask = np.ones(act_dim, np.float32)
            mask[rng.integers(act_dim)] = 0.0
            mask[act] = 1.0
        records.append(record(obs=obs, act=np.int64(act), mask=mask,
                              rew=1.0 if act == 1 else 0.0, done=(i == n - 1)))
    return records


def _continuous_episode(n, obs_dim=OBS_DIM, act_dim=1, seed=0, record=ActionRecord):
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        obs = rng.standard_normal(obs_dim).astype(np.float32)
        act = rng.uniform(-1, 1, act_dim).astype(np.float32)
        rew = float(-np.sum(np.square(act - 0.5)))
        records.append(record(obs=obs, act=act, rew=rew, done=(i == n - 1)))
    return records


def _as_jax(records):
    return [JaxActionRecord(obs=r.obs, act=r.act, mask=r.mask, rew=r.rew,
                            done=r.done, truncated=r.truncated) for r in records]


def _truncated(records, final_obs=None, marker_rew=0.5):
    """End ``records`` by a time limit: the last step not done, and a
    truncation marker carrying ``final_obs``."""
    last = records[-1]
    records[-1] = ActionRecord(obs=last.obs, act=last.act, mask=last.mask,
                               rew=last.rew, done=False)
    records.append(ActionRecord(obs=final_obs, rew=marker_rew, done=True,
                                truncated=True))
    return records


def _episodes(discrete, n_eps=6, length=25, act_dim=2):
    """A mix of terminal and truncated episodes."""
    out = []
    for s in range(n_eps):
        ep = (_discrete_episode(length, lambda r: r.integers(act_dim), seed=s,
                                with_mask=True, act_dim=act_dim)
              if discrete else
              _continuous_episode(length, act_dim=act_dim, seed=s))
        if s % 3 == 1:
            ep = _truncated(ep, np.full(OBS_DIM, 0.25 * s, np.float32))
        elif s % 3 == 2:
            ep = _truncated(ep)  # no successor: the last step is dropped
        out.append(ep)
    return out


def _rings(discrete, act_dim, capacity, seed=3, obs_dtype=np.float32):
    return (StepReplayBuffer(OBS_DIM, act_dim, capacity, discrete, seed, obs_dtype),
            JaxStepReplayBuffer(OBS_DIM, act_dim, capacity, discrete, seed, obs_dtype))


def _assert_rings_equal(port, ref):
    assert (port.ptr, port.size, port.total_steps) == (ref.ptr, ref.size, ref.total_steps)
    got, want = port.state_arrays(), ref.state_arrays()
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("discrete,act_dim", [(True, 2), (True, 3), (False, 1), (False, 2)])
def test_ring_matches_jax_and_samples_bit_equal(discrete, act_dim):
    port, ref = _rings(discrete, act_dim, capacity=64)  # 6 x 25 steps wrap it
    for ep in _episodes(discrete, act_dim=act_dim):
        assert port.add_episode(ep) == ref.add_episode(_as_jax(ep))
    _assert_rings_equal(port, ref)
    out = port.make_sample_out(32)
    for i in range(5):
        want = ref.sample(32)
        got = port.sample(32, out=out) if i % 2 else port.sample(32)
        for key in FIELDS:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _decoded(records, cls):
    """A columnar trajectory of ``records`` (markers folded), as the codec
    hands it over."""
    from relayrl_tpu_torch.data.batching import fold_trailing_markers

    steps, final_obs, truncated, final_mask = fold_trailing_markers(records)
    t = len(steps)
    cols = {
        "o": np.stack([s.obs for s in steps]).astype(np.float32),
        "a": np.stack([np.asarray(s.act).reshape(-1) for s in steps]),
        "r": np.array([s.rew for s in steps], np.float32),
        "t": np.array([s.done for s in steps], np.uint8),
        "u": np.zeros(t, np.uint8),
        "x": np.array([s.truncated for s in steps], np.uint8),
    }
    if steps[0].mask is not None:
        cols["m"] = np.stack([s.mask for s in steps]).astype(np.float32)
    return cls(agent_id="a", n_steps=t, n_records=len(records),
               marker_truncated=truncated, columns=cols, aux={},
               final_obs=final_obs, final_mask=final_mask)


@pytest.mark.parametrize("discrete", [True, False])
def test_add_decoded_matches_jax_and_add_episode(discrete):
    port, ref = _rings(discrete, 2, capacity=256)
    records_ring, _ = _rings(discrete, 2, capacity=256)
    for ep in _episodes(discrete, act_dim=2):
        stored = port.add_decoded(_decoded(ep, DecodedTrajectory))
        assert stored == ref.add_decoded(_decoded(ep, JaxDecoded))
        assert stored == records_ring.add_episode(ep)
    _assert_rings_equal(port, ref)
    _assert_rings_equal(records_ring, ref)


def test_transitions_link_successor_obs():
    buf = StepReplayBuffer(OBS_DIM, 2, capacity=100)
    ep = _discrete_episode(5, lambda r: r.integers(2), seed=3)
    assert buf.add_episode(ep) == 5
    np.testing.assert_array_equal(buf.obs[1], ep[1].obs)
    np.testing.assert_array_equal(buf.obs2[0], ep[1].obs)
    np.testing.assert_array_equal(buf.obs2[3], ep[4].obs)
    assert buf.done[4] == 1.0 and buf.done[:4].sum() == 0


def test_terminal_marker_folds_reward():
    buf = StepReplayBuffer(OBS_DIM, 2, capacity=100)
    ep = _discrete_episode(3, lambda r: 1, seed=0)
    ep[-1] = ActionRecord(obs=ep[-1].obs, act=ep[-1].act, rew=ep[-1].rew, done=False)
    ep.append(ActionRecord(rew=5.0, done=True))  # flag_last_action marker
    assert buf.add_episode(ep) == 3
    assert buf.rew[2] == pytest.approx(1.0 + 5.0)
    assert buf.done[2] == 1.0


def test_truncated_final_step_dropped():
    buf = StepReplayBuffer(OBS_DIM, 2, capacity=100)
    ep = _discrete_episode(4, lambda r: 0, seed=0)
    ep[-1] = ActionRecord(obs=ep[-1].obs, act=ep[-1].act, rew=0.0, done=False)
    assert buf.add_episode(ep) == 3


def test_truncation_with_final_obs_bootstraps():
    buf = StepReplayBuffer(OBS_DIM, 2, capacity=100)
    final_obs = np.full(OBS_DIM, 7.0, np.float32)
    ep = _truncated(_discrete_episode(3, lambda r: 0, seed=0), final_obs)
    assert buf.add_episode(ep) == 3
    assert buf.done[2] == 0.0
    np.testing.assert_array_equal(buf.obs2[2], final_obs)
    assert buf.rew[2] == pytest.approx(0.0 + 0.5)


def test_truncation_marker_without_obs_drops_final():
    buf = StepReplayBuffer(OBS_DIM, 2, capacity=100)
    ep = _truncated(_discrete_episode(3, lambda r: 0, seed=0), marker_rew=0.0)
    assert buf.add_episode(ep) == 2
    assert buf.done[:2].sum() == 0


def test_ring_wraparound():
    buf = StepReplayBuffer(OBS_DIM, 2, capacity=8)
    for s in range(4):
        buf.add_episode(_discrete_episode(5, lambda r: 0, seed=s))
    assert len(buf) == 8 and buf.total_steps == 20
    batch = buf.sample(16)
    assert batch["obs"].shape == (16, OBS_DIM)
    assert set(batch) == set(FIELDS)


def test_scrub_and_checkpoint_arrays_match_jax():
    port, ref = _rings(False, 2, capacity=40)
    for ep in _episodes(False, n_eps=3, length=20, act_dim=2):
        port.add_episode(ep)
        ref.add_episode(_as_jax(ep))
    for ring in (port, ref):  # poison a wrapped ring in three fields
        ring.rew[3] = np.nan
        ring.obs2[7, 1] = np.inf
        ring.act[11, 0] = -np.inf
    assert port.scrub_nonfinite() == ref.scrub_nonfinite() == 3
    _assert_rings_equal(port, ref)
    # the checkpoint arrays restore into a smaller ring as the JAX one does
    small_port, small_ref = _rings(False, 2, capacity=16)
    small_port.load_state_arrays(port.state_arrays())
    small_ref.load_state_arrays(ref.state_arrays())
    _assert_rings_equal(small_port, small_ref)
    for key in FIELDS:
        np.testing.assert_array_equal(small_port.sample(8)[key], small_ref.sample(8)[key])


# ---------------------------------------------------------------------------
# the uint8 ring
# ---------------------------------------------------------------------------
def test_uint8_store_sample_dtype():
    buf = StepReplayBuffer(obs_dim=8, act_dim=2, capacity=32, seed=0, obs_dtype=np.uint8)
    assert buf.obs.dtype == np.uint8 and buf.obs.nbytes == 32 * 8
    rng = np.random.default_rng(0)
    eps = [ActionRecord(obs=rng.integers(0, 256, 8, dtype=np.uint8),
                        act=np.int64(rng.integers(2)), rew=1.0, done=(i == 5))
           for i in range(6)]
    buf.add_episode(eps)
    batch = buf.sample(4)
    assert batch["obs"].dtype == np.uint8 and batch["obs2"].dtype == np.uint8
    assert batch["rew"].dtype == np.float32


def test_uint8_checkpoint_roundtrip_keeps_bytes():
    buf = StepReplayBuffer(obs_dim=4, act_dim=2, capacity=16, seed=0, obs_dtype=np.uint8)
    for i in range(10):
        buf._put(np.full(4, i, np.uint8), 1, float(i), np.full(4, i + 1, np.uint8),
                 0.0, np.ones(2))
    state = buf.state_arrays()
    assert state["obs"].dtype == np.uint8
    buf2 = StepReplayBuffer(obs_dim=4, act_dim=2, capacity=16, seed=0, obs_dtype=np.uint8)
    buf2.load_state_arrays(state)
    np.testing.assert_array_equal(buf2.obs[:10], buf.obs[:10])
    assert buf2.obs.dtype == np.uint8


def test_uint8_rejects_unsupported_dtype():
    with pytest.raises(ValueError):
        StepReplayBuffer(obs_dim=4, act_dim=2, capacity=8, obs_dtype=np.int16)


def test_float_obs_into_uint8_ring_fails_fast():
    buf = StepReplayBuffer(obs_dim=4, act_dim=2, capacity=8, obs_dtype=np.uint8)
    eps = [ActionRecord(obs=np.random.rand(4).astype(np.float32), act=np.int64(1),
                        rew=0.0, done=True)]
    with pytest.raises(ValueError, match="uint8 replay ring"):
        buf.add_episode(eps)


def test_resume_rejects_dtype_flip():
    src = StepReplayBuffer(obs_dim=4, act_dim=2, capacity=8, seed=0)
    src._put(np.full(4, 0.5, np.float32), 1, 1.0, np.zeros(4, np.float32), 0.0, np.ones(2))
    dst = StepReplayBuffer(obs_dim=4, act_dim=2, capacity=8, seed=0, obs_dtype=np.uint8)
    with pytest.raises(ValueError, match="obs_dtype"):
        dst.load_state_arrays(src.state_arrays())


def test_uint8_ring_trains_dqn(tmp_cwd):
    """A uint8 ring with the MLP q-net: byte observations reach the
    update as bytes and are cast on the device."""
    algo = _mk(tmp_cwd, "DQN", obs_dim=8, act_dim=2, obs_dtype="uint8",
               batch_size=8, update_after=16)
    assert algo.buffer.obs.dtype == np.uint8
    rng = np.random.default_rng(0)
    for _ in range(3):
        algo.receive_trajectory([ActionRecord(
            obs=rng.integers(0, 256, 8, dtype=np.uint8), act=np.int64(rng.integers(2)),
            rew=float(rng.random()), done=(i == 9)) for i in range(10)])
    assert algo.version > 0
    assert all(math.isfinite(v) for v in algo._last_metrics.values())


# ---------------------------------------------------------------------------
# the categorical projection
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("v_min,v_max,n", [(-5.0, 5.0, 11), (-10.0, 10.0, 51),
                                            (-1.0, 30.0, 51)])
def test_projection_matches_jax(v_min, v_max, n):
    """Rows that land exactly on atoms (l == u: integer rewards on the
    unit grid, gamma 1), rows clamped at either end of the support, and
    fractional ones."""
    rng = np.random.default_rng(0)
    support = np.array(jnp.linspace(v_min, v_max, n))
    probs = rng.dirichlet(np.ones(n), 64).astype(np.float32)
    rew = np.where(np.arange(64) % 2, rng.uniform(2 * v_min, 2 * v_max, 64),
                   rng.integers(-3, 4, 64)).astype(np.float32)
    done = (rng.random(64) < 0.3).astype(np.float32)
    for gamma in (0.9, 1.0):
        want = np.asarray(jax_projection(jnp.asarray(support), jnp.asarray(probs),
                                         jnp.asarray(rew), jnp.asarray(done), gamma))
        got = categorical_projection(torch.as_tensor(support), torch.as_tensor(probs),
                                     torch.as_tensor(rew), torch.as_tensor(done),
                                     gamma).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_projection_terminal_and_fractional():
    support = torch.linspace(0.0, 10.0, 11)  # dz = 1
    proj = categorical_projection(support, torch.full((1, 11), 1.0 / 11),
                                  torch.tensor([3.0]), torch.tensor([1.0]), 0.99)
    expected = np.zeros(11)
    expected[3] = 1.0  # done = 1 collapses the target onto the reward atom
    np.testing.assert_allclose(proj[0].numpy(), expected, atol=1e-6)
    probs = torch.zeros((1, 11))
    probs[0, 0] = 1.0
    proj = categorical_projection(support, probs, torch.tensor([2.5]),
                                  torch.tensor([1.0]), 0.99)
    assert proj[0, 2].item() == pytest.approx(0.5)
    assert proj[0, 3].item() == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# the policy kinds
# ---------------------------------------------------------------------------
KIND_ARCHS = {
    "qnet_discrete": {"act_dim": 3, "epsilon": 0.3},
    "c51_discrete": {"act_dim": 3, "n_atoms": 11, "v_min": -2.0, "v_max": 3.0,
                     "epsilon": 0.3},
    "ddpg_continuous": {"act_dim": 2, "act_limit": 2.0, "act_noise": 0.1},
    "sac_continuous": {"act_dim": 2, "act_limit": 2.0},
}


def _kind_arch(kind):
    return {"kind": kind, "obs_dim": OBS_DIM, "hidden_sizes": [16, 16],
            **KIND_ARCHS[kind]}


def _pair(kind, seed=0):
    arch = _kind_arch(kind)
    tree = jax.tree.map(np.asarray, jax_build_policy(arch).init_params(
        jax.random.PRNGKey(seed)))
    policy = build_policy(arch, "cpu")
    return arch, tree, jax_build_policy(arch), policy, policy.load_params(tree)


@pytest.mark.parametrize("kind", sorted(KIND_ARCHS))
def test_policy_evaluate_and_mode_match_jax(kind):
    arch, tree, jax_policy, policy, params = _pair(kind)
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((32, OBS_DIM)).astype(np.float32)
    discrete = kind.endswith("discrete")
    act = (rng.integers(0, arch["act_dim"], 32).astype(np.int32) if discrete
           else rng.uniform(-1, 1, (32, arch["act_dim"])).astype(np.float32))
    mask = np.ones((32, arch["act_dim"]), np.float32)
    mask[np.arange(32), rng.integers(0, arch["act_dim"], 32)] = 0.0
    mask = mask if discrete else None
    want = jax_policy.evaluate(tree, jnp.asarray(obs), jnp.asarray(act),
                               None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = policy.evaluate(params, obs, act, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    want_mode = np.asarray(jax_policy.mode(tree, jnp.asarray(obs),
                                           None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got_mode = policy.mode(params, obs, mask).numpy()
    if discrete:
        np.testing.assert_array_equal(got_mode, want_mode)
    else:
        np.testing.assert_allclose(got_mode, want_mode, atol=1e-6, rtol=0)


def test_squashed_gaussian_sample_matches_jax_on_its_draw():
    rng = np.random.default_rng(2)
    mu = rng.standard_normal((64, 2)).astype(np.float32)
    log_std = rng.uniform(-3, 1, (64, 2)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want_a, want_logp = jax_squashed_sample(key, jnp.asarray(mu), jnp.asarray(log_std), 2.0)
    noise = np.array(jax.random.normal(key, mu.shape, jnp.float32))
    got_a, got_logp = squashed_gaussian_sample(torch.as_tensor(noise), torch.as_tensor(mu),
                                               torch.as_tensor(log_std), 2.0)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(want_logp), atol=2e-5, rtol=1e-6)


def test_log_std_clip_matches_jax():
    """Wide inputs drive the log-std head past [-20, 2]; both sides clip."""
    arch, tree, jax_policy, policy, params = _pair("sac_continuous")
    obs = np.random.default_rng(3).standard_normal((16, OBS_DIM)).astype(np.float32) * 1e4
    _, want_ent, _ = jax_policy.evaluate(tree, jnp.asarray(obs), None)
    with torch.no_grad():
        _, got_ent, _ = policy.evaluate(params, obs, None)
        _, log_std = params(torch.as_tensor(obs))
    assert log_std.min() >= -20.0 and log_std.max() <= 2.0
    assert (log_std == 2.0).any() or (log_std == -20.0).any()
    np.testing.assert_allclose(got_ent.numpy(), np.asarray(want_ent), rtol=1e-6)


@pytest.mark.parametrize("kind", ["qnet_discrete", "c51_discrete"])
def test_epsilon_greedy_by_distribution(kind):
    """epsilon 0.3 over 3 actions, one masked out per row: the greedy
    action with probability 0.7 + 0.3 / 2, each other valid one 0.15, the
    masked one never."""
    arch, tree, _, policy, params = _pair(kind)
    n = 20000
    obs = np.tile(np.random.default_rng(4).standard_normal((1, OBS_DIM)), (n, 1))
    mask = np.ones((n, 3), np.float32)
    greedy = int(policy.mode(params, obs[:1], mask[:1])[0])
    masked = (greedy + 1) % 3
    mask[:, masked] = 0.0
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        act, aux = policy.step(params, gen, obs.astype(np.float32), mask, epsilon=0.3)
    freq = np.bincount(act.numpy(), minlength=3) / n
    assert freq[masked] == 0.0
    assert freq[greedy] == pytest.approx(0.85, abs=0.015)
    assert freq[3 - greedy - masked] == pytest.approx(0.15, abs=0.015)
    with torch.no_grad():
        greedy_only, _ = policy.step(params, gen, obs[:64].astype(np.float32),
                                     mask[:64], epsilon=0.0)
    assert (greedy_only.numpy() == greedy).all()
    assert np.allclose(aux["logp_a"].numpy(), 0.0)


def test_gaussian_exploration_by_distribution():
    arch, tree, _, policy, params = _pair("ddpg_continuous")
    n = 20000
    obs = np.zeros((n, OBS_DIM), np.float32)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        mean = policy.mode(params, obs[:1])[0]
        act, aux = policy.step(params, gen, obs, act_noise=0.1)
    noise = act - mean
    assert noise.mean().abs().max() < 0.003
    assert noise.std(dim=0).sub(0.1).abs().max() < 0.003
    assert act.abs().max() <= 2.0


def test_sac_step_by_distribution():
    """The sampled actions' pre-squash values are N(mu, std): their
    log-probs, recomputed by the JAX formula, are the step's."""
    arch, tree, jax_policy, policy, params = _pair("sac_continuous")
    obs = np.random.default_rng(5).standard_normal((1, OBS_DIM)).astype(np.float32)
    obs = np.repeat(obs, 20000, axis=0)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        act, aux = policy.step(params, gen, obs)
        mu, log_std = params(torch.as_tensor(obs[:1]))
    pre = torch.atanh((act / 2.0).clamp(-1 + 1e-6, 1 - 1e-6))
    z = (pre - mu) / torch.exp(log_std)
    assert z.mean(0).abs().max() < 0.03 and (z.std(0) - 1).abs().max() < 0.03
    assert act.abs().max() <= 2.0 and torch.isfinite(aux["logp_a"]).all()


def test_pixel_trunk_refused(tmp_cwd):
    """The pixel q-trunk refuses what the JAX package's refuses: a frame
    that the conv stack collapses (the Nature trunk needs >= 36 px)."""
    arch = {**_kind_arch("qnet_discrete"), "obs_shape": [4, 4, 1]}
    for build in (lambda: build_policy(arch, "cpu"), lambda: jax_build_policy(arch)):
        with pytest.raises(ValueError, match="collapses a 4x4 frame"):
            build()
    with pytest.raises(ValueError, match="collapses a 2x2 frame"):
        _mk(tmp_cwd, "DQN", act_dim=2, obs_shape=[2, 2, 1])


# ---------------------------------------------------------------------------
# one update against the JAX package's
# ---------------------------------------------------------------------------
UPDATE_HP = {
    "DQN": {"act_dim": 3, "discrete": True, "lr": 1e-3, "double_q": True},
    "DQN-single-q": {"act_dim": 3, "discrete": True, "lr": 1e-3, "double_q": False},
    "C51": {"act_dim": 3, "discrete": True, "lr": 1e-3, "n_atoms": 11,
            "v_min": -3.0, "v_max": 3.0},
    "DDPG": {"act_dim": 2, "discrete": False, "act_limit": 2.0, "pi_lr": 1e-3,
             "q_lr": 1e-3},
    "TD3": {"act_dim": 2, "discrete": False, "act_limit": 2.0, "pi_lr": 1e-3,
            "q_lr": 1e-3, "policy_delay": 2, "target_noise": 0.2, "noise_clip": 0.5},
    "SAC": {"act_dim": 2, "discrete": False, "act_limit": 2.0, "pi_lr": 3e-4,
            "q_lr": 3e-4, "alpha_lr": 3e-4, "alpha": 0.2},
}
BATCH = 32


def _pair_algos(tmp, case, **extra):
    name = case.split("-")[0]
    hp = {k: v for k, v in UPDATE_HP[case].items()}
    act_dim = hp.pop("act_dim")
    common = dict(obs_dim=OBS_DIM, act_dim=act_dim, batch_size=BATCH,
                  update_after=0, buf_size=400, hidden_sizes=[16, 16],
                  gamma=0.9, polyak=0.9, seed=3, seed_salt=0, **hp, **extra)
    ref = jax_build_algorithm(name, env_dir=str(tmp),
                              logger_kwargs={"output_dir": str(tmp / f"jax_{case}")},
                              **common)
    port = build_algorithm(name, env_dir=str(tmp), device="cpu",
                           logger_kwargs={"output_dir": str(tmp / f"port_{case}")},
                           **common)
    return ref, port


def _jax_noise(name, state, batch_size, act_dim):
    """The standard-normal draws the JAX update takes from ``state.rng``."""
    if name == "TD3":
        _, noise_rng = jax.random.split(state.rng)
        return torch.as_tensor(np.array(jax.random.normal(
            noise_rng, (batch_size, act_dim), jnp.float32)))
    if name == "SAC":
        _, a2_rng, pi_rng = jax.random.split(state.rng, 3)
        return tuple(torch.as_tensor(np.array(jax.random.normal(
            r, (batch_size, act_dim), jnp.float32))) for r in (a2_rng, pi_rng))
    return None


def _jax_fields(state) -> dict:
    """The JAX state's networks by field name (flax trees of numpy)."""
    out = {}
    for name in ("params", "target_params", "actor_params", "critic_params",
                 "target_actor_params", "target_critic_params"):
        if hasattr(state, name):
            out[name] = jax.tree.map(np.asarray, getattr(state, name))
    return out


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (x + 0.05 * rng.standard_normal(x.shape))
                        .astype(x.dtype), tree)


def _least_rms_tracker(opts):
    """Post-step hooks recording each element's smallest bias-corrected RMS
    gradient sqrt(v_hat) over the steps taken."""
    least = {}

    def hook(opt, args, kwargs):
        beta2 = opt.param_groups[0]["betas"][1]
        for p, st in opt.state.items():
            rms = st["exp_avg_sq"].sqrt() / math.sqrt(1 - beta2 ** float(st["step"]))
            least[p] = torch.minimum(least[p], rms) if p in least else rms

    for opt in opts:
        opt.register_step_post_hook(hook)
    return least


def _check_update_params(port_state, jax_state, least, opts):
    """Every network of the port's state against the JAX state's at
    PARAM_ATOL, elements under Adam's floor (and their target copies) held
    to the learning rate per step taken."""
    bound_of = {}
    for opt in opts:
        for p in opt.param_groups[0]["params"]:
            bound_of[p] = opt.param_groups[0]["lr"] * float(opt.state[p]["step"])
    want_trees = _jax_fields(jax_state)
    n_floored = 0
    for f in dataclasses.fields(port_state):
        module = getattr(port_state, f.name)
        if not isinstance(module, torch.nn.Module) or f.name == "log_alpha":
            continue
        online = getattr(port_state, f.name.removeprefix("target_"))
        got = params_to_jax(module)
        want = want_trees[f.name]
        got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
        want_leaves = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        assert len(got_leaves) == len(want_leaves)
        online_params = dict(online.named_parameters())
        for path, leaf in got_leaves:
            w = want_leaves[path]
            assert leaf.dtype == w.dtype and leaf.shape == w.shape
            key = ".".join(k.key for k in path[1:])
            key = key.removesuffix(".kernel") + (".weight" if key.endswith("kernel") else "")
            p = online_params[key]
            noise = least[p] < ADAM_FLOOR
            if key.endswith(".weight"):
                noise = noise.T
            noise = noise.numpy()
            bound = np.where(noise, bound_of[p], PARAM_ATOL)
            diff = np.abs(leaf - w)
            assert (diff <= bound).all(), (f.name, key, float(diff.max()))
            n_floored += int(noise.sum())
    return n_floored


@pytest.mark.parametrize("case", sorted(UPDATE_HP))
def test_update_matches_jax(case, tmp_cwd):
    name = case.split("-")[0]
    ref, port = _pair_algos(tmp_cwd, case)
    act_dim = UPDATE_HP[case]["act_dim"]
    discrete = UPDATE_HP[case]["discrete"]
    for ep in _episodes(discrete, n_eps=6, length=20, act_dim=act_dim):
        port.buffer.add_episode(ep)
        ref.buffer.add_episode(_as_jax(ep))
    # Targets that differ from the online networks, on both sides.
    fields = _jax_fields(ref.state)
    swap = {}
    for key in list(fields):
        if key.startswith("target_"):
            fields[key] = _perturbed(fields[key], len(key))
            swap[key] = jax.tree.map(jnp.asarray, fields[key])
    ref.state = ref.state.replace(**swap)
    modules = {key: port.load_module(key, tree) for key, tree in fields.items()}
    if name == "SAC":
        from relayrl_tpu_torch.algorithms.sac import LogAlpha

        modules["log_alpha"] = LogAlpha(torch.as_tensor(np.array(ref.state.log_alpha)))
    state = port.fresh_state(modules)
    opts = [v for v in vars(state).values() if isinstance(v, torch.optim.Optimizer)]
    least = _least_rms_tracker(opts)
    jax_state = ref.state
    for step in range(2):
        batch = ref.buffer.sample(BATCH)
        port_batch = port.buffer.sample(BATCH)
        for key in FIELDS:
            np.testing.assert_array_equal(port_batch[key], batch[key])
        noise = _jax_noise(name, jax_state, BATCH, act_dim)
        # jaxlint: disable=JAX05 - the donated state is rebound below
        jax_state, want = ref._update(jax_state, {k: jnp.asarray(v) for k, v in batch.items()})
        state, got = port._update(state, port._to_device(port_batch), noise)
        want = {k: float(v) for k, v in want.items()}
        got = {k: float(v) for k, v in got.items()}
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=METRIC_RTOL, abs=METRIC_ATOL), \
                (step, key)
        if name == "TD3":
            assert (want["LossPi"] != 0.0) == (step == 0) and (got["LossPi"] == 0.0) == (step == 1)
    assert state.step == 2 == int(jax_state.step)
    _check_update_params(state, jax_state, least, opts)
    if name == "SAC":
        assert float(state.log_alpha.value.detach()) == pytest.approx(
            float(jax_state.log_alpha), rel=1e-6, abs=1e-7)


# ---------------------------------------------------------------------------
# the algorithms (tests/test_offpolicy.py's cases, on the port)
# ---------------------------------------------------------------------------
def _mk(tmp, name, **kw):
    base = dict(obs_dim=OBS_DIM, batch_size=64, update_after=200,
                buffer_size=5000, hidden_sizes=[32], traj_per_epoch=4,
                env_dir=str(tmp), device="cpu", seed_salt=0,
                logger_kwargs={"output_dir": str(tmp / f"logs_{name}")})
    base.update(kw)
    return build_algorithm(name, **base)


def _feed(algo, episodes):
    for ep in episodes:
        algo.receive_trajectory(ep)


@pytest.mark.parametrize("name", ["DQN", "C51", "DDPG", "TD3", "SAC"])
def test_registered_and_built(name, tmp_cwd):
    assert name in registered_algorithms()
    algo = _mk(tmp_cwd, name, act_dim=2)
    assert isinstance(algo, OffPolicyAlgorithm) and algo.version == 0
    assert algo.device == torch.device("cpu")
    bundle = algo.bundle()
    assert bundle.version == 0 and bundle.arch["kind"] == algo.arch["kind"]


def test_marker_only_trajectory_skipped(tmp_cwd):
    algo = _mk(tmp_cwd, "DQN", act_dim=2)
    assert algo.receive_trajectory([ActionRecord(rew=3.0, done=True)]) is False
    assert algo._ep_returns == [] and algo._ep_lengths == []


def test_nonfinite_trajectory_dropped(tmp_cwd):
    algo = _mk(tmp_cwd, "SAC", act_dim=1)
    ep = _continuous_episode(5)
    ep[2] = ActionRecord(obs=ep[2].obs, act=np.array([np.nan], np.float32), rew=0.0)
    assert algo.receive_trajectory(ep) is False
    assert algo.dropped_nonfinite == 1 and len(algo.buffer) == 0


def test_terminated_wins_over_truncated():
    from relayrl_tpu_torch.runtime.policy_actor import PolicyActor
    from relayrl_tpu_torch.types.trajectory import deserialize_actions

    arch, _, _, policy, params = _pair("qnet_discrete")
    sent = []
    actor = PolicyActor(ModelBundle(version=1, arch=arch, params=params_to_jax(params)),
                        on_send=sent.append, device="cpu")
    actor.request_for_action(np.zeros(OBS_DIM, np.float32))
    actor.flag_last_action(1.0, truncated=True, terminated=True,
                           final_obs=np.ones(OBS_DIM, np.float32))
    marker = deserialize_actions(sent[-1])[-1]
    assert marker.done is True and marker.truncated is False


@pytest.mark.parametrize("name,extra", [("DQN", {}), ("C51", {"v_min": -1.0, "v_max": 30.0})])
def test_learns_bandit(tmp_cwd, name, extra):
    """Action 1 always pays 1; the greedy policy must find it from random
    behavior data."""
    algo = _mk(tmp_cwd, name, act_dim=2, gamma=0.9, lr=3e-3, polyak=0.95,
               epsilon_decay_steps=500, **extra)
    _feed(algo, [_discrete_episode(25, lambda r: r.integers(2), seed=s) for s in range(30)])
    assert algo.version > 0
    obs = np.random.default_rng(9).standard_normal((16, OBS_DIM)).astype(np.float32)
    with torch.no_grad():
        greedy = algo.policy.mode(algo._actor_module(), obs).numpy()
    assert (greedy == 1).mean() >= 0.9


def test_epsilon_anneals_into_bundle(tmp_cwd):
    algo = _mk(tmp_cwd, "DQN", act_dim=2, epsilon_decay_steps=100)
    assert algo.bundle().arch["epsilon"] == pytest.approx(1.0)
    _feed(algo, [_discrete_episode(60, lambda r: 0, seed=s) for s in range(3)])
    assert algo.bundle().arch["epsilon"] == pytest.approx(0.05)
    assert algo.snapshot_for_publish().arch["epsilon"] == pytest.approx(0.05)


@pytest.mark.parametrize("name,act_dim", [("DQN", 3), ("SAC", 2), ("DDPG", 2)])
def test_bundle_roundtrip_applies_in_both_packages(tmp_cwd, name, act_dim):
    extra = {} if name == "DQN" else {"act_limit": 2.0}
    algo = _mk(tmp_cwd, name, act_dim=act_dim, **extra)
    eps = ([_discrete_episode(30, lambda r: r.integers(3), seed=s) for s in range(8)]
           if name == "DQN" else
           [_continuous_episode(20, act_dim=2, seed=s) for s in range(12)])
    _feed(algo, eps)
    assert algo.version > 0
    path = tmp_cwd / "m.rlx"
    algo.save(path)
    bundle = ModelBundle.load(path)
    policy = build_policy(bundle.arch, "cpu")
    params = policy.load_params(bundle.params)
    with torch.no_grad():
        act, aux = policy.step(params, torch.Generator().manual_seed(0),
                               np.zeros(OBS_DIM, np.float32))
    if name == "DQN":
        assert int(act) in (0, 1, 2) and "v" in aux
    else:
        assert act.shape == (2,) and float(act.abs().max()) <= 2.0 and "logp_a" in aux
    # the JAX package reads the same artifact to the same greedy actions
    from relayrl_tpu.types.model_bundle import ModelBundle as JaxBundle

    jb = JaxBundle.load(path)
    obs = np.random.default_rng(0).standard_normal((8, OBS_DIM)).astype(np.float32)
    want = np.asarray(jax_build_policy(jb.arch).mode(jb.params, jnp.asarray(obs)))
    with torch.no_grad():
        got = policy.mode(params, obs).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("name,extra", [
    ("DQN", {}),
    ("TD3", {"discrete": False, "act_limit": 1.0, "policy_delay": 2}),
    ("SAC", {"discrete": False}),
])
def test_fused_matches_unfused_bit_equal(tmp_cwd, name, extra):
    def mk(tag, k):
        return _mk(tmp_cwd, name, act_dim=1 + (name == "DQN"), update_after=50,
                   updates_per_dispatch=k,
                   logger_kwargs={"output_dir": str(tmp_cwd / f"logs_{tag}")}, **extra)

    a_loop, a_fused = mk("loop", 1), mk("fused", 4)
    for x, y in zip(a_loop.state_trees().values(), a_fused.state_trees().values()):
        for u, v in zip(jax.tree.leaves(x), jax.tree.leaves(y)):
            np.testing.assert_array_equal(u, v)
    episode = (_continuous_episode(80, act_dim=1, seed=3) if not extra.get("discrete", True)
               else _discrete_episode(80, lambda r: r.integers(2), seed=3))
    a_loop.buffer.add_episode(episode)
    a_fused.buffer.add_episode(episode)
    batches = [a_loop.buffer.sample(a_loop.batch_size) for _ in range(8)]
    for b in batches:
        a_loop.train_on_batch(b)
    dispatched = a_fused.inflight.dispatch_count
    a_fused.train_on_batches(batches)  # 2 fused calls of 4
    assert a_fused.inflight.dispatch_count - dispatched == 2
    assert a_loop.version == a_fused.version == 8
    for x, y in zip(a_loop.state_trees().values(), a_fused.state_trees().values()):
        for u, v in zip(jax.tree.leaves(x), jax.tree.leaves(y)):
            np.testing.assert_array_equal(u, v)
    assert dict(a_loop._last_metrics) == dict(a_fused._last_metrics)


def test_remainder_goes_through_single_path(tmp_cwd):
    algo = _mk(tmp_cwd, "DQN", act_dim=2, update_after=50, updates_per_dispatch=4)
    algo.buffer.add_episode(_discrete_episode(80, lambda r: r.integers(2), seed=1))
    batches = [algo.buffer.sample(algo.batch_size) for _ in range(6)]
    d0 = algo.inflight.dispatch_count
    algo.train_on_batches(batches)  # 1 fused (4) + 2 singles
    assert algo.version == 6 and algo.inflight.dispatch_count - d0 == 3
    assert algo.warmup() == 0  # an eager update has nothing to build


def test_epsilon_change_swaps_and_rebuilds():
    from relayrl_tpu_torch.runtime.policy_actor import PolicyActor

    arch, _, _, _, params = _pair("qnet_discrete")
    tree = params_to_jax(params)
    actor = PolicyActor(ModelBundle(version=1, arch={**arch, "epsilon": 1.0}, params=tree),
                        device="cpu")
    assert actor.maybe_swap(ModelBundle(version=2, arch={**arch, "epsilon": 0.0},
                                        params=tree)) is True
    assert actor.arch["epsilon"] == 0.0 and actor._explore_kwargs == {"epsilon": 0.0}
    obs = np.ones((OBS_DIM,), np.float32)
    acts = {int(actor.request_for_action(obs).get_act().reshape(-1)[0]) for _ in range(8)}
    assert len(acts) == 1


def test_structural_change_still_rejected():
    from relayrl_tpu_torch.runtime.policy_actor import PolicyActor

    arch, _, _, _, params = _pair("qnet_discrete")
    tree = params_to_jax(params)
    actor = PolicyActor(ModelBundle(version=1, arch=arch, params=tree), device="cpu")
    with pytest.raises(ValueError, match="param-ABI guard"):
        actor.maybe_swap(ModelBundle(version=2, arch={**arch, "hidden_sizes": [8]},
                                     params=tree))


@pytest.mark.parametrize("name", [
    "DDPG",
    pytest.param("TD3", marks=pytest.mark.slow),
    pytest.param("SAC", marks=pytest.mark.slow),
])
def test_learns_target_action(tmp_cwd, name):
    """reward = -(a - 0.5)^2 from uniform random behavior: the greedy
    action must move to ~0.5 (gamma 0: a contextual bandit)."""
    algo = _mk(tmp_cwd, name, act_dim=1, gamma=0.0, polyak=0.9, pi_lr=1e-3, q_lr=3e-3,
               update_after=300, updates_per_step=2.0, discrete=False)
    _feed(algo, [_continuous_episode(25, seed=s) for s in range(50)])
    assert algo.version > 0
    obs = np.random.default_rng(7).standard_normal((16, OBS_DIM)).astype(np.float32)
    with torch.no_grad():
        a = algo.policy.mode(algo._actor_module(), obs).numpy()
    assert np.abs(a - 0.5).mean() < 0.25, a.ravel()


def test_sac_alpha_adapts(tmp_cwd):
    algo = _mk(tmp_cwd, "SAC", act_dim=1, update_after=100, discrete=False)
    alpha0 = float(algo.state.log_alpha.value.detach().exp())
    assert alpha0 == pytest.approx(0.2)
    _feed(algo, [_continuous_episode(25, seed=s) for s in range(10)])
    assert float(algo.state.log_alpha.value.detach().exp()) != pytest.approx(alpha0)
    assert "Alpha" in algo._last_metrics


def test_td3_delayed_actor(tmp_cwd):
    """policy_delay 2: LossPi is 0 on odd versions (the skipped branch),
    and the actor and both targets stay as they were."""
    algo = _mk(tmp_cwd, "TD3", act_dim=1, update_after=1, updates_per_step=0.04,
               policy_delay=2, discrete=False)
    algo.receive_trajectory(_continuous_episode(25, seed=0))  # version 0: actor step
    first = algo._last_metrics["LossPi"]
    before = algo.state_trees()
    algo.receive_trajectory(_continuous_episode(25, seed=1))  # version 1: skipped
    after = algo.state_trees()
    assert first != 0.0 and algo._last_metrics["LossPi"] == 0.0
    for field in ("actor_params", "target_actor_params", "target_critic_params"):
        for u, v in zip(jax.tree.leaves(before[field]), jax.tree.leaves(after[field])):
            np.testing.assert_array_equal(u, v)


def test_long_episode_amortized(tmp_cwd):
    """A long episode past warmup runs at most max_updates_per_ingest
    updates; the backlog carries over as debt."""
    algo = _mk(tmp_cwd, "DQN", act_dim=2, update_after=1, updates_per_step=1.0,
               max_updates_per_ingest=8)
    calls = []
    orig = algo.train_on_batch
    algo.train_on_batch = lambda b: (calls.append(1), orig(b))[1]
    algo.receive_trajectory(_discrete_episode(100, lambda r: 0, seed=0))
    assert len(calls) == 8 and algo._update_debt == pytest.approx(92.0)
    algo.receive_trajectory(_discrete_episode(2, lambda r: 0, seed=1))
    assert len(calls) == 16 and algo._update_debt == pytest.approx(86.0)


def test_fractional_ratio_still_updates(tmp_cwd):
    algo = _mk(tmp_cwd, "DQN", act_dim=2, update_after=1, updates_per_step=0.1,
               max_updates_per_ingest=8)
    calls = []
    orig = algo.train_on_batch
    algo.train_on_batch = lambda b: (calls.append(1), orig(b))[1]
    algo.receive_trajectory(_discrete_episode(5, lambda r: 0, seed=0))
    assert len(calls) == 1


def test_accumulate_returns_staged_batches(tmp_cwd):
    """accumulate returns the due batches in reusable staging slots whose
    reuse distance is round + window * k + 1."""
    algo = _mk(tmp_cwd, "DQN", act_dim=2, update_after=1, updates_per_step=1.0,
               max_updates_per_ingest=5, updates_per_dispatch=2, max_inflight_updates=3)
    assert algo.accumulate(_discrete_episode(1, lambda r: 0)) is not None
    got = algo.accumulate(_discrete_episode(10, lambda r: 0, seed=1))
    assert isinstance(got, list) and len(got) == 5
    assert len(algo._sample_ring) == 5 + 3 * 2 + 1
    assert len({id(b["obs"]) for b in got}) == 5
    assert algo.accumulate([ActionRecord(rew=1.0, done=True)]) is None


def test_checkpoint_aux_round_trip(tmp_cwd):
    from relayrl_tpu_torch.checkpoint.manager import (
        checkpoint_algorithm,
        restore_algorithm,
    )

    algo = _mk(tmp_cwd, "SAC", act_dim=1, update_after=50, discrete=False)
    _feed(algo, [_continuous_episode(25, seed=s) for s in range(4)])
    assert algo.version > 0
    ckpt = str(tmp_cwd / "ckpt")
    checkpoint_algorithm(algo, ckpt)
    saved_trees, saved_ring = algo.state_trees(), algo.buffer.state_arrays()
    saved_version = algo.version
    saved_alpha = float(algo.state.log_alpha.value.detach())
    saved_rng = algo.state.rng.clone()
    _feed(algo, [_continuous_episode(25, seed=s) for s in range(4, 6)])
    fresh = _mk(tmp_cwd, "SAC", act_dim=1, update_after=50, discrete=False,
                logger_kwargs={"output_dir": str(tmp_cwd / "logs_fresh")})
    for target in (algo, fresh):
        restore_algorithm(target, ckpt)
        assert target.version == saved_version
        for field, tree in saved_trees.items():
            for u, v in zip(jax.tree.leaves(tree), jax.tree.leaves(target.state_trees()[field])):
                np.testing.assert_array_equal(u, v)
        assert float(target.state.log_alpha.value.detach()) == saved_alpha
        assert torch.equal(target.state.rng, saved_rng)
        ring = target.buffer.state_arrays()
        for key, value in saved_ring.items():
            np.testing.assert_array_equal(ring[key], value)
    # the restored optimizer still moves the restored params
    fresh.train_on_batch(fresh.buffer.sample(fresh.batch_size))
    assert fresh.state.actor_opt.state[next(iter(fresh.state.actor_params.parameters()))]


def test_restore_aux_refuses_dtype_flip(tmp_cwd):
    algo = _mk(tmp_cwd, "DQN", act_dim=2)
    algo.buffer.add_episode(_discrete_episode(5, lambda r: 0))
    aux = algo.checkpoint_aux()
    pixel = _mk(tmp_cwd, "DQN", act_dim=2, obs_dtype="uint8",
                logger_kwargs={"output_dir": str(tmp_cwd / "logs_u8")})
    with pytest.raises(ValueError, match="obs_dtype"):
        pixel.restore_aux(aux)
    assert _mk(tmp_cwd, "DQN", act_dim=2).checkpoint_aux() is None


def test_rollback_scrubs_ring_only_in_warn_posture(tmp_cwd):
    algo = _mk(tmp_cwd, "DDPG", act_dim=1, discrete=False)
    algo.buffer.add_episode(_continuous_episode(10))
    algo.buffer.rew[4] = np.nan
    algo.reset_ingest_buffers()
    assert len(algo.buffer) == 10  # the belt is up: the ring is kept
    algo.ingest_finite_guard = False
    algo.reset_ingest_buffers()
    assert len(algo.buffer) == 9 and np.isfinite(algo.buffer.rew[:9]).all()


def test_multihost_refused(tmp_cwd):
    algo = _mk(tmp_cwd, "TD3", act_dim=1, discrete=False)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        algo.enable_multihost(None)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        algo.mh_zero_batch(4, 0)


def test_guard_probe_tree_is_the_online_networks(tmp_cwd):
    algo = _mk(tmp_cwd, "SAC", act_dim=1, discrete=False)
    assert set(algo._guard_probe_tree()) == {"actor_params", "critic_params"}
    dqn = _mk(tmp_cwd, "DQN", act_dim=2)
    assert dqn._guard_probe_tree() is dqn.state.params
