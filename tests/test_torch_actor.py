"""The serving slice as a whole: the port's actors against the JAX package's.

* A JAX ``VectorActorHost`` and the port's, on the same carried params and
  the same ``RecallEnv`` observation streams, give per-lane per-step values
  and greedy actions that agree, across an episode boundary and a rolling
  window (RecallEnv's observations do not depend on the actions taken, so
  both hosts see the same stream although their samplers differ).
* Inside the port, a batch-of-1 ``VectorActorHost`` is bit-identical to a
  ``PolicyActor`` serving through its window with the same seed.
* Sampling follows the policy's softmax in distribution.
* A bundle the JAX package serialized installs through ``swap_from_bytes``.
* Entry points refuse to fall back to the CPU on their own.
"""

import jax
import numpy as np
import pytest
import torch

from relayrl_tpu.envs import RecallEnv as JaxRecallEnv
from relayrl_tpu.envs import SyncVectorEnv as JaxSyncVectorEnv
from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu.runtime.vector_actor import VectorActorHost as JaxVectorActorHost
from relayrl_tpu.types.model_bundle import ModelBundle as JaxModelBundle
from relayrl_tpu.types.trajectory import deserialize_actions as jax_deserialize
from relayrl_tpu_torch.envs import RecallEnv, SyncVectorEnv
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.runtime import PolicyActor, VectorActorHost
from relayrl_tpu_torch.runtime.policy_actor import make_batched_step
from relayrl_tpu_torch.runtime.vector_actor import run_vector_gym_loop
from relayrl_tpu_torch.types import ModelBundle

# f32 through two small layers: the same arithmetic summed in another order.
TOL = 2e-5
HORIZON, N_CUES = 10, 2  # obs_dim 4, act_dim 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this module from crowding the other test workers' CPUs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arch(**extra):
    return {"kind": "transformer_discrete", "obs_dim": N_CUES + 2,
            "act_dim": N_CUES, "d_model": 32, "n_layers": 2, "n_heads": 2,
            "max_seq_len": 8, "attention": "flash", **extra}


def _jax_params(arch, seed):
    policy = jax_build_policy(arch)
    return jax.tree.map(np.asarray, policy.init_params(jax.random.PRNGKey(seed)))


def test_vector_host_matches_jax_host():
    arch = _arch()
    params = _jax_params(arch, 0)
    lanes = 3
    jax_host = JaxVectorActorHost(JaxModelBundle(1, dict(arch), params), lanes)
    host = VectorActorHost(ModelBundle(1, dict(arch), params), lanes,
                           device="cpu")
    jax_venv = JaxSyncVectorEnv([lambda: JaxRecallEnv(HORIZON, N_CUES)] * lanes)
    venv = SyncVectorEnv([lambda: RecallEnv(HORIZON, N_CUES)] * lanes)
    jax_greedy = jax.jit(jax.vmap(jax_host.policy.mode_window,
                                  in_axes=(None, 0, 0, None)))
    obs, _ = venv.reset(seed=3)
    jax_obs, _ = jax_venv.reset(seed=3)
    for step in range(2 * HORIZON + 3):  # 8-row window rolls at step 8
        np.testing.assert_array_equal(obs, jax_obs)
        got = host.request_for_actions(obs)
        want = jax_host.request_for_actions(jax_obs)
        np.testing.assert_array_equal(host._windows, jax_host._windows)
        np.testing.assert_array_equal(host._window_lens, jax_host._window_lens)
        for lane in range(lanes):
            np.testing.assert_allclose(got[lane].data["v"],
                                       want[lane].data["v"], atol=TOL,
                                       rtol=TOL, err_msg=f"step {step}")
        with torch.no_grad():
            greedy = host.policy.mode_window(host.params, host._windows,
                                             host._window_lens)
        assert greedy.tolist() == np.asarray(jax_greedy(
            params, jax_host._windows, jax_host._window_lens, None)).tolist()
        acts = [int(r.act) for r in want]
        obs, _, terms, _, _ = venv.step(acts)
        jax_obs, _, jax_terms, _, _ = jax_venv.step(acts)
        assert terms.tolist() == jax_terms.tolist()
        for lane in np.flatnonzero(terms):
            host.flag_last_action(int(lane), 0.0, terminated=True)
            jax_host.flag_last_action(int(lane), 0.0, terminated=True)


def test_batch_of_one_bit_identical_to_policy_actor():
    arch = _arch()
    bundle = ModelBundle(1, dict(arch), _jax_params(arch, 1))
    sent_single, sent_vec = [], []
    # use_kv_cache=False pins the single actor to the window path the
    # vector host batches, as the JAX package's twin test does: the
    # comparison is then exact, not cache-vs-window numerics
    # (tests/test_torch_kv_cache.py holds those).
    single = PolicyActor(bundle, seed=9, device="cpu", use_kv_cache=False,
                         on_send=sent_single.append)
    host = VectorActorHost(bundle, 1, seed=9, device="cpu",
                           on_send=lambda lane, p: sent_vec.append(p))
    rng = np.random.default_rng(4)
    for i in range(12):  # 8-row window: fills at 8, rolls after
        obs = rng.standard_normal(4).astype(np.float32)
        reward = 0.0 if i == 0 else 0.5
        r1 = single.request_for_action(obs, reward=reward)
        [r2] = host.request_for_actions(obs[None], rewards=[reward])
        assert np.asarray(r1.act).dtype == np.int32
        assert np.array_equal(np.asarray(r1.act), np.asarray(r2.act)), i
        for key in ("logp_a", "v"):
            assert r1.data[key].dtype == np.float32 and r1.data[key].shape == ()
            assert np.array_equal(r1.data[key], r2.data[key]), (i, key)
    single.flag_last_action(1.0, terminated=True)
    host.flag_last_action(0, 1.0, terminated=True)
    assert sent_single == sent_vec and len(sent_single) == 1
    # the shipped episode decodes with the JAX package's codec
    records = jax_deserialize(sent_single[0])
    assert len(records) == 13 and records[-1].done


def test_sampling_follows_softmax():
    """20000 lanes on one window: each action's frequency is within 0.02
    (over five binomial standard deviations at this count) of the
    probability the policy gives it."""
    arch = _arch(act_dim=3)
    policy = build_policy(arch, device="cpu")
    module = policy.load_params(_jax_params(arch, 2))
    window = np.random.default_rng(5).standard_normal((8, 4)).astype(np.float32)
    n = 20000
    with torch.no_grad():
        act, aux = policy.step_window(module, torch.Generator().manual_seed(0),
                                      np.repeat(window[None], n, axis=0),
                                      np.full(n, 6))
        probs = torch.softmax(module(torch.from_numpy(window)[None])[0][0, 5],
                              dim=-1)
    freq = torch.bincount(act, minlength=3).double() / n
    np.testing.assert_allclose(freq.numpy(), probs.double().numpy(), atol=0.02)
    np.testing.assert_allclose(aux["logp_a"].numpy(),
                               torch.log(probs)[act].numpy(), atol=1e-5)


def test_swap_from_bytes_installs_jax_bundle():
    arch = _arch()
    host = VectorActorHost(ModelBundle(1, dict(arch), _jax_params(arch, 0)), 2,
                           device="cpu")
    new_params = _jax_params(arch, 6)
    blob = JaxModelBundle(2, dict(arch), new_params).to_bytes()
    assert host.swap_from_bytes(blob)
    assert host.version == 2 and host.swaps == 1
    assert not host.swap_from_bytes(blob)  # stale: same version
    obs = np.random.default_rng(6).standard_normal((2, 8, 4)).astype(np.float32)
    act = np.zeros((2, 8), np.int32)
    with torch.no_grad():
        got = host.policy.evaluate(host.params, obs, act)
    want = jax_build_policy(arch).evaluate(new_params, obs, act)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
    other = JaxModelBundle(3, dict(_arch(d_model=16)), new_params).to_bytes()
    with pytest.raises(ValueError, match="arch"):
        host.swap_from_bytes(other)


def test_vector_gym_loop_ships_every_lane():
    arch = _arch()
    sent = []
    host = VectorActorHost(ModelBundle(1, dict(arch), _jax_params(arch, 3)), 2,
                           device="cpu", on_send=lambda lane, p: sent.append((lane, p)))
    venv = SyncVectorEnv([lambda: RecallEnv(4, N_CUES)] * 2)
    returns = run_vector_gym_loop(host, venv, steps=9, seed=0)
    assert sorted(lane for lane, _ in sent) == [0, 0, 1, 1]
    assert all(len(r) == 2 and set(r) <= {0.0, 1.0} for r in returns)
    for _, payload in sent:
        records = jax_deserialize(payload)
        assert len(records) == 5 and records[-1].done
        assert records[-1].rew in (0.0, 1.0)  # the query step's reward
    assert host.dispatches == 9 and host.steps_served == 18


def test_batched_step_lanes_are_contexts_of_one():
    """make_batched_step: each lane's observation is a context of one, the
    values the JAX policy gives that single observation."""
    arch = _arch()
    params = _jax_params(arch, 4)
    policy = build_policy(arch, device="cpu")
    fn = make_batched_step(policy)
    obs = np.random.default_rng(7).standard_normal((3, 4)).astype(np.float32)
    acts, aux = fn(policy.load_params(params), torch.Generator().manual_seed(0),
                   obs, None, {})
    assert acts.dtype == np.int32 and acts.shape == (3,)
    jax_policy = jax_build_policy(arch)
    for lane in range(3):
        logp, _, v = jax_policy.evaluate(params, obs[lane], acts[lane])
        np.testing.assert_allclose(aux["logp_a"][lane], logp, atol=TOL)
        np.testing.assert_allclose(aux["v"][lane], v, atol=TOL)


def test_greedy_actions_match_jax_policy_actor():
    """PolicyActor.deterministic_action advances the window like the JAX
    actor's and picks its actions; reset_episode clears the window."""
    from relayrl_tpu.runtime.policy_actor import PolicyActor as JaxPolicyActor
    from relayrl_tpu.types.model_bundle import ModelBundle as JaxBundle

    arch = _arch(act_dim=3)
    params = _jax_params(arch, 5)
    actor = PolicyActor(ModelBundle(1, dict(arch), params), device="cpu")
    jax_actor = JaxPolicyActor(JaxBundle(1, dict(arch), params),
                               use_kv_cache=False)
    rng = np.random.default_rng(8)
    for i in range(10):  # rolls past the 8-row window
        if i == 6:
            actor.reset_episode()
            jax_actor.reset_episode()
        obs = rng.standard_normal(4).astype(np.float32)
        got = actor.deterministic_action(obs)
        want = np.asarray(jax_actor.deterministic_action(obs))
        assert got.dtype == np.int32 and got.shape == ()
        assert int(got) == int(want), i
        np.testing.assert_array_equal(actor._window, jax_actor._window)


def test_entry_points_need_cuda_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = _arch()
    bundle = ModelBundle(1, dict(arch), _jax_params(arch, 0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_policy(arch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PolicyActor(bundle)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VectorActorHost(bundle, 2)
    assert build_policy(arch, device="cpu").device == torch.device("cpu")
