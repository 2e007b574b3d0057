"""KV-cache decode: the port's transformer and actor against the window
path and against the JAX package (the twin of tests/test_kv_cache.py; the
MoE family has no port yet).

* The port's ``step_cached`` equals its ``step_window`` at every position,
  for one episode and for a batch of episodes, and a mask gates its
  readout.
* From the same params, the JAX package's ``step_cached`` and
  ``prefill_cache`` and the port's agree in logits, the log-probability of
  a fixed action, v and the written caches.
* A port actor serving through the cache gives the actions a window-path
  actor gives, for the same seed, through a hot swap mid-episode (one
  prefill), a rolling window (the window path takes over), an episode
  boundary (the cache resets), a greedy interleave (the cache is dropped
  and rebuilt) and rapid swap churn.
* ``LocalRunner``'s actor serves a flash transformer through the cache by
  default, and through the window with ``use_kv_cache=False``.

Everything runs on the CPU in f32, where the cached and window paths do the
same arithmetic in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu.models.transformer import _make_core as jax_make_core
from relayrl_tpu_torch.envs import RecallEnv
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.runtime import LocalRunner, PolicyActor
from relayrl_tpu_torch.runtime import local_runner as local_runner_module
from relayrl_tpu_torch.types import ModelBundle

# f32 on the CPU: the cached and window paths (and the two packages) sum
# the same products in another order.
TOL = 1e-5
ARCH = {"kind": "transformer_discrete", "obs_dim": 6, "act_dim": 3,
        "d_model": 32, "n_layers": 2, "n_heads": 2, "max_seq_len": 12,
        "attention": "flash"}
W = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this module from crowding the other test workers' CPUs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_tree(seed: int):
    """The JAX package's initial params of ``ARCH`` as numpy, the tree a
    ModelBundle carries."""
    params = jax_build_policy(ARCH).init_params(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _port(seed: int = 0):
    policy = build_policy(ARCH, device="cpu")
    return policy, policy.load_params(_jax_tree(seed))


def _obs(rng, *shape):
    return rng.standard_normal((*shape, ARCH["obs_dim"])).astype(np.float32)


@pytest.mark.parametrize("batch", [None, 3])
def test_step_cached_matches_step_window(batch):
    """At every position of a W-long episode (or of ``batch`` episodes side
    by side), a decode step gives the window step's action (same draws),
    v and logp_a."""
    policy, params = _port()
    rng = np.random.default_rng(0)
    lanes = 1 if batch is None else batch
    cache = policy.init_cache(W, batch_size=lanes)
    windows = np.zeros((lanes, W, ARCH["obs_dim"]), np.float32)
    with torch.no_grad():
        for t in range(W):
            obs = _obs(rng, lanes)
            windows[:, t] = obs
            if batch is None:
                win, ts, step_obs = windows[0], t + 1, obs[0]
            else:
                win, ts, step_obs = windows, np.full(lanes, t + 1), obs
            a_w, aux_w = policy.step_window(params, torch.Generator().manual_seed(t), win, ts)
            a_c, aux_c, cache = policy.step_cached(params, torch.Generator().manual_seed(t),
                                                   cache, step_obs, t)
            assert a_c.shape == a_w.shape == (() if batch is None else (lanes,))
            assert torch.equal(a_c, a_w), t
            for key in ("v", "logp_a"):
                torch.testing.assert_close(aux_c[key], aux_w[key], atol=TOL, rtol=0)


def test_step_cached_mask_gates_the_readout():
    policy, params = _port()
    cache = policy.init_cache(4)
    mask = np.array([1.0, 0.0, 0.0], np.float32)
    for seed in range(5):
        act, _, cache = policy.step_cached(params, torch.Generator().manual_seed(seed),
                                           cache, np.zeros(6, np.float32), 0, mask)
        assert int(act) == 0  # the only legal action


def _log_softmax_at(logits, act):
    logits = np.asarray(logits, np.float64)
    m = logits.max(-1, keepdims=True)
    return (logits - m - np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., act]


def _assert_caches_close(got, want):
    assert len(got) == len(want) == ARCH["n_layers"]
    for (gk, gv), (wk, wv) in zip(got, want):
        for g, w in ((gk, wk), (gv, wv)):
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("path", ["step", "prefill"])
def test_decode_matches_jax(path):
    """From one params tree: per-step decode ("step": positions 0..W-1 one
    at a time) or a prefill of a half-filled padded window followed by a
    decode step at its first empty position ("prefill"), through the JAX
    package's core and ``prefill_cache`` and the port's. Logits, the
    log-probability of a fixed action, v and the caches agree within
    ``TOL``."""
    tree = _jax_tree(1)
    jax_policy, jax_core = jax_build_policy(ARCH), jax_make_core(ARCH)
    policy, params = _port(1)
    rng = np.random.default_rng(2)
    act = 1
    jax_cache, cache = jax_policy.init_cache(W), policy.init_cache(W)

    def decode(obs, t):
        nonlocal jax_cache, cache
        (want_logits, want_v), jax_cache = jax_core.apply(
            tree, jnp.asarray(obs[None, None]), None, cache=jax_cache, t=t)
        with torch.no_grad():
            (logits, v), cache = params(torch.from_numpy(obs[None, None]), None,
                                        cache=cache, t=t)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=TOL, rtol=0)
        np.testing.assert_allclose(v.numpy(), np.asarray(want_v), atol=TOL, rtol=0)
        np.testing.assert_allclose(_log_softmax_at(logits.numpy(), act),
                                   _log_softmax_at(np.asarray(want_logits), act),
                                   atol=TOL, rtol=0)
        _assert_caches_close(cache, jax_cache)

    if path == "step":
        for t in range(W):
            decode(_obs(rng), t)
        return
    filled = W // 2
    window = np.zeros((W, ARCH["obs_dim"]), np.float32)
    window[:filled] = _obs(rng, filled)
    jax_cache = jax_policy.prefill_cache(tree, jax_cache, jnp.asarray(window))
    with torch.no_grad():
        cache = policy.prefill_cache(params, cache, window)
    _assert_caches_close(cache, jax_cache)
    decode(_obs(rng), filled)


def _actor(seed=0, use_kv_cache=True, tree_seed=0, **arch):
    return PolicyActor(ModelBundle(1, {**ARCH, **arch}, _jax_tree(tree_seed)), seed=seed,
                       max_traj_length=200, device="cpu", use_kv_cache=use_kv_cache)


def _spy(actor, name: str) -> list:
    """Replaces ``actor.<name>`` with a wrapper that records each call's
    position argument (or None) and returns the list."""
    calls, fn = [], getattr(actor, name)

    def spy(*args):
        calls.append(args[4] if name == "_cached_fn" else None)
        return fn(*args)
    setattr(actor, name, spy)
    return calls


# Event scripts: "o" an observation (a sampled step), "s" a hot swap to the
# next bundle, "g" a greedy step, "d" an episode boundary.
SCENARIOS = {
    "same_actions": ("o" * W, {}),
    "hot_swap": ("ooo" + "s" + "ooo", {}),
    "rolling": ("o" * 7, {"actor_context": 4}),
    "episode_boundary": ("ooo" + "d" + "ooo", {}),
    "greedy_interleave": ("oo" + "g" + "oo", {}),
    "swap_churn": ("oo" + "soo" * 4, {}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cached_actor_matches_window_actor(scenario):
    """Two actors from one bundle and seed, one serving through the cache:
    the same actions, and v within ``TOL``, at every step of the script.
    The cache is rebuilt by exactly one prefill per swap (and per greedy
    interleave), started without one at an episode's first step, dropped
    at an episode boundary, and the window path takes over once the
    window rolls."""
    events, arch = SCENARIOS[scenario]
    cached, window = _actor(seed=3, **arch), _actor(seed=3, use_kv_cache=False, **arch)
    assert cached._cached_fn is not None and window._cached_fn is None
    steps, prefills = _spy(cached, "_cached_fn"), _spy(cached, "_prefill_fn")
    window_steps = _spy(cached, "_window_fn")
    context = arch.get("actor_context", ARCH["max_seq_len"])
    rng = np.random.default_rng(4)
    version, expected_prefills, episode_len = 1, 0, 0
    for event in events:
        if event == "s":
            version += 1
            bundle = ModelBundle(version, dict(ARCH, **arch), _jax_tree(version))
            assert cached.maybe_swap(bundle) and window.maybe_swap(bundle)
            expected_prefills += episode_len > 0
        elif event == "d":
            for actor in (cached, window):
                actor.flag_last_action(reward=1.0)
            assert cached._cache is None and cached._window_len == 0
            episode_len = 0
        elif event == "g":
            obs = _obs(rng)
            assert int(cached.deterministic_action(obs)) == int(window.deterministic_action(obs))
            assert cached._cache is None
            episode_len += 1
            expected_prefills += 1  # the next sampled step rebuilds
        else:
            obs = _obs(rng)
            r1, r2 = cached.request_for_action(obs), window.request_for_action(obs)
            assert int(r1.act) == int(r2.act)
            for key in ("v", "logp_a"):
                np.testing.assert_allclose(r1.data[key], r2.data[key], atol=TOL, rtol=0)
            episode_len += 1
            if episode_len > context:
                assert cached._cache is None  # rolled: the window path served
    n_obs = events.count("o")
    rolled = max(0, events.count("o") + events.count("g") - context)
    assert len(steps) == n_obs - rolled and len(window_steps) == rolled
    assert len(prefills) == expected_prefills


@pytest.mark.parametrize("use_kv_cache", [True, False])
def test_local_runner_serves_through_the_cache(tmp_path, monkeypatch, use_kv_cache):
    """``LocalRunner`` on ``RecallEnv`` with the recall golden's flash
    transformer: its actor takes the cached path by default (and never the
    window path inside an episode that fits the context), the window path
    with ``use_kv_cache=False``."""
    if not use_kv_cache:
        monkeypatch.setattr(local_runner_module, "PolicyActor",
                            functools.partial(PolicyActor, use_kv_cache=False))
    runner = LocalRunner(
        RecallEnv(horizon=4), "REINFORCE", env_dir=str(tmp_path), seed=0, device="cpu",
        model_kind="transformer_discrete", d_model=16, n_layers=1, n_heads=2,
        max_seq_len=16, attention="flash", traj_per_epoch=2, bucket_lengths=(16,),
        logger_kwargs={"output_dir": str(tmp_path / "logs")})
    actor = runner.actor
    assert (actor._cached_fn is not None) == use_kv_cache
    spies = {name: _spy(actor, name) for name in ("_window_fn", "_cached_fn", "_prefill_fn")
             if getattr(actor, name) is not None}
    runner.train(epochs=1)
    served = actor.steps_served
    assert served >= 8 and runner.updates == 1
    if use_kv_cache:
        assert len(spies["_cached_fn"]) == served and not spies["_window_fn"]
        # Episodes start with a fresh cache; the swap after the update
        # lands between episodes, so nothing is refilled.
        assert spies["_cached_fn"].count(0) == served // 4 and not spies["_prefill_fn"]
    else:
        assert len(spies["_window_fn"]) == served
