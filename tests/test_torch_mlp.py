"""The MLP families and the classic envs: the port against the JAX package.

* ``mlp_discrete`` and ``mlp_continuous``: ``evaluate`` and ``mode`` from
  the same params (carried with ``params_from_jax``) on the same inputs,
  masked logits included, and ``step`` scored on a fixed action: its
  sampled action's ``logp_a`` is the JAX ``evaluate`` of that action, and
  its ``v`` the JAX one (the two packages draw from different streams).
* One ``mlp_discrete`` REINFORCE update from the same params and batch.
* ``ModelBundle`` bytes of an MLP are equal both ways.
* The copied CartPole and Pendulum step the same states, rewards and flags
  as the JAX package's from one seed.

Sizes: obs 5, act 3, hidden (16, 8), batch [3, 4].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.algorithms.reinforce import ReinforceState as JaxState
from relayrl_tpu.algorithms.reinforce import make_optimizers as jax_make_optimizers
from relayrl_tpu.algorithms.reinforce import make_reinforce_update as jax_make_update
from relayrl_tpu.envs.classic import CartPoleEnv as JaxCartPole
from relayrl_tpu.envs.classic import PendulumEnv as JaxPendulum
from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu.types.model_bundle import ModelBundle as JaxModelBundle
from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
from relayrl_tpu_torch.algorithms.reinforce import (
    ReinforceState,
    make_optimizers,
    make_reinforce_update,
)
from relayrl_tpu_torch.envs import CartPoleEnv, PendulumEnv, make
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.types import ModelBundle
from relayrl_tpu_torch.weights import params_to_jax

OBS, ACT, HIDDEN = 5, 3, [16, 8]
B, T = 3, 4
# f32: the same arithmetic in another order. bf16: the trunks round to
# bf16 after every Dense and activation, at places where XLA and torch
# accumulate differently, so logp, entropy, v and the mean are held at
# 3e-2 (a few bf16 ulps of values of order 1).
F32_TOL, BF16_TOL = 1e-5, 3e-2
# The REINFORCE update (tests/test_torch_reinforce.py's bars): metrics at
# rtol 1e-4 (atol 1e-6 for AdvMean, which is ~0 by construction), params
# at atol 1e-5.
METRIC_RTOL, METRIC_ATOL, PARAM_ATOL = 1e-4, 1e-6, 1e-5
PI_LR, VF_LR, GAMMA, LAM, VF_ITERS = 3e-4, 1e-3, 0.98, 0.97, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this module from crowding the other test workers' CPUs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arch(kind, precision="float32", activation="tanh", has_critic=True):
    return {"kind": kind, "obs_dim": OBS, "act_dim": ACT, "hidden_sizes": HIDDEN,
            "activation": activation, "has_critic": has_critic,
            "precision": precision}


def _tree(arch, seed=0):
    return jax.tree.map(np.asarray,
                        jax_build_policy(arch).init_params(jax.random.PRNGKey(seed)))


def _inputs(kind, seed=0):
    """obs [B, T, OBS]; a mask [B, T, ACT] with action 1 illegal every
    other step; actions legal under it (discrete) or Gaussian draws."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, T, OBS)).astype(np.float32)
    mask = np.ones((B, T, ACT), np.float32)
    mask[:, ::2, 1] = 0.0
    if kind == "mlp_discrete":
        act = rng.integers(0, ACT, (B, T)).astype(np.int32)
        act[:, ::2] = np.where(act[:, ::2] == 1, 0, act[:, ::2])
    else:
        act = rng.standard_normal((B, T, ACT)).astype(np.float32)
    return obs, mask, act


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor)
                                          else got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("kind,precision,activation,masked", [
    ("mlp_discrete", "float32", "tanh", True),
    ("mlp_discrete", "float32", "tanh", False),
    ("mlp_discrete", "float32", "relu", True),
    ("mlp_discrete", "float32", "gelu", True),
    ("mlp_discrete", "bfloat16", "tanh", True),
    ("mlp_continuous", "float32", "tanh", False),
    ("mlp_continuous", "float32", "gelu", False),
    ("mlp_continuous", "bfloat16", "tanh", False),
])
def test_policy_matches_jax(kind, precision, activation, masked):
    arch = _arch(kind, precision, activation)
    tree = _tree(arch)
    jax_policy, policy = jax_build_policy(arch), build_policy(arch, device="cpu")
    params = policy.load_params(tree)
    obs, mask, act = _inputs(kind)
    mask = mask if masked and kind == "mlp_discrete" else None
    tol = F32_TOL if precision == "float32" else BF16_TOL

    want = jax_policy.evaluate(tree, obs, act, mask)
    with torch.no_grad():
        got = policy.evaluate(params, obs, act, mask)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (B, T)
        _close(g, w, tol)

    want_mode = np.asarray(jax_policy.mode(tree, obs, mask))
    with torch.no_grad():
        got_mode = policy.mode(params, obs, mask)
    if kind == "mlp_discrete":
        # In f32 the argmax agrees (bf16 logits may tie or round apart); a
        # masked action is never the mode.
        if precision == "float32":
            assert np.array_equal(got_mode.numpy(), want_mode)
        if mask is not None:
            assert np.all(np.take_along_axis(mask, got_mode.numpy()[..., None], -1) > 0)
    else:
        _close(got_mode, want_mode, tol)

    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        sampled, aux = policy.step(params, gen, obs, mask)
    scored = jax_policy.evaluate(tree, obs, sampled.numpy(), mask)
    _close(aux["logp_a"], scored[0], tol)
    _close(aux["v"], scored[2], tol)
    if kind == "mlp_discrete" and mask is not None:
        assert np.all(np.take_along_axis(mask, sampled.numpy()[..., None], -1) > 0)


def test_masked_logits_are_filled():
    """An illegal action's logp is the -1e9 fill's, the same in both."""
    arch = _arch("mlp_discrete")
    tree = _tree(arch)
    obs, mask, _ = _inputs("mlp_discrete")
    illegal = np.ones((B, T), np.int32)
    want = jax_build_policy(arch).evaluate(tree, obs, illegal, mask)[0]
    policy = build_policy(arch, device="cpu")
    with torch.no_grad():
        got = policy.evaluate(policy.load_params(tree), obs, illegal, mask)[0]
    assert np.all(got.numpy()[:, ::2] < -1e8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_single_observation_step():
    """One observation ``[obs_dim]`` gives a scalar action and aux."""
    for kind in ("mlp_discrete", "mlp_continuous"):
        arch = _arch(kind)
        policy = build_policy(arch, device="cpu")
        params = policy.init_params(torch.Generator().manual_seed(0))
        with torch.no_grad():
            act, aux = policy.step(params, torch.Generator().manual_seed(1),
                                   np.zeros(OBS, np.float32))
        assert tuple(act.shape) == (() if kind == "mlp_discrete" else (ACT,))
        assert aux["logp_a"].shape == aux["v"].shape == ()
        if kind == "mlp_continuous":
            assert torch.equal(params.log_std.detach(), torch.full((ACT,), -0.5))


@pytest.mark.parametrize("kind,has_critic", [
    ("mlp_discrete", True), ("mlp_discrete", False), ("mlp_continuous", True)])
def test_bundle_bytes_round_trip(kind, has_critic):
    arch = _arch(kind, has_critic=has_critic)
    tree = _tree(arch)
    policy = build_policy(arch, device="cpu")
    back = params_to_jax(policy.load_params(tree))
    jax_bytes = JaxModelBundle(3, arch, tree).to_bytes()
    assert ModelBundle(3, arch, back).to_bytes() == jax_bytes
    assert JaxModelBundle.from_bytes(ModelBundle.from_bytes(jax_bytes).to_bytes(),
                                     params_template=JaxModelBundle.RAW_TREE
                                     ).to_bytes() == jax_bytes


def _batch(seed=0):
    """A padded epoch batch: ragged lengths, a nonzero bootstrap on the
    truncated rows, action 1 illegal every other step."""
    rng = np.random.default_rng(seed)
    valid = (np.arange(T)[None] < np.array([[4], [3], [1]])).astype(np.float32)
    obs, mask, act = _inputs("mlp_discrete", seed)
    return {
        "obs": obs * valid[..., None],
        "act": (act * valid).astype(np.int32),
        "act_mask": mask,
        "rew": rng.standard_normal((B, T)).astype(np.float32) * valid,
        "val": rng.standard_normal((B, T)).astype(np.float32) * valid,
        "logp": -rng.random((B, T)).astype(np.float32) * valid,
        "valid": valid,
        "last_val": np.array([0.0, 0.5, 0.0], np.float32),
    }


@pytest.mark.parametrize("with_baseline", [True, False])
def test_reinforce_update_matches_jax(with_baseline):
    arch = _arch("mlp_discrete", has_critic=with_baseline)
    tree, batch = _tree(arch), _batch()

    jax_policy = jax_build_policy(arch)
    # jaxlint: disable=JAX05 - one update on a tiny state; no donation
    jax_update = jax.jit(jax_make_update(jax_policy, PI_LR, VF_LR, VF_ITERS, GAMMA,
                                         LAM, with_baseline))
    tx_pi, tx_vf = jax_make_optimizers(tree, PI_LR, VF_LR)
    jax_state = JaxState(params=tree, pi_opt_state=tx_pi.init(tree),
                         vf_opt_state=tx_vf.init(tree), rng=jax.random.PRNGKey(0),
                         step=jnp.int32(0))
    jax_new, jax_metrics = jax_update(jax_state, {k: jnp.asarray(v)
                                                  for k, v in batch.items()})
    want_params = jax.tree.map(np.asarray, jax_new.params)

    policy = build_policy(arch, device="cpu")
    params = policy.load_params(tree)
    state = ReinforceState(params, *make_optimizers(params, PI_LR, VF_LR))
    update = make_reinforce_update(policy, VF_ITERS, GAMMA, LAM, with_baseline)
    new, metrics = update(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    got = read_metrics(metrics)
    assert new.step == 1 and set(got) == set(jax_metrics)
    for key, value in jax_metrics.items():
        atol = METRIC_ATOL if key == "AdvMean" else 0.0
        assert got[key] == pytest.approx(float(value), rel=METRIC_RTOL, abs=atol), key
    got_leaves = jax.tree_util.tree_leaves_with_path(params_to_jax(new.params))
    want_leaves = jax.tree_util.tree_leaves_with_path(want_params)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, w, atol=PARAM_ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("env_id,ours,theirs,actions", [
    ("CartPole-v1", CartPoleEnv, JaxCartPole, lambda rng: int(rng.integers(0, 2))),
    ("Pendulum-v1", PendulumEnv, JaxPendulum,
     lambda rng: rng.uniform(-2.0, 2.0, (1,)).astype(np.float32)),
])
def test_classic_envs_match_jax_bit_for_bit(env_id, ours, theirs, actions):
    env, ref = make(env_id), theirs()
    assert isinstance(env, ours)
    assert env.observation_space.shape == ref.observation_space.shape
    rng = np.random.default_rng(0)
    for seed in (0, 7):
        obs, _ = env.reset(seed=seed)
        ref_obs, _ = ref.reset(seed=seed)
        assert np.array_equal(obs, ref_obs) and obs.dtype == ref_obs.dtype
        for _ in range(600):
            act = actions(rng)
            got, want = env.step(act), ref.step(act)
            assert np.array_equal(got[0], want[0]) and got[1:4] == want[1:4]
            if got[2] or got[3]:
                break


def test_make_refuses_unknown_env():
    with pytest.raises(ValueError, match="unknown env"):
        make("LunarLander-v3")
