"""The port's IMPALA against the JAX package's.

* One update, JAX ``make_impala_update`` against the port's, from the
  same params, fresh Adam state and the same padded batch, with
  ``max_grad_norm`` small enough that the global-norm clip is active and
  large enough that it is not; the flash transformer (f32 and bf16) and
  the MLP, and ``learner.freeze``.
* The clip itself against ``optax.clip_by_global_norm`` on the same
  gradients, at and around the threshold: the port scales by
  ``max_norm / norm`` only when ``norm >= max_norm``
  (``torch.nn.utils.clip_grad_norm_``'s ``max_norm / (norm + 1e-6)``
  would differ).
* ``tests/test_impala.py``'s checks on the port: the registry, a
  transformer policy through ``model_kind``, learning from stale behavior
  (P(action 1) above 0.6 after 160 episodes from a policy that picks
  action 0 70% of the time) and ``RhoMean`` in (0, 1] on stale data.

Bars: ``tests/test_torch_ppo.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from relayrl_tpu.algorithms.impala import ImpalaState as JaxState
from relayrl_tpu.algorithms.impala import make_impala_tx
from relayrl_tpu.algorithms.impala import make_impala_update as jax_make_update
from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu_torch.algorithms import build_algorithm, registered_algorithms
from relayrl_tpu_torch.algorithms.impala import (
    ImpalaState,
    clip_by_global_norm,
    make_impala_optimizer,
    make_impala_update,
)
from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.types import ActionRecord
from tests.test_torch_ppo import (
    BF16_METRIC_TOL,
    F32_METRIC_ATOL,
    F32_METRIC_RTOL,
    _mlp_arch,
    track_least_rms,
)
from tests.test_torch_ppo import _check_params as _ppo_check_params
from tests.test_torch_reinforce import _arch, _batch, _tree

LR, GAMMA, VF_COEF, ENT, RHO_BAR, C_BAR = 1e-3, 0.99, 0.5, 0.01, 1.0, 0.9
METRICS = ("LossPi", "LossV", "Entropy", "LossTotal", "RhoMean", "KL")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_update(arch, tree, batch, max_grad_norm, freeze=()):
    policy = jax_build_policy(arch)
    # jaxlint: disable=JAX05 - one update on a tiny state; no donation
    update = jax.jit(jax_make_update(
        policy, LR, GAMMA, VF_COEF, ENT, RHO_BAR, C_BAR, max_grad_norm,
        freeze, params_template=tree))
    tx = make_impala_tx(LR, max_grad_norm, freeze, tree)
    state = JaxState(params=tree, opt_state=tx.init(tree),
                     rng=jax.random.PRNGKey(0), step=jnp.int32(0))
    new, metrics = update(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, new.params),
            {k: float(v) for k, v in metrics.items()})


def _port_update(arch, tree, batch, max_grad_norm, freeze=()):
    policy = build_policy(arch, device="cpu")
    params = policy.load_params(tree)
    state = ImpalaState(params, make_impala_optimizer(params, LR, freeze))
    least = track_least_rms((state.opt,))
    update = make_impala_update(policy, GAMMA, VF_COEF, ENT, RHO_BAR, C_BAR,
                                max_grad_norm)
    new, metrics = update(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert new.step == 1 and all(m.ndim == 0 for m in metrics.values())
    new.least_rms = least
    return new, read_metrics(metrics)


def _check_params(state, want, init, precision):
    _ppo_check_params(state, want, init, precision, pi_steps=1, vf_steps=1,
                      lrs=(LR, LR))


@pytest.mark.parametrize("kind,precision,max_grad_norm", [
    ("transformer", "float32", 1e-2), ("transformer", "float32", 1e6),
    ("transformer", "bfloat16", 1e-2), ("mlp", "float32", 1e-2),
    ("mlp", "float32", 1e6)])
def test_update_matches_jax(kind, precision, max_grad_norm):
    arch = _arch(precision) if kind == "transformer" else _mlp_arch(precision)
    tree, batch = _tree(arch), _batch(3)
    want_params, want = _jax_update(arch, tree, batch, max_grad_norm)
    new, got = _port_update(arch, tree, batch, max_grad_norm)
    assert set(got) == set(METRICS) == set(want)
    for key in METRICS:
        if precision == "float32":
            assert got[key] == pytest.approx(want[key], rel=F32_METRIC_RTOL,
                                             abs=F32_METRIC_ATOL), key
        else:
            assert got[key] == pytest.approx(want[key], rel=BF16_METRIC_TOL,
                                             abs=BF16_METRIC_TOL), key
    _check_params(new, want_params, tree, precision)


def test_frozen_leaves_stay_bit_identical():
    from relayrl_tpu.algorithms.freeze import freeze_info as jax_freeze_info
    from relayrl_tpu_torch.weights import params_to_jax

    arch = _arch()
    tree, batch = _tree(arch), _batch(1)
    freeze = ("params/(obs_embed|pos_embed|block_0)", "vf_head_up/bias$")
    want_params, _ = _jax_update(arch, tree, batch, 1e-2, freeze)
    new, _ = _port_update(arch, tree, batch, 1e-2, freeze)
    frozen = jax_freeze_info(tree, freeze)["frozen_paths"]
    g, w, i = (jax.tree_util.tree_flatten_with_path(t)[0]
               for t in (params_to_jax(new.params), want_params, tree))
    for (path, got), (_, want_leaf), (_, init) in zip(g, w, i):
        if "/".join(k.key for k in path) in frozen:
            assert np.array_equal(got, init) and np.array_equal(want_leaf, init)
    _check_params(new, want_params, tree, "float32")


@pytest.mark.parametrize("max_norm", [0.5, 2.0, 3.0, 100.0])
def test_clip_matches_optax(max_norm):
    """Gradients of global norm exactly 3: clipped below, kept at and
    above it, as optax does."""
    grads = [np.array([1.0, 2.0], np.float32), np.array([[2.0]], np.float32)]
    want = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())[0]
    # The gradients stand for their own leaves: no split crosses processes.
    leaves = [torch.as_tensor(g) for g in grads]
    got = clip_by_global_norm(leaves, max_norm, leaves)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if max_norm < 3.0:
        ref = [torch.as_tensor(g).requires_grad_() for g in grads]
        for p, g in zip(ref, grads):
            p.grad = torch.as_tensor(g)
        torch.nn.utils.clip_grad_norm_(ref, max_norm)
        assert any(not torch.equal(p.grad, c) for p, c in zip(ref, got))


def _episode(policy_bias, n=10, obs_dim=4, seed=0):
    """tests/test_impala.py's stale behavior: logp reflects policy_bias."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        act = int(rng.random() < policy_bias)
        logp = np.log(policy_bias if act == 1 else 1 - policy_bias)
        recs.append(ActionRecord(
            obs=rng.standard_normal(obs_dim).astype(np.float32),
            act=np.int64(act), rew=1.0 if act == 1 else 0.0,
            data={"logp_a": np.float32(logp), "v": np.float32(0.0)},
            done=(i == n - 1)))
    return recs


def test_registry_and_sequence_policy(tmp_cwd):
    """model_kind passthrough: IMPALA trains a transformer policy."""
    assert "IMPALA" in registered_algorithms()
    algo = build_algorithm(
        "IMPALA", obs_dim=6, act_dim=3, traj_per_epoch=4,
        model_kind="transformer_discrete", d_model=16, n_layers=1,
        n_heads=2, max_seq_len=16, bucket_lengths=(16,),
        env_dir=str(tmp_cwd), logger_kwargs={"output_dir": str(tmp_cwd)},
        device="cpu")
    assert algo.arch["kind"] == "transformer_discrete"
    rng = np.random.default_rng(0)
    for _ in range(4):
        records = [
            ActionRecord(obs=rng.standard_normal(6).astype(np.float32),
                         act=np.int64(rng.integers(3)), rew=1.0,
                         data={"logp_a": np.float32(-1.1),
                               "v": np.float32(0.2)},
                         done=(i == 7))
            for i in range(8)]
        updated = algo.receive_trajectory(records)
    assert updated and algo.version == 1


def test_learns_from_stale_behavior(tmp_cwd):
    algo = build_algorithm(
        "IMPALA", obs_dim=4, act_dim=2, traj_per_epoch=4, hidden_sizes=[32],
        lr=1e-2, ent_coef=0.0, env_dir=str(tmp_cwd),
        logger_kwargs={"output_dir": str(tmp_cwd / "logs")}, device="cpu")
    for s in range(160):
        algo.receive_trajectory(_episode(0.3, n=12, seed=s))
    obs = np.random.default_rng(5).standard_normal((16, 4)).astype(np.float32)
    with torch.no_grad():
        logp, _, _ = algo.policy.evaluate(
            algo.state.params, torch.as_tensor(obs),
            torch.ones(16, dtype=torch.int64))
    assert float(torch.exp(logp).mean()) > 0.6


def test_rho_mean_in_unit_interval_for_stale_data(tmp_cwd):
    algo = build_algorithm(
        "IMPALA", obs_dim=4, act_dim=2, traj_per_epoch=2, hidden_sizes=[16],
        env_dir=str(tmp_cwd),
        logger_kwargs={"output_dir": str(tmp_cwd / "logs")}, device="cpu")
    for s in range(4):
        algo.receive_trajectory(_episode(0.9, seed=s))
    metrics = read_metrics(algo._last_metrics)
    assert 0.0 < metrics["RhoMean"] <= 1.0 + 1e-6
    assert np.isfinite(metrics["KL"])
