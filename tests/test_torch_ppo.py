"""The port's PPO against the JAX package's.

* One epoch update, JAX ``make_ppo_update`` against the port's, from the
  same params, fresh optimizer state on both sides and the same padded
  batch; the port is fed the minibatch index sets JAX draws, recomputed
  here from ``state.rng`` as the JAX update draws them. The flash
  transformer (f32 and bf16) and the MLP.
* The KL-stop case: ``StopIter`` is 1 on both sides, and the port's pi
  params and pi Adam state after the update equal those after its first
  minibatch, bit for bit.
* ``learner.freeze``: frozen leaves stay bit-identical.
* ``PPO`` constructs through the registry, draws its own shuffles and
  learns CartPole in ``LocalRunner`` with ``tests/test_ppo.py``'s
  hyperparameters and bar.

Bars are ``tests/test_torch_reinforce.py``'s: metrics at rtol 1e-4 (bf16
1e-2), params at atol 1e-5, with the Adam-floor rule of ``chip_smoke.py``'s
``compare_update_to_cpu``: where both sides take Adam's normalized step
on rounding noise (the key third of each qkv bias, whose exact gradient
is zero, and every element whose RMS gradient on the port's side fell
below ``ADAM_FLOOR`` at some step), an element is held to Adam's step
bound, the learning rate per step taken.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.algorithms.ppo import PPOState as JaxState
from relayrl_tpu.algorithms.ppo import make_ppo_update as jax_make_update
from relayrl_tpu.algorithms.reinforce import make_optimizers as jax_make_optimizers
from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu_torch.algorithms import PPO, build_algorithm, registered_algorithms
from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
from relayrl_tpu_torch.algorithms.ppo import PPOState, draw_minibatches, make_ppo_update
from relayrl_tpu_torch.algorithms.reinforce import make_optimizers
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.weights import params_to_jax
from tests.test_torch_reinforce import ACT, B, OBS, T, _arch, _batch, _leaves, _tree

PI_LR, VF_LR, GAMMA, LAM = 3e-4, 1e-3, 0.98, 0.95
CLIP, ENT, VF_COEF = 0.2, 0.01, 0.5
METRICS = ("LossPi", "DeltaLossPi", "LossV", "DeltaLossV", "KL", "Entropy",
           "ClipFrac", "StopIter", "AdvMean", "AdvStd")
F32_METRIC_RTOL, F32_METRIC_ATOL, F32_PARAM_ATOL = 1e-4, 1e-6, 1e-5
BF16_METRIC_TOL = 1e-2
ADAM_FLOOR = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mlp_arch(precision="float32"):
    return {"kind": "mlp_discrete", "obs_dim": OBS, "act_dim": ACT,
            "hidden_sizes": [16, 16], "activation": "tanh",
            "has_critic": True, "precision": precision}


def jax_index_sets(rng, batch_rows, train_iters, minibatch_count):
    """The JAX update's shuffles, drawn from its ``state.rng``."""
    _, *shuffle = jax.random.split(rng, train_iters + 1)
    mb_rows = batch_rows // minibatch_count
    return np.stack([
        np.asarray(jax.random.permutation(r, batch_rows))
        [: mb_rows * minibatch_count].reshape(minibatch_count, mb_rows)
        for r in shuffle]).reshape(train_iters * minibatch_count, mb_rows)


def _jax_update(arch, tree, batch, target_kl=10.0, train_iters=2,
                minibatch_count=2, freeze=()):
    policy = jax_build_policy(arch)
    # jaxlint: disable=JAX05 - one update on a tiny state; no donation
    update = jax.jit(jax_make_update(
        policy, PI_LR, VF_LR, CLIP, train_iters, minibatch_count, ENT,
        VF_COEF, target_kl, GAMMA, LAM, freeze))
    tx_pi, tx_vf = jax_make_optimizers(tree, PI_LR, VF_LR, freeze)
    rng = jax.random.PRNGKey(7)
    state = JaxState(params=tree, pi_opt_state=tx_pi.init(tree),
                     vf_opt_state=tx_vf.init(tree), rng=rng,
                     step=jnp.int32(0))
    new, metrics = update(state, {k: jnp.asarray(v) for k, v in batch.items()})
    idx = jax_index_sets(rng, batch["obs"].shape[0], train_iters,
                         minibatch_count)
    return (jax.tree.map(np.asarray, new.params),
            {k: float(v) for k, v in metrics.items()}, idx)


def _port_state(arch, tree, freeze=()):
    policy = build_policy(arch, device="cpu")
    params = policy.load_params(tree)
    state = PPOState(params, *make_optimizers(params, PI_LR, VF_LR, freeze),
                     rng=torch.Generator().manual_seed(0).get_state())
    return policy, state


def track_least_rms(opts):
    """Record each parameter's smallest bias-corrected RMS gradient
    sqrt(v_hat) over the optimizers' steps: ``{param: tensor}``."""
    least = {}

    def hook(opt, args, kwargs):
        beta2 = opt.param_groups[0]["betas"][1]
        for p, st in opt.state.items():
            rms = st["exp_avg_sq"].sqrt() / (1 - beta2 ** float(st["step"])) ** 0.5
            least[p] = torch.minimum(least[p], rms) if p in least else rms

    for opt in opts:
        if opt is not None:
            opt.register_step_post_hook(hook)
    return least


def _port_update(arch, tree, batch, idx, target_kl=10.0, freeze=()):
    policy, state = _port_state(arch, tree, freeze)
    least = track_least_rms((state.pi_opt, state.vf_opt))
    update = make_ppo_update(policy, CLIP, ENT, VF_COEF, target_kl, GAMMA, LAM)
    new, metrics = update(state, {k: torch.as_tensor(v) for k, v in batch.items()},
                          torch.as_tensor(idx))
    assert new.step == 1 and all(m.ndim == 0 for m in metrics.values())
    new.least_rms = least
    return new, read_metrics(metrics)


def _floored(state) -> dict:
    """The mask of the elements under Adam's floor, as a flax tree's
    leaves (the same layout conversion as the params)."""
    from relayrl_tpu_torch.weights import state_to_jax

    by_name = dict(state.params.named_parameters())
    masks = {}
    for key, value in state.params.state_dict().items():
        rms = state.least_rms.get(by_name.get(key))
        masks[key] = (torch.zeros_like(value) if rms is None
                      else (rms < ADAM_FLOOR).to(value.dtype))
    return {path: leaf > 0 for path, leaf in
            _leaves(state_to_jax(state.params, masks)).items()}


def _check_params(state, want, init, precision, pi_steps, vf_steps,
                  lrs=(PI_LR, VF_LR)):
    """f32: every leaf within atol 1e-5, except under Adam's floor (the
    module docstring), held to its optimizer's total step bound. bf16:
    each element within twice that bound, and the mean |difference|
    within 5% of the mean movement."""
    got = params_to_jax(state.params)
    floored = _floored(state)
    g, w, i = _leaves(got), _leaves(want), _leaves(init)
    assert g.keys() == w.keys()
    for path in g:
        assert g[path].dtype == w[path].dtype and g[path].shape == w[path].shape
        bound = vf_steps * lrs[1] if "vf_" in path else pi_steps * lrs[0]
        if precision == "bfloat16":
            np.testing.assert_array_less(np.abs(g[path] - w[path]), 2 * bound,
                                         err_msg=path)
        elif path.endswith("['qkv']['bias']"):
            d = g[path].shape[0] // 3
            for side in (g, w):
                np.testing.assert_array_less(
                    np.abs(side[path][d:2 * d] - i[path][d:2 * d]),
                    bound * (1 + 1e-3))
            for part in (slice(0, d), slice(2 * d, None)):
                np.testing.assert_allclose(g[path][part], w[path][part],
                                           atol=F32_PARAM_ATOL, rtol=0)
        else:
            tol = np.where(floored[path], bound * (1 + 1e-3), F32_PARAM_ATOL)
            np.testing.assert_array_less(np.abs(g[path] - w[path]), tol,
                                         err_msg=path)
    if precision == "bfloat16":
        diff = np.mean([np.abs(g[p] - w[p]).mean() for p in g])
        moved = np.mean([np.abs(w[p] - i[p]).mean() for p in g])
        assert diff <= 0.05 * moved


def _check_metrics(got, want, precision):
    assert set(got) == set(METRICS) == set(want)
    for key in METRICS:
        if precision == "float32":
            assert got[key] == pytest.approx(want[key], rel=F32_METRIC_RTOL,
                                             abs=F32_METRIC_ATOL), key
        else:
            assert got[key] == pytest.approx(want[key], rel=BF16_METRIC_TOL,
                                             abs=BF16_METRIC_TOL), key


@pytest.mark.parametrize("kind,precision", [
    ("transformer", "float32"), ("transformer", "bfloat16"),
    ("mlp", "float32")])
def test_update_matches_jax(kind, precision):
    arch = _arch(precision) if kind == "transformer" else _mlp_arch(precision)
    tree, batch = _tree(arch), _batch()
    want_params, want, idx = _jax_update(arch, tree, batch)
    assert idx.shape == (4, 2)
    new, got = _port_update(arch, tree, batch, idx)
    assert want["StopIter"] == got["StopIter"] == 0.0
    _check_metrics(got, want, precision)
    _check_params(new, want_params, tree, precision,
                  pi_steps=4, vf_steps=4)


def _pi_adam(opt):
    return [(s["step"].clone(), s["exp_avg"].clone(), s["exp_avg_sq"].clone())
            for s in (opt.state[p] for g in opt.param_groups
                      for p in g["params"])]


def test_kl_stop_matches_jax_and_freezes_after_first_minibatch():
    """target_kl = -1: every minibatch's KL exceeds 1.5 · target_kl, so
    the stop trips after minibatch 1, whose pi step still applies."""
    arch = _arch()
    tree, batch = _tree(arch), _batch(2)
    want_params, want, idx = _jax_update(arch, tree, batch, target_kl=-1.0)
    new, got = _port_update(arch, tree, batch, idx, target_kl=-1.0)
    assert want["StopIter"] == got["StopIter"] == 1.0
    _check_metrics(got, want, "float32")
    _check_params(new, want_params, tree, "float32",
                  pi_steps=1, vf_steps=4)
    first, _ = _port_update(arch, tree, batch, idx[:1], target_kl=-1.0)
    full_pi = {n: p for n, p in new.params.named_parameters()
               if not n.startswith("vf")}
    first_pi = dict(first.params.named_parameters())
    for name, param in full_pi.items():
        assert torch.equal(param, first_pi[name]), name
    for a, b in zip(_pi_adam(new.pi_opt), _pi_adam(first.pi_opt)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert float(a[0]) == 1.0
    vf_moved = [not torch.equal(p, first_pi[n])
                for n, p in new.params.named_parameters() if n.startswith("vf")]
    assert any(vf_moved)


def test_frozen_leaves_stay_bit_identical():
    arch = _arch()
    tree, batch = _tree(arch), _batch(1)
    freeze = ("params/(obs_embed|pos_embed|block_0)", "vf_head_up/bias$")
    want_params, _, idx = _jax_update(arch, tree, batch, freeze=freeze)
    new, _ = _port_update(arch, tree, batch, idx, freeze=freeze)
    got_params = params_to_jax(new.params)
    from relayrl_tpu.algorithms.freeze import freeze_info as jax_freeze_info

    frozen = jax_freeze_info(tree, freeze)["frozen_paths"]
    g, w, i = (jax.tree_util.tree_flatten_with_path(t)[0]
               for t in (got_params, want_params, tree))
    for (path, got), (_, want_leaf), (_, init) in zip(g, w, i):
        if "/".join(k.key for k in path) in frozen:
            assert np.array_equal(got, init) and np.array_equal(want_leaf, init)
    _check_params(new, want_params, tree, "float32", 4, 4)


def test_draw_minibatches_advances_and_covers_rows():
    rng = torch.Generator().manual_seed(3).get_state()
    idx, rng2 = draw_minibatches(rng, 8, 3, 4)
    assert idx.shape == (12, 2)
    for sweep in idx.reshape(3, 8):
        assert sorted(sweep.tolist()) == list(range(8))
    again, _ = draw_minibatches(rng, 8, 3, 4)
    assert torch.equal(idx, again) and not torch.equal(rng, rng2)


def test_registry_and_roundtrip(tmp_cwd):
    from relayrl_tpu_torch.types import ActionRecord

    assert "PPO" in registered_algorithms()
    with pytest.raises(ValueError):
        PPO(obs_dim=4, act_dim=2, traj_per_epoch=5, minibatch_count=2,
            env_dir=str(tmp_cwd), device="cpu")
    algo = build_algorithm("PPO", obs_dim=4, act_dim=2, traj_per_epoch=4,
                           minibatch_count=2, env_dir=str(tmp_cwd),
                           device="cpu")
    rng = np.random.default_rng(0)
    updated = False
    for _ in range(4):
        actions = [ActionRecord(obs=rng.standard_normal(4).astype(np.float32),
                                act=np.int32(rng.integers(2)),
                                mask=np.ones(2, np.float32), rew=1.0,
                                data={"logp_a": np.float32(-0.7),
                                      "v": np.float32(0.0)},
                                done=(i == 5))
                   for i in range(6)]
        updated = algo.receive_trajectory(actions) or updated
    assert updated and algo.version == 1
    assert algo.bundle().arch["kind"] == "mlp_discrete"


def test_ppo_learns_cartpole(tmp_cwd):
    """tests/test_ppo.py's learning check: the average return beats the
    random policy's ~22 by a clear margin within 12 epochs. The env's
    reset stream is seeded too (the runner resets it unseeded), so the
    run is the same every time."""
    from relayrl_tpu_torch.envs import CartPoleEnv
    from relayrl_tpu_torch.runtime.local_runner import LocalRunner

    env = CartPoleEnv()
    env.reset(seed=0)
    runner = LocalRunner(
        env, "PPO", env_dir=str(tmp_cwd), seed=0, device="cpu",
        traj_per_epoch=8, minibatch_count=2, train_iters=4,
        pi_lr=1e-2, vf_lr=1e-2, ent_coef=0.01, target_kl=0.05,
        hidden_sizes=[32, 32])
    result = runner.train(epochs=12, max_steps=200)
    assert result["avg_return_last_window"] > 40.0, result
