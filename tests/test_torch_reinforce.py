"""The learner slice: the port's REINFORCE against the JAX package's.

* One epoch update, JAX ``make_reinforce_update`` against the port's, from
  the same params (carried with ``params_from_jax``), fresh optimizer
  state on both sides, and the same padded batch.
* ``learner.freeze``: frozen leaves stay bit-identical, and ``freeze_info``
  equals the JAX function's.
* ``EpochBuffer`` drains of the same ``ActionRecord`` episodes are equal.
* The loop on ``device="cpu"``: port actors ship episodes to the port
  learner, whose bundle loads into the JAX package and into the port
  actor.

Sizes: d_model 32, 2 layers, 2 heads, T 16, B 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.algorithms.freeze import freeze_info as jax_freeze_info
from relayrl_tpu.algorithms.reinforce import ReinforceState as JaxState
from relayrl_tpu.algorithms.reinforce import make_optimizers as jax_make_optimizers
from relayrl_tpu.algorithms.reinforce import make_reinforce_update as jax_make_update
from relayrl_tpu.data import EpochBuffer as JaxEpochBuffer
from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu.types.action import ActionRecord as JaxActionRecord
from relayrl_tpu.types.model_bundle import ModelBundle as JaxModelBundle
from relayrl_tpu_torch.algorithms import REINFORCE, build_algorithm, registered_algorithms
from relayrl_tpu_torch.algorithms.freeze import freeze_info
from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
from relayrl_tpu_torch.algorithms.reinforce import (
    ReinforceState,
    make_optimizers,
    make_reinforce_update,
)
from relayrl_tpu_torch.data import EpochBuffer
from relayrl_tpu_torch.envs import RecallEnv, SyncVectorEnv
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.runtime import VectorActorHost
from relayrl_tpu_torch.runtime.vector_actor import run_vector_gym_loop
from relayrl_tpu_torch.types import ActionRecord, ModelBundle, deserialize_actions
from relayrl_tpu_torch.weights import params_to_jax

B, T, OBS, ACT = 4, 16, 4, 3
PI_LR, VF_LR, GAMMA, LAM, VF_ITERS = 3e-4, 1e-3, 0.98, 0.97, 3
METRICS = ("LossPi", "DeltaLossPi", "KL", "Entropy", "LossV", "DeltaLossV",
           "AdvMean", "AdvStd")
# f32: the same arithmetic in another order. Metrics at rtol 1e-4 (atol
# 1e-6 for AdvMean, which is ~0 by construction); params at atol 1e-5.
# bf16: the trunk's matmuls round to bf16 at places that differ between
# XLA and torch, so metrics are held at 1e-2; params see the note in
# _check_params.
F32_METRIC_RTOL, F32_METRIC_ATOL, F32_PARAM_ATOL = 1e-4, 1e-6, 1e-5
BF16_METRIC_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this module from crowding the other test workers' CPUs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arch(precision="float32", has_critic=True):
    return {"kind": "transformer_discrete", "obs_dim": OBS, "act_dim": ACT,
            "d_model": 32, "n_layers": 2, "n_heads": 2, "max_seq_len": T,
            "attention": "flash", "has_critic": has_critic,
            "precision": precision}


def _tree(arch, seed=0):
    return jax.tree.map(np.asarray,
                        jax_build_policy(arch).init_params(jax.random.PRNGKey(seed)))


def _batch(seed=0):
    """A padded epoch batch: ragged lengths, a nonzero bootstrap on the
    truncated rows, action 2 illegal every third step."""
    rng = np.random.default_rng(seed)
    valid = (np.arange(T)[None] < np.array([[16], [9], [5], [1]])).astype(np.float32)
    mask = np.repeat(valid[..., None], ACT, -1)
    mask[:, ::3, 2] = 0.0
    return {
        "obs": rng.standard_normal((B, T, OBS)).astype(np.float32) * valid[..., None],
        "act": (rng.integers(0, 2, (B, T)) * valid).astype(np.int32),
        "act_mask": mask,
        "rew": rng.standard_normal((B, T)).astype(np.float32) * valid,
        "val": rng.standard_normal((B, T)).astype(np.float32) * valid,
        "logp": -rng.random((B, T)).astype(np.float32) * valid,
        "valid": valid,
        "last_val": np.array([0.0, 0.5, -0.3, 0.0], np.float32),
    }


def _jax_update(arch, tree, batch, with_baseline, freeze=()):
    policy = jax_build_policy(arch)
    # jaxlint: disable=JAX05 - one update on a tiny state; no donation
    update = jax.jit(jax_make_update(policy, PI_LR, VF_LR, VF_ITERS, GAMMA,
                                     LAM, with_baseline, freeze))
    tx_pi, tx_vf = jax_make_optimizers(tree, PI_LR, VF_LR, freeze)
    state = JaxState(params=tree, pi_opt_state=tx_pi.init(tree),
                     vf_opt_state=tx_vf.init(tree), rng=jax.random.PRNGKey(0),
                     step=jnp.int32(0))
    new, metrics = update(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, new.params),
            {k: float(v) for k, v in metrics.items()})


def _port_update(arch, tree, batch, with_baseline, freeze=()):
    policy = build_policy(arch, device="cpu")
    params = policy.load_params(tree)
    state = ReinforceState(params, *make_optimizers(params, PI_LR, VF_LR, freeze))
    update = make_reinforce_update(policy, VF_ITERS, GAMMA, LAM, with_baseline)
    new, metrics = update(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert new.step == 1 and all(m.ndim == 0 for m in metrics.values())
    return params_to_jax(new.params), read_metrics(metrics)


def _leaves(tree):
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_params(got, want, init, precision):
    """f32: every leaf within atol 1e-5, except the key third of each qkv
    bias. Its gradient is zero in exact arithmetic (a softmax does not
    change when one constant is added to all of a query's scores), so both
    sides take Adam's normalized step on rounding noise: each is held to
    Adam's step bound, ``pi_lr`` for the one policy step.

    bf16: Adam's normalized step turns a small gradient that bf16 rounds
    differently into a step of up to ``lr`` either way, so each element is
    held to twice its optimizer's total step bound (``pi_lr``, or
    ``VF_ITERS * vf_lr`` for the value head), and the mean |difference| to
    5% of the mean movement of the parameters."""
    g, w, i = _leaves(got), _leaves(want), _leaves(init)
    assert g.keys() == w.keys()
    for path in g:
        assert g[path].dtype == w[path].dtype and g[path].shape == w[path].shape
        bound = VF_ITERS * VF_LR if "vf_head" in path else PI_LR
        if precision == "bfloat16":
            np.testing.assert_array_less(np.abs(g[path] - w[path]), 2 * bound,
                                         err_msg=path)
        elif path.endswith("['qkv']['bias']"):
            d = g[path].shape[0] // 3
            key = slice(d, 2 * d)
            for side in (g, w):
                np.testing.assert_array_less(
                    np.abs(side[path][key] - i[path][key]), bound * (1 + 1e-3))
            for part in (slice(0, d), slice(2 * d, None)):
                np.testing.assert_allclose(g[path][part], w[path][part],
                                           atol=F32_PARAM_ATOL, rtol=0)
        else:
            np.testing.assert_allclose(g[path], w[path], atol=F32_PARAM_ATOL,
                                       rtol=0, err_msg=path)
    if precision == "bfloat16":
        diff = np.mean([np.abs(g[p] - w[p]).mean() for p in g])
        moved = np.mean([np.abs(w[p] - i[p]).mean() for p in g])
        assert diff <= 0.05 * moved


@pytest.mark.parametrize("precision,with_baseline", [
    ("float32", True), ("float32", False), ("bfloat16", True)])
def test_update_matches_jax(precision, with_baseline):
    arch = _arch(precision, has_critic=with_baseline)
    tree, batch = _tree(arch), _batch()
    want_params, want = _jax_update(arch, tree, batch, with_baseline)
    got_params, got = _port_update(arch, tree, batch, with_baseline)
    assert set(got) == set(METRICS) == set(want)
    for key in METRICS:
        if precision == "float32":
            atol = F32_METRIC_ATOL if key == "AdvMean" else 0.0
            assert got[key] == pytest.approx(want[key], rel=F32_METRIC_RTOL,
                                             abs=atol), key
        else:
            assert got[key] == pytest.approx(want[key], rel=BF16_METRIC_TOL,
                                             abs=BF16_METRIC_TOL), key
    if not with_baseline:
        assert got["LossV"] == got["DeltaLossV"] == 0.0
    _check_params(got_params, want_params, tree, precision)


def test_frozen_leaves_stay_bit_identical():
    arch = _arch()
    tree, batch = _tree(arch), _batch(1)
    freeze = ("params/(obs_embed|pos_embed|block_0)", "vf_head_up/bias$")
    want_params, _ = _jax_update(arch, tree, batch, True, freeze)
    got_params, _ = _port_update(arch, tree, batch, True, freeze)
    frozen = jax_freeze_info(tree, freeze)["frozen_paths"]
    assert len(frozen) == 16  # 12 in block_0, 2 + 1 embeddings, 1 bias
    g, w, i = (jax.tree_util.tree_flatten_with_path(t)[0]
               for t in (got_params, want_params, tree))
    for (path, got), (_, want), (_, init) in zip(g, w, i):
        if "/".join(k.key for k in path) in frozen:
            assert np.array_equal(got, init) and np.array_equal(want, init), path
        else:
            assert not np.array_equal(want, init), path
    _check_params(got_params, want_params, tree, "float32")


@pytest.mark.parametrize("patterns", [
    ("block_0/qkv",),
    ("^params/vf_head", "ln_final/scale$"),
    ("params/(obs_embed|pos_embed|block_[01])/",),
    ("no_such_leaf",),
])
def test_freeze_info_matches_jax(patterns):
    arch = _arch()
    tree = _tree(arch)
    module = build_policy(arch, device="cpu").load_params(tree)
    assert freeze_info(module, patterns) == jax_freeze_info(tree, patterns)


def _records(cls, n_steps, seed, *, marker=True, truncated=False, nan=False):
    """One episode as ActionRecords of package ``cls``: steps with aux
    ``v``/``logp_a``, then a terminal marker (or the done flag on the last
    step)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_steps):
        last = t == n_steps - 1 and not marker
        out.append(cls(obs=rng.standard_normal(OBS).astype(np.float32),
                       act=np.int32(rng.integers(ACT)),
                       mask=np.ones(ACT, np.float32),
                       rew=float("nan") if nan and t == 1 else float(rng.random()),
                       data={"v": np.float32(rng.standard_normal()),
                             "logp_a": np.float32(-rng.random())},
                       done=last, truncated=last and truncated))
    if marker:
        out.append(cls(obs=rng.standard_normal(OBS).astype(np.float32) if truncated
                       else None, rew=1.5, done=True, truncated=truncated))
    return out


@pytest.mark.parametrize("buckets", [(8, 16), (16,), (4,)])
def test_epoch_buffer_drains_match_jax(buckets):
    """Three epochs of two episodes each (lengths below, at and above the
    buckets; markers, truncation, done on the last step) drain to equal
    batches in both packages."""
    episodes = [dict(n_steps=5, seed=0), dict(n_steps=7, seed=1, truncated=True),
                dict(n_steps=16, seed=2, marker=False),
                dict(n_steps=3, seed=3, marker=False, truncated=True),
                dict(n_steps=20, seed=4), dict(n_steps=1, seed=5)]
    ours = EpochBuffer(OBS, ACT, traj_per_epoch=2, buckets=buckets)
    theirs = JaxEpochBuffer(OBS, ACT, traj_per_epoch=2, buckets=buckets)
    drained = 0
    for ep in episodes:
        ready = ours.add_episode(_records(ActionRecord, **ep))
        assert ready == theirs.add_episode(_records(JaxActionRecord, **ep))
        if ready:
            got, want = ours.drain().as_dict(), theirs.drain().as_dict()
            assert got.keys() == want.keys()
            for key in got:
                assert got[key].dtype == want[key].dtype
                assert np.array_equal(got[key], want[key]), key
            drained += 1
    assert drained == 3
    assert ours.pop_episode_stats() == theirs.pop_episode_stats()


def test_epoch_buffer_refuses_anything_but_records():
    buf = EpochBuffer(OBS, ACT, traj_per_epoch=2)
    for item in ({"o": np.zeros((3, OBS))}, b"frame", [{"obs": None}]):
        with pytest.raises(TypeError, match="ActionRecord"):
            buf.add_episode(item)
    assert len(buf) == 0


def _algo(tmp_path, **overrides):
    kwargs = dict(obs_dim=OBS, act_dim=ACT, model_kind="transformer_discrete",
                  d_model=32, n_layers=2, n_heads=2, max_seq_len=T,
                  attention="flash", with_vf_baseline=True, traj_per_epoch=2,
                  train_vf_iters=2, bucket_lengths=[T], seed_salt=0,
                  env_dir=str(tmp_path), device="cpu")
    kwargs.update(overrides)
    return build_algorithm("REINFORCE", **kwargs)


def test_registry_and_ctor(tmp_cwd):
    assert "REINFORCE" in registered_algorithms()
    algo = _algo(tmp_cwd)
    assert isinstance(algo, REINFORCE) and algo.version == 0
    assert (algo.gamma, algo.lam, algo.with_baseline) == (0.98, 0.97, True)
    assert algo.arch["has_critic"] and algo.arch["d_model"] == 32
    assert algo.buffer.buckets == (T,)
    # The same seed and salt draw the same weights.
    again = _algo(tmp_cwd)
    for a, b in zip(algo.state.params.parameters(), again.state.params.parameters()):
        assert torch.equal(a, b)


def test_learner_needs_a_device_without_cuda(tmp_cwd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _algo(tmp_cwd, device=None)


def test_nonfinite_episode_is_dropped(tmp_cwd):
    algo = _algo(tmp_cwd)
    assert not algo.receive_trajectory(_records(ActionRecord, 5, 0, nan=True))
    assert algo.dropped_nonfinite == 1 and len(algo.buffer) == 0
    assert not algo.receive_trajectory([ActionRecord(rew=0.0, done=True)])
    assert len(algo.buffer) == 0


def test_loop_actor_learner_bundle(tmp_cwd):
    """Port actors -> episodes -> port learner -> bundle: the bundle's
    bytes load into the JAX package, whose policy gives the port policy's
    outputs on the trained weights, and the port actor swaps to it."""
    horizon, lanes = 7, 2  # 7 steps + the done marker fit the 16 bucket
    env = RecallEnv(horizon, ACT)
    algo = _algo(tmp_cwd, obs_dim=env.observation_space.shape[0])
    host = VectorActorHost(algo.bundle(), lanes, device="cpu",
                           on_send=lambda lane, payload: sent.append(payload))
    venv = SyncVectorEnv([lambda: RecallEnv(horizon, ACT)] * lanes)
    for wave in range(2):
        sent = []
        run_vector_gym_loop(host, venv, horizon, seed=wave)
        assert len(sent) == lanes
        updated = [algo.receive_trajectory(deserialize_actions(p)) for p in sent]
        assert updated == [False, True]
        assert host.maybe_swap(algo.bundle())
    assert algo.version == host.version == 2 and algo.epoch == 2
    progress = (tmp_cwd / "logs").rglob("progress.txt")
    header = next(progress).read_text().splitlines()[0].split("\t")
    assert {"LossPi", "KL", "LossV", "DeltaLossV"} <= set(header)

    bundle = algo.bundle()
    jax_policy = jax_build_policy(bundle.arch)
    template = jax_policy.init_params(jax.random.PRNGKey(0))
    loaded = JaxModelBundle.from_bytes(bundle.to_bytes(), template)
    assert loaded.version == 2 and loaded.arch == bundle.arch
    obs = np.random.default_rng(7).standard_normal(
        (2, T, algo.obs_dim)).astype(np.float32)
    act = np.zeros((2, T), np.int32)
    with torch.no_grad():
        got = algo.policy.evaluate(algo.state.params, obs, act)
    for g, w in zip(got, jax_policy.evaluate(loaded.params, obs, act)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5)
    assert ModelBundle.from_bytes(bundle.to_bytes()).version == 2
