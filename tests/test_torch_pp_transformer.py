"""The port's pipeline transformer (``transformer_pp_discrete``) against the
JAX package's, on the CPU.

* The flax tree's ``blocks`` subtree stacks the layers on a leading axis;
  ``weights.py`` splits it into the port's ``blocks.0 .. blocks.{L-1}``
  and stacks them back: ``ModelBundle`` bytes equal both ways.
* ``evaluate``, ``step_window`` (its ``v``, and the log-prob of the action
  it drew) and ``mode``: f32 within 2e-5, bf16 within 3e-2.
* The same weights as ``transformer_discrete`` (its ``block_i`` trees
  stacked) give the same ``evaluate``, bit for bit, in the port; the JAX
  package's two families agree on them too.
* One REINFORCE update from the same params and batch, with
  ``tests/test_torch_reinforce.py``'s helpers and bars (read per layer).
* The port runs the layers in order (the JAX family's ``pp`` = 1 path):
  under a mesh with ``pp`` above 1 it refuses, as the sharded learner does
  (ROADMAP queue 1 item 11). Like the JAX family it has no KV cache, so a
  ``PolicyActor`` serves it through the window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu.types.model_bundle import ModelBundle as JaxModelBundle
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.parallel import make_mesh, make_sharded_update, use_mesh
from relayrl_tpu_torch.runtime import PolicyActor
from relayrl_tpu_torch.types import ModelBundle
from relayrl_tpu_torch.weights import params_to_jax
from tests.test_torch_reinforce import (
    ACT,
    BF16_METRIC_TOL,
    F32_METRIC_ATOL,
    F32_METRIC_RTOL,
    METRICS,
    OBS,
    T,
    _batch,
    _check_params,
    _jax_update,
    _port_update,
)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arch(precision="float32", kind="transformer_pp_discrete", n_layers=3):
    return {"kind": kind, "obs_dim": OBS, "act_dim": ACT, "d_model": 32,
            "n_layers": n_layers, "n_heads": 2, "max_seq_len": T,
            "attention": "flash", "has_critic": True, "precision": precision}


def _tree(arch, seed=0):
    return jax.tree.map(np.asarray,
                        jax_build_policy(arch).init_params(jax.random.PRNGKey(seed)))


def _stacked(tree, n_layers):
    """A ``transformer_discrete`` tree in the pipeline family's layout."""
    inner = dict(tree["params"])
    layers = [inner.pop(f"block_{i}") for i in range(n_layers)]
    inner["blocks"] = jax.tree.map(lambda *xs: np.stack(xs), *layers)
    return {"params": inner}


def _unstacked(tree):
    """A pipeline tree in ``transformer_discrete``'s layout (``block_i``)."""
    inner = dict(tree["params"])
    blocks = inner.pop("blocks")
    n = len(jax.tree.leaves(blocks)[0])
    for i in range(n):
        inner[f"block_{i}"] = jax.tree.map(lambda x, i=i: x[i], blocks)
    return {"params": inner}


def test_bundle_bytes_round_trip():
    arch = _arch()
    tree = _tree(arch)
    assert tree["params"]["blocks"]["qkv"]["kernel"].shape == (3, 32, 96)
    module = build_policy(arch, device="cpu").load_params(tree)
    assert len(module.blocks) == 3 and not hasattr(module, "block_0")
    np.testing.assert_array_equal(module.blocks[2].qkv.weight.detach().numpy(),
                                  tree["params"]["blocks"]["qkv"]["kernel"][2].T)
    back = params_to_jax(module)
    jax_bytes = JaxModelBundle(3, arch, tree).to_bytes()
    assert ModelBundle(3, arch, back).to_bytes() == jax_bytes
    assert JaxModelBundle.from_bytes(ModelBundle.from_bytes(jax_bytes).to_bytes(),
                                     params_template=JaxModelBundle.RAW_TREE
                                     ).to_bytes() == jax_bytes
    init = build_policy(arch, device="cpu").init_params(torch.Generator().manual_seed(0))
    assert (jax.tree.map(lambda a: (a.shape, a.dtype), params_to_jax(init))
            == jax.tree.map(lambda a: (a.shape, a.dtype), tree))


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_evaluate_step_window_mode_match_jax(precision):
    arch = _arch(precision)
    tree = _tree(arch)
    jax_policy = jax_build_policy(arch)
    policy = build_policy(arch, device="cpu")
    params = policy.load_params(tree)
    assert policy.init_cache is None and policy.step_cached is None
    tol = TOL[precision]
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((3, T, OBS)).astype(np.float32)
    act = rng.integers(0, ACT, (3, T))
    mask = np.ones((3, T, ACT), np.float32)
    mask[:, 1::2, 0] = 0.0
    want = jax_policy.evaluate(tree, jnp.asarray(obs), jnp.asarray(act), mask)
    with torch.no_grad():
        got = policy.evaluate(params, obs, act, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=0)
    window = np.zeros((T, OBS), np.float32)
    window[:7] = obs[1, :7]
    for t in (1, 7):
        with torch.no_grad():
            a, aux = policy.step_window(params, torch.Generator().manual_seed(t), window, t)
            greedy = policy.mode_window(params, window, t)
        logp, _, v = jax_policy.evaluate(tree, jnp.asarray(window[None]),
                                         jnp.full((1, T), int(a)))
        np.testing.assert_allclose(float(aux["logp_a"]), float(logp[0, t - 1]), atol=tol)
        np.testing.assert_allclose(float(aux["v"]), float(v[0, t - 1]), atol=tol)
        if precision == "float32":
            assert int(greedy) == int(jax_policy.mode_window(tree, jnp.asarray(window), t))
    windows = np.stack([window, np.zeros_like(window)])
    with torch.no_grad():  # stacked windows, one readout row each
        acts, auxs = policy.step_window(params, torch.Generator().manual_seed(0),
                                        windows, np.array([7, 1]))
    assert tuple(acts.shape) == (2,) and tuple(auxs["v"].shape) == (2,)


def test_stacked_equals_transformer_discrete():
    plain_arch = _arch(kind="transformer_discrete")
    pp_arch = _arch()
    plain_tree = _tree(plain_arch, seed=3)
    pp_tree = _stacked(plain_tree, 3)
    obs = np.random.default_rng(2).standard_normal((2, T, OBS)).astype(np.float32)
    act = np.random.default_rng(3).integers(0, ACT, (2, T))
    plain = build_policy(plain_arch, device="cpu")
    pp = build_policy(pp_arch, device="cpu")
    with torch.no_grad():
        a = plain.evaluate(plain.load_params(plain_tree), obs, act)
        b = pp.evaluate(pp.load_params(pp_tree), obs, act)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    ja = jax_build_policy(plain_arch).evaluate(plain_tree, jnp.asarray(obs), jnp.asarray(act))
    jb = jax_build_policy(pp_arch).evaluate(pp_tree, jnp.asarray(obs), jnp.asarray(act))
    for x, y, z in zip(ja, jb, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=2e-5)
        np.testing.assert_allclose(z.numpy(), np.asarray(y), atol=2e-5)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_reinforce_update_matches_jax(precision):
    arch = _arch(precision)
    tree, batch = _tree(arch), _batch()
    want_params, want = _jax_update(arch, tree, batch, True)
    got_params, got = _port_update(arch, tree, batch, True)
    assert set(got) == set(METRICS) == set(want)
    for key in METRICS:
        if precision == "float32":
            atol = F32_METRIC_ATOL if key == "AdvMean" else 0.0
            assert got[key] == pytest.approx(want[key], rel=F32_METRIC_RTOL, abs=atol), key
        else:
            assert got[key] == pytest.approx(want[key], rel=BF16_METRIC_TOL,
                                             abs=BF16_METRIC_TOL), key
    # The helper's qkv-bias rule reads one layer's [3 d] bias.
    _check_params(*map(_unstacked, (got_params, want_params, tree)), precision)


@pytest.mark.parametrize("patterns", [("blocks/qkv",), ("^params/blocks/", "vf_head"),
                                      ("no_such_leaf",)])
def test_freeze_info_matches_jax(patterns):
    """A pattern over the stacked ``blocks`` leaves freezes every layer's
    slice; the accounting equals the JAX package's."""
    from relayrl_tpu.algorithms.freeze import freeze_info as jax_freeze_info
    from relayrl_tpu_torch.algorithms.freeze import freeze_info

    arch = _arch()
    tree = _tree(arch)
    module = build_policy(arch, device="cpu").load_params(tree)
    assert freeze_info(module, patterns) == jax_freeze_info(tree, patterns)


def test_pp_mesh_refused():
    arch = _arch()
    policy = build_policy(arch, device="cpu")
    params = policy.load_params(_tree(arch))
    obs = np.zeros((1, 4, OBS), np.float32)
    with use_mesh(make_mesh({"pp": 2}, [CPU] * 2)):
        with pytest.raises(NotImplementedError, match="queue 1 item 11"):
            policy.evaluate(params, obs, np.zeros((1, 4)))
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        make_sharded_update(lambda s, b: (s, {}), make_mesh({"pp": 2}, [CPU] * 2), None)


def test_actor_serves_through_the_window():
    arch = _arch()
    tree = _tree(arch)
    actor = PolicyActor(ModelBundle(1, arch, tree), device="cpu")
    obs = np.random.default_rng(0).standard_normal((5, OBS)).astype(np.float32)
    for i, o in enumerate(obs):
        rec = actor.request_for_action(o, reward=0.1 * i)
        assert 0 <= int(rec.act) < ACT
    assert actor._cache is None
