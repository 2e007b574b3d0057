"""The port's MoE family (``models/moe.py``, ``transformer_moe_discrete``)
against the JAX package's, on the CPU.

* ``MoEMLP`` alone from the same flax params: the dense dispatch, and
  tied gates routed as ``jax.lax.top_k`` routes them (the lower expert
  index first); the expert stacks cross ``weights.py`` untransposed.
* The policy: ``evaluate``, ``step_window`` (its ``v``, and the log-prob of
  the action it drew) and ``mode``, f32 within 2e-5 and bf16 within 3e-2
  (the JAX flash tests' bars); routing is causal; ``expert_utilization``
  sums to 1 per layer and equals the JAX package's; the KV-cache decode
  gives the window path's values; ``ModelBundle`` bytes equal both ways.
* One REINFORCE update from the same params and batch, with
  ``tests/test_torch_reinforce.py``'s helpers and bars.
* Under a mesh with ``ep`` above 1 the layer refuses (ROADMAP queue 1
  item 11).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu.models.moe import MoEMLP as JaxMoEMLP
from relayrl_tpu.models.moe import expert_utilization as jax_expert_utilization
from relayrl_tpu.types.model_bundle import ModelBundle as JaxModelBundle
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.models.moe import MoEMLP, expert_utilization, top_k_stable
from relayrl_tpu_torch.parallel import make_mesh, use_mesh
from relayrl_tpu_torch.types import ModelBundle
from relayrl_tpu_torch.weights import params_from_jax, params_to_jax
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


def _arch(precision="float32", attention="flash", top_k=2):
    return {"kind": "transformer_moe_discrete", "obs_dim": OBS, "act_dim": ACT,
            "d_model": 32, "n_layers": 2, "n_heads": 2, "max_seq_len": T,
            "attention": attention, "moe_experts": 4, "moe_top_k": top_k,
            "has_critic": True, "precision": precision}


def _tree(arch, seed=0):
    return jax.tree.map(np.asarray,
                        jax_build_policy(arch).init_params(jax.random.PRNGKey(seed)))


def _pair(arch):
    tree = _tree(arch)
    policy = build_policy(arch, device="cpu")
    return tree, jax_build_policy(arch), policy, policy.load_params(tree)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
def _layer_pair(precision, gate_bias=None, top_k=2):
    dtype = {"float32": (jnp.float32, torch.float32),
             "bfloat16": (jnp.bfloat16, torch.bfloat16)}[precision]
    x = np.random.default_rng(0).standard_normal((2, 5, 16)).astype(np.float32)
    jax_layer = JaxMoEMLP(16, 32, 4, top_k, dtype[0])
    tree = jax.tree.map(np.asarray, jax_layer.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    if gate_bias is not None:
        gate = tree["params"]["moe_gate"]
        gate["kernel"] = np.zeros_like(gate["kernel"])
        gate["bias"] = np.asarray(gate_bias, np.float32)
    layer = MoEMLP(16, 32, 4, top_k, dtype[1])
    layer.load_state_dict(params_from_jax(tree))
    want = np.asarray(jax_layer.apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = layer(torch.as_tensor(x)).numpy()
    return tree, layer, got, want


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_layer_matches_jax(precision):
    tree, layer, got, want = _layer_pair(precision)
    np.testing.assert_allclose(got, want, atol=TOL[precision], rtol=0)
    w_up = tree["params"]["moe_w_up"]
    assert w_up.shape == (4, 16, 32)  # [E, d, ff], not transposed
    np.testing.assert_array_equal(layer.moe_w_up.detach().numpy(), w_up)
    np.testing.assert_array_equal(layer.moe_gate.weight.detach().numpy(),
                                  tree["params"]["moe_gate"]["kernel"].T)


@pytest.mark.parametrize("bias", [[0.0, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0],
                                  [0.0, 2.0, 2.0, 2.0]])
def test_tied_gates_route_as_lax_top_k(bias):
    """A zero gate kernel makes every token's gates its bias: ties among
    experts go to the lower index on both sides."""
    _, layer, got, want = _layer_pair("float32", gate_bias=bias)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    gate = torch.tensor([bias])
    _, idx = top_k_stable(gate, 2)
    _, want_idx = jax.lax.top_k(jnp.asarray([bias]), 2)
    assert idx.tolist() == np.asarray(want_idx).tolist()
    layer.capture_load = True
    with torch.no_grad():
        layer(torch.zeros(1, 3, 16))
    routed = set(np.flatnonzero(layer.expert_load.numpy()).tolist())
    assert routed == set(np.asarray(want_idx)[0].tolist())


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_evaluate_step_window_mode_match_jax(precision):
    arch = _arch(precision)
    tree, jax_policy, policy, params = _pair(arch)
    tol = TOL[precision]
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((3, T, OBS)).astype(np.float32)
    act = rng.integers(0, ACT, (3, T))
    mask = np.ones((3, T, ACT), np.float32)
    mask[:, ::2, 2] = 0.0
    want = jax_policy.evaluate(tree, jnp.asarray(obs), jnp.asarray(act), mask)
    with torch.no_grad():
        got = policy.evaluate(params, obs, act, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=0)
    window = np.zeros((T, OBS), np.float32)
    window[:6] = obs[0, :6]
    for t in (1, 6):
        with torch.no_grad():
            a, aux = policy.step_window(params, torch.Generator().manual_seed(t), window, t)
            greedy = policy.mode_window(params, window, t)
        logp, _, v = jax_policy.evaluate(tree, jnp.asarray(window[None]),
                                         jnp.full((1, T), int(a)))
        np.testing.assert_allclose(float(aux["logp_a"]), float(logp[0, t - 1]), atol=tol)
        np.testing.assert_allclose(float(aux["v"]), float(v[0, t - 1]), atol=tol)
        if precision == "float32":
            assert int(greedy) == int(jax_policy.mode_window(tree, jnp.asarray(window), t))
    with torch.no_grad():
        greedy = policy.mode(params, obs).numpy()
    if precision == "float32":
        np.testing.assert_array_equal(greedy, np.asarray(jax_policy.mode(tree, jnp.asarray(obs))))


def test_routing_is_causal():
    arch = _arch()
    _, _, policy, params = _pair(arch)
    rng = np.random.default_rng(2)
    obs = rng.standard_normal((2, T, OBS)).astype(np.float32)
    later = obs.copy()
    later[:, 9:] = rng.standard_normal((2, T - 9, OBS))
    act = np.zeros((2, T), np.int64)
    with torch.no_grad():
        a = policy.evaluate(params, obs, act)
        b = policy.evaluate(params, later, act)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x[:, :9].numpy(), y[:, :9].numpy(), atol=1e-6, rtol=0)
        assert not np.allclose(x[:, 9:].numpy(), y[:, 9:].numpy())


def test_expert_utilization_matches_jax():
    arch = _arch(attention="dense")
    tree, _, _, params = _pair(arch)
    obs = np.random.default_rng(3).standard_normal((2, T, OBS)).astype(np.float32)
    got = expert_utilization(arch, params, obs)
    want = jax_expert_utilization(arch, tree, jnp.asarray(obs))
    assert sorted(got) == sorted(want) == ["block_0", "block_1"]
    for layer in got:
        assert float(got[layer].sum()) == pytest.approx(1.0, abs=1e-6)
        np.testing.assert_allclose(got[layer].numpy(), np.asarray(want[layer]), atol=2e-5)
    assert all(b.moe.expert_load is None and not b.moe.capture_load
               for b in params.layers())


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_cached_decode_matches_window(precision):
    arch = _arch(precision)
    _, _, policy, params = _pair(arch)
    tol = TOL[precision]
    obs = np.random.default_rng(4).standard_normal((T, OBS)).astype(np.float32)
    window = np.zeros((T, OBS), np.float32)
    cache = policy.init_cache(T, 1)
    with torch.no_grad():
        for t in range(10):
            window[t] = obs[t]
            gen = torch.Generator().manual_seed(t)
            a_c, aux_c, cache = policy.step_cached(params, gen, cache, obs[t], t)
            logits, v, _ = _window(policy, params, window, t + 1)
            np.testing.assert_allclose(float(aux_c["v"]), float(v), atol=tol)
            np.testing.assert_allclose(
                float(aux_c["logp_a"]),
                float(torch.log_softmax(logits, -1)[int(a_c)]), atol=tol)
        rebuilt = policy.prefill_cache(params, policy.init_cache(T, 1), window)
    for (k1, v1), (k2, v2) in zip(cache, rebuilt):
        np.testing.assert_allclose(k1[:, :10].float().numpy(), k2[:, :10].float().numpy(),
                                   atol=tol)


def _window(policy, params, window, t):
    idx = torch.tensor([t - 1])
    logits, v = params(torch.as_tensor(window)[None], None, readout_t=idx)
    return logits[0], v[0], idx


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
    _check_params(got_params, want_params, tree, precision)


def test_bundle_bytes_round_trip():
    arch = _arch()
    tree = _tree(arch)
    back = params_to_jax(build_policy(arch, device="cpu").load_params(tree))
    jax_bytes = JaxModelBundle(3, arch, tree).to_bytes()
    assert ModelBundle(3, arch, back).to_bytes() == jax_bytes
    assert JaxModelBundle.from_bytes(ModelBundle.from_bytes(jax_bytes).to_bytes(),
                                     params_template=JaxModelBundle.RAW_TREE
                                     ).to_bytes() == jax_bytes
    init = build_policy(arch, device="cpu").init_params(torch.Generator().manual_seed(0))
    assert (jax.tree.map(lambda a: (a.shape, a.dtype), params_to_jax(init))
            == jax.tree.map(lambda a: (a.shape, a.dtype), tree))
    w = init.block_0.moe.moe_w_up.detach()
    assert abs(float(w.std()) * 32 ** 0.5 - 1.0) < 0.1  # fan-in d, not E * d


def test_ep_mesh_refused():
    arch = _arch()
    _, _, policy, params = _pair(arch)
    obs = np.zeros((1, 4, OBS), np.float32)
    with use_mesh(make_mesh({"ep": 2}, [CPU] * 2)):
        with pytest.raises(NotImplementedError, match="queue 1 item 11"):
            policy.evaluate(params, obs, np.zeros((1, 4)))
    with use_mesh(make_mesh({"ep": 1}, [CPU])), torch.no_grad():
        assert policy.evaluate(params, obs, np.zeros((1, 4)))[0].shape == (1, 4)
