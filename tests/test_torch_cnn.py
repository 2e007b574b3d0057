"""The port's CNN family (``cnn_discrete``, the pixel q-trunk) against the JAX
package's, on the CPU.

* ``evaluate``, ``step`` and ``mode`` from the same flax params on the
  same frames (uint8 and float wire vectors, flat and time-batched), the
  Nature trunk and a narrow one: f32 within 2e-5, bf16 within 3e-2 (the
  JAX flash tests' bars). ``step`` samples from another stream, so its
  ``v`` and the log-prob of the action it drew are held to the JAX
  package's.
* Conv kernels cross ``weights.py`` as ``[kh, kw, in, out]`` <->
  ``[out, in, kh, kw]``, and ``trunk_dense`` reads the features in flax's
  NHWC order: ``ModelBundle`` bytes equal both ways.
* One PPO update (``tests/test_torch_ppo.py``'s helpers and bars: metrics
  rtol 1e-4, params atol 1e-5 with the Adam-floor rule) on a pixel batch;
  the pi/vf Adam partition moves the same leaves as the JAX package's.
* One pixel DQN update on a uint8 ring from the same params and batch
  (``tests/test_torch_offpolicy.py``'s bars), C51's pixel q-net forward,
  and ``tests/test_offpolicy.py``'s uint8-ring training case.
* The presets, the refusals and the override warning.
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.algorithms import build_algorithm as jax_build_algorithm
from relayrl_tpu.algorithms.reinforce import _param_labels as jax_param_labels
from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu.types.action import ActionRecord as JaxActionRecord
from relayrl_tpu.types.model_bundle import ModelBundle as JaxModelBundle
from relayrl_tpu_torch.algorithms import build_algorithm
from relayrl_tpu_torch.algorithms.reinforce import make_optimizers
from relayrl_tpu_torch.models import apply_arch_overrides, build_policy
from relayrl_tpu_torch.models.cnn import (
    NATURE_CONV,
    TPU_CONV,
    resolve_conv_spec,
)
from relayrl_tpu_torch.models.q_networks import conv_trunk_kwargs
from relayrl_tpu_torch.types import ActionRecord, ModelBundle
from relayrl_tpu_torch.weights import params_from_jax, params_to_jax
from tests.test_torch_ppo import _check_metrics, _check_params
from tests.test_torch_ppo import _jax_update as ppo_jax_update
from tests.test_torch_ppo import _port_update as ppo_port_update
from tests.test_torch_reinforce import B, T, _batch

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SHAPE = [36, 36, 2]
FLAT = 36 * 36 * 2
NARROW = [[4, 8, 4], [8, 4, 2]]
PARAM_ATOL, METRIC_RTOL, METRIC_ATOL, ADAM_FLOOR = 1e-5, 1e-4, 1e-6, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arch(precision="float32", conv_spec=None, dense=32):
    arch = {"kind": "cnn_discrete", "obs_shape": SHAPE, "act_dim": 3,
            "dense": dense, "has_critic": True, "precision": precision}
    if conv_spec is not None:
        arch["conv_spec"] = conv_spec
    return arch


def _tree(arch, seed=0):
    return jax.tree.map(np.asarray,
                        jax_build_policy(arch).init_params(jax.random.PRNGKey(seed)))


def _frames(shape, dtype, seed=0):
    frames = np.random.default_rng(seed).integers(0, 256, shape + (FLAT,))
    return frames.astype(dtype)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("conv_spec", [None, NARROW, "tpu"])
def test_evaluate_step_mode_match_jax(precision, conv_spec):
    arch = _arch(precision, conv_spec)
    tree = _tree(arch)
    jax_policy = jax_build_policy(arch)
    policy = build_policy(arch, device="cpu")
    params = policy.load_params(tree)
    assert policy.input_dim == FLAT
    tol = TOL[precision]
    rng = np.random.default_rng(1)
    mask = np.ones((5, 3), np.float32)
    mask[::2, 2] = 0.0
    for shape, obs_dtype in (((5,), np.uint8), ((2, 3), np.float32)):
        obs = _frames(shape, obs_dtype)
        act = rng.integers(0, 2, shape)
        m = None if len(shape) == 2 else mask
        want = jax_policy.evaluate(tree, jnp.asarray(obs), jnp.asarray(act), m)
        with torch.no_grad():
            got = policy.evaluate(params, obs, act, m)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape == shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=0)
    obs = _frames((5,), np.uint8, seed=2)
    with torch.no_grad():
        greedy = policy.mode(params, obs, mask).numpy()
        act, aux = policy.step(params, torch.Generator().manual_seed(0), obs, mask)
    want_logp, want_v = jax_policy.evaluate(tree, jnp.asarray(obs),
                                              jnp.asarray(act.numpy()), mask)[::2]
    np.testing.assert_allclose(aux["logp_a"].numpy(), np.asarray(want_logp), atol=tol)
    np.testing.assert_allclose(aux["v"].numpy(), np.asarray(want_v), atol=tol)
    assert (act.numpy()[::2] != 2).all()
    want_mode = np.asarray(jax_policy.mode(tree, jnp.asarray(obs), mask))
    if precision == "float32":
        np.testing.assert_array_equal(greedy, want_mode)
    with torch.no_grad():
        single = policy.step(params, torch.Generator().manual_seed(0), obs[0])
    assert single[0].shape == () and single[1]["v"].shape == ()


@pytest.mark.parametrize("conv_spec", [None, NARROW])
def test_bundle_bytes_round_trip(conv_spec):
    arch = _arch(conv_spec=conv_spec)
    tree = _tree(arch)
    module = build_policy(arch, device="cpu").load_params(tree)
    assert tuple(module.trunk.conv_0.weight.shape) == (
        (conv_spec or NATURE_CONV)[0][0], 2, 8, 8)
    np.testing.assert_array_equal(  # [kh, kw, in, out] -> [out, in, kh, kw]
        module.trunk.conv_0.weight.detach().numpy()[3, 1, 5, 2],
        tree["params"]["trunk"]["conv_0"]["kernel"][5, 2, 1, 3])
    back = params_to_jax(module)
    jax_bytes = JaxModelBundle(3, arch, tree).to_bytes()
    assert ModelBundle(3, arch, back).to_bytes() == jax_bytes
    assert JaxModelBundle.from_bytes(ModelBundle.from_bytes(jax_bytes).to_bytes(),
                                     params_template=JaxModelBundle.RAW_TREE
                                     ).to_bytes() == jax_bytes


def test_init_params_layout_matches_jax():
    arch = _arch()
    module = build_policy(arch, device="cpu").init_params(torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda a: (a.shape, a.dtype), params_to_jax(module))
    want = jax.tree.map(lambda a: (a.shape, a.dtype), _tree(arch))
    assert got == want
    w = module.trunk.conv_1.weight.detach()
    fan_in = 32 * 4 * 4
    assert abs(float(w.std()) * math.sqrt(fan_in) - 1.0) < 0.1  # lecun over kh*kw*in
    assert not module.trunk.conv_1.bias.detach().any()


def _pixel_batch(seed=0):
    batch = _batch(seed)
    valid = batch["valid"]
    batch["obs"] = (_frames((B, T), np.float32, seed) * valid[..., None]).astype(np.float32)
    batch["act_mask"] = np.ones((B, T, 3), np.float32) * valid[..., None]
    return batch


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_ppo_update_matches_jax(precision):
    arch = _arch(precision, NARROW, dense=16)
    tree, batch = _tree(arch), _pixel_batch()
    want_params, want, idx = ppo_jax_update(arch, tree, batch)
    new, got = ppo_port_update(arch, tree, batch, idx)
    assert want["StopIter"] == got["StopIter"] == 0.0
    _check_metrics(got, want, precision)
    _check_params(new, want_params, tree, precision, pi_steps=4, vf_steps=4)


def test_pi_vf_partition_matches_jax():
    """The shared trunk and the policy head are the pi Adam's, the value
    head the vf Adam's, as the JAX labels (``vf*`` names) give them."""
    arch = _arch()
    tree = _tree(arch)
    module = build_policy(arch, device="cpu").load_params(tree)
    pi_opt, vf_opt = make_optimizers(module, 1e-3, 1e-3)
    names = {id(p): n for n, p in module.named_parameters()}
    ours = {names[id(p)]: label for label, opt in (("pi", pi_opt), ("vf", vf_opt))
            for p in opt.param_groups[0]["params"]}
    jax_labels = jax.tree_util.tree_flatten_with_path(jax_param_labels(tree))[0]
    want = {}
    for path, label in jax_labels:
        keys = [k.key for k in path[1:]]
        name = ".".join(keys[:-1] + ["weight" if keys[-1] in ("kernel", "scale")
                                     else keys[-1]])
        want[name] = label
    assert ours == want
    assert {n for n, lab in ours.items() if lab == "vf"} == {"vf_head.weight", "vf_head.bias"}


# ---------------------------------------------------------------------------
# the pixel q-trunk
# ---------------------------------------------------------------------------
DQN_HP = dict(act_dim=3, obs_shape=SHAPE, conv_spec=NARROW, dense=16,
              obs_dtype="uint8", batch_size=16, update_after=0, buf_size=200,
              gamma=0.9, polyak=0.9, seed=3, seed_salt=0, lr=1e-3, double_q=True)


def _byte_episodes(n_eps=4, length=12, cls=ActionRecord):
    out = []
    for s in range(n_eps):
        rng = np.random.default_rng(s)
        out.append([cls(obs=rng.integers(0, 256, FLAT, dtype=np.uint8),
                        act=np.int32(rng.integers(3)), mask=np.ones(3, np.float32),
                        rew=float(rng.standard_normal()), done=(i == length - 1))
                    for i in range(length)])
    return out


def _least_rms(opt):
    least = {}

    def hook(o, args, kwargs):
        beta2 = o.param_groups[0]["betas"][1]
        for p, st in o.state.items():
            rms = st["exp_avg_sq"].sqrt() / math.sqrt(1 - beta2 ** float(st["step"]))
            least[p] = torch.minimum(least[p], rms) if p in least else rms

    opt.register_step_post_hook(hook)
    return least


@pytest.mark.parametrize("name", ["DQN", "C51"])
def test_pixel_q_update_matches_jax(name, tmp_cwd):
    hp = dict(DQN_HP, obs_dim=FLAT)
    if name == "C51":
        hp.pop("double_q")
        hp.update(n_atoms=11, v_min=-3.0, v_max=3.0)
    ref = jax_build_algorithm(name, env_dir=str(tmp_cwd),
                              logger_kwargs={"output_dir": str(tmp_cwd / "jax")}, **hp)
    port = build_algorithm(name, env_dir=str(tmp_cwd), device="cpu",
                           logger_kwargs={"output_dir": str(tmp_cwd / "port")}, **hp)
    assert port.arch["obs_shape"] == SHAPE and port.buffer.obs.dtype == np.uint8
    for ep, jax_ep in zip(_byte_episodes(), _byte_episodes(cls=JaxActionRecord)):
        port.buffer.add_episode(ep)
        ref.buffer.add_episode(jax_ep)
    trees = {"params": jax.tree.map(np.asarray, ref.state.params)}
    rng = np.random.default_rng(9)
    trees["target_params"] = jax.tree.map(
        lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(x.dtype),
        trees["params"])
    ref.state = ref.state.replace(target_params=jax.tree.map(jnp.asarray,
                                                             trees["target_params"]))
    state = port.fresh_state({k: port.load_module(k, t) for k, t in trees.items()})
    least = _least_rms(state.opt)
    batch, port_batch = ref.buffer.sample(16), port.buffer.sample(16)
    for key in batch:
        np.testing.assert_array_equal(port_batch[key], batch[key])
    assert port_batch["obs"].dtype == np.uint8
    # jaxlint: disable=JAX05 - the donated state is rebound here
    jax_state, want = ref._update(ref.state, {k: jnp.asarray(v) for k, v in batch.items()})
    state, got = port._update(state, port._to_device(port_batch), None)
    for key in want:
        assert float(got[key]) == pytest.approx(float(want[key]), rel=METRIC_RTOL,
                                                abs=METRIC_ATOL), key
    bound = 1e-3 * 1.0  # lr x one step
    for field in ("params", "target_params"):
        want_state = params_from_jax(jax.tree.map(np.asarray, getattr(jax_state, field)))
        online = dict(state.params.named_parameters())
        for key, value in getattr(state, field).state_dict().items():
            noise = least[online[key]] < ADAM_FLOOR
            tol = torch.where(noise, bound * (1 + 1e-3), PARAM_ATOL)
            diff = (value - want_state[key]).abs()
            assert bool((diff <= tol).all()), (field, key, float(diff.max()))


def test_pixel_dqn_trains_on_uint8_ring(tmp_cwd):
    """``tests/test_offpolicy.py::TestUint8Ring``'s case on the port: the
    conv update runs on byte batches. (The JAX case also asks ``warmup``
    for a compiled batch; the port's eager update compiles nothing and
    its ``warmup`` returns 0.)"""
    h = w = 12
    c = 2
    obs_dim = h * w * c
    algo = build_algorithm(
        "DQN", obs_dim=obs_dim, act_dim=3, obs_shape=[h, w, c],
        obs_dtype="uint8", batch_size=8, buf_size=128, update_after=16,
        conv_spec=[[4, 3, 2], [8, 3, 1]], dense=32, device="cpu",
        logger_kwargs={"output_dir": str(tmp_cwd / "logs_u8dqn")})
    assert algo.buffer.obs.dtype == np.uint8
    rng = np.random.default_rng(0)
    for _ in range(4):
        eps = [ActionRecord(
            obs=rng.integers(0, 256, obs_dim, dtype=np.uint8),
            act=np.int64(rng.integers(3)), rew=float(rng.random()),
            done=(i == 9)) for i in range(10)]
        algo.receive_trajectory(eps)
    assert algo.version > 0
    assert algo.warmup() == 0
    bundle = algo.bundle()
    assert bundle.arch["obs_shape"] == [h, w, c]
    assert bundle.params["params"]["q_trunk"]["conv_0"]["kernel"].shape == (3, 3, 2, 4)


# ---------------------------------------------------------------------------
# presets, refusals, routing
# ---------------------------------------------------------------------------
def test_conv_spec_presets_and_refusals():
    assert resolve_conv_spec("nature") == NATURE_CONV
    assert resolve_conv_spec("TPU") == TPU_CONV
    assert resolve_conv_spec([[8, 8, 4]]) == ((8, 8, 4),)
    with pytest.raises(ValueError, match="unknown conv preset"):
        resolve_conv_spec("resnet")
    assert conv_trunk_kwargs({"obs_shape": [84, 84, 4], "conv_spec": "tpu"})["conv_spec"] \
        == TPU_CONV
    with pytest.raises(ValueError, match="collapses"):
        build_policy({"kind": "cnn_discrete", "obs_shape": [20, 20, 1], "act_dim": 2}, "cpu")
    with pytest.raises(ValueError, match="needs obs_shape"):
        build_policy({"kind": "cnn_discrete", "obs_shape": [36, 36], "act_dim": 2}, "cpu")
    with pytest.raises(ValueError, match="obs_dim"):
        build_policy({**_arch(), "obs_dim": 7}, "cpu")
    policy = build_policy(_arch(), "cpu")
    params = policy.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="matches neither"):
        policy.evaluate(params, np.zeros((2, 17), np.float32), np.zeros(2))
    with torch.no_grad():  # shaped [..., H, W, C] frames are accepted too
        logp, _, _ = policy.evaluate(params, np.zeros((2, 36, 36, 2), np.float32),
                                     np.zeros(2))
    assert tuple(logp.shape) == (2,)


@pytest.mark.parametrize("algo", ["IMPALA", "PPO"])
def test_conv_spec_reaches_pixel_learners(algo, tmp_cwd):
    alg = build_algorithm(algo, obs_dim=FLAT, act_dim=4, env_dir=str(tmp_cwd),
                          obs_shape=SHAPE, conv_spec=NARROW, dense=32, device="cpu")
    assert alg.arch["kind"] == "cnn_discrete" and alg.arch["conv_spec"] == NARROW
    assert tuple(alg.state.params.trunk.conv_0.weight.shape)[0] == 4


def test_sequence_overrides_warn_on_cnn_and_mlp():
    for kind in ("cnn_discrete", "mlp_discrete"):
        with pytest.warns(UserWarning, match="no effect on model kind"):
            apply_arch_overrides({"kind": kind}, {"d_model": 64})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        apply_arch_overrides({"kind": "transformer_discrete"}, {"d_model": 64})
        apply_arch_overrides({"kind": "cnn_discrete"}, {"hidden_sizes": [8]})
