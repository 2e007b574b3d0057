"""The port's GPipe pipeline (``parallel/pipeline.py``) and the pipeline
transformer under a ``pp`` mesh, against the JAX package's, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices, the port on
``[torch.device("cpu")] * 8``. On the same numpy inputs:

* ``pipeline_apply`` on ``tests/test_pipeline.py``'s stacked MLP and mesh
  cases: the forward within 1e-5 and the gradients within 1e-4 of JAX's;
  ``resolve_microbatches`` equal to JAX's; the same named error for a
  layer count ``pp`` does not divide;
* each layer runs once per microbatch per data group (bubble ticks do no
  work);
* ``transformer_pp_discrete`` under ``{dp 2, pp 4}``: the pipelined
  ``evaluate`` and one sharded REINFORCE update against JAX's on the same
  mesh (``tests/test_pipeline.py``'s cases), the window readout through
  the pipeline;
* ring attention inside the pipeline (``pp`` with ``sp``) fails in both
  packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu.parallel import make_mesh as jax_make_mesh
from relayrl_tpu.parallel.context import use_mesh as jax_use_mesh
from relayrl_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from relayrl_tpu.parallel.pipeline import resolve_microbatches as jax_resolve_microbatches
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.models.transformer import TransformerBlock
from relayrl_tpu_torch.parallel import (
    make_mesh,
    pipeline_apply,
    resolve_microbatches,
    use_mesh,
)
from tests.test_torch_sharding import _batch, _jax_update, _port_update, _tree, check_update

CPU = torch.device("cpu")
PP = {"dp": 2, "pp": 4}
# The JAX package's error for a ring shard_map nested in its pipeline's:
# inside the outer shard_map every mesh axis is manual, so the inner one's
# mesh differs from the context mesh.
JAX_NESTED_SHARD_MAP = "context mesh .* should match the mesh passed to shard_map"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stacked_mlp(n_layers=4, width=16, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_layers, width, width)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((n_layers, width)) * 0.1).astype(np.float32)
    return {"w": w, "b": b}


def _jax_stage(params, h):
    def layer(c, p):
        return jnp.tanh(c @ p[0] + p[1]), None
    return jax.lax.scan(layer, h, (params["w"], params["b"]))[0]


def _stage(layers, h):
    for w, b in layers:
        h = torch.tanh(h @ w + b)
    return h


def _layers(params, requires_grad=False):
    return [(torch.tensor(w, requires_grad=requires_grad),
             torch.tensor(b, requires_grad=requires_grad))
            for w, b in zip(params["w"], params["b"])]


def _jax_mesh(spec):
    return jax_make_mesh(spec)


def _mesh(spec):
    return make_mesh(spec, [CPU] * 8)


@pytest.mark.parametrize("spec,n_micro", [({"dp": -1, "pp": 4}, None), (PP, 4),
                                          ({"dp": -1, "pp": 2}, 2)])
def test_pipeline_apply_matches_jax(spec, n_micro):
    params = _stacked_mlp()
    x = np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32)
    mesh = _jax_mesh(spec)
    want = jax.jit(lambda p, h: jax_pipeline_apply(_jax_stage, p, h, mesh,
                                                   n_microbatches=n_micro))(params, x)
    got = pipeline_apply(_stage, _layers(params), torch.from_numpy(x), _mesh(spec),
                         n_microbatches=n_micro)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), _stage(_layers(params), torch.from_numpy(x)).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_pipeline_gradients_match_jax():
    params = _stacked_mlp()
    x = np.random.default_rng(2).standard_normal((8, 16)).astype(np.float32)
    mesh = _jax_mesh(PP)
    want = jax.jit(jax.grad(lambda p: jnp.sum(jnp.sin(
        jax_pipeline_apply(_jax_stage, p, x, mesh)))))(params)
    layers = _layers(params, requires_grad=True)
    torch.sin(pipeline_apply(_stage, layers, torch.from_numpy(x), _mesh(PP))).sum().backward()
    for i, key in enumerate(("w", "b")):
        got = np.stack([layer[i].grad.numpy() for layer in layers])
        np.testing.assert_allclose(got, np.asarray(want[key]), atol=1e-4, rtol=1e-4,
                                   err_msg=key)


def test_single_stage_passthrough_and_microbatches():
    params = _stacked_mlp()
    x = torch.ones((4, 16))
    got = pipeline_apply(_stage, _layers(params), x, _mesh({"dp": 8, "pp": 1}))
    assert torch.equal(got, _stage(_layers(params), x))
    for local in range(1, 13):
        for stages in (1, 2, 3, 4):
            for requested in (None, 1, 2, 3, 4, 8):
                assert (resolve_microbatches(local, stages, requested)
                        == jax_resolve_microbatches(local, stages, requested))


def test_indivisible_layer_count_raises_in_both():
    params = _stacked_mlp(n_layers=3)
    x = np.ones((8, 16), np.float32)
    with pytest.raises(ValueError, match="not divisible by the pp mesh axis"):
        jax_pipeline_apply(_jax_stage, params, x, _jax_mesh(PP))
    with pytest.raises(ValueError, match="not divisible by the pp mesh axis"):
        pipeline_apply(_stage, _layers(params), torch.from_numpy(x), _mesh(PP))


def test_each_layer_runs_once_per_microbatch_per_data_group():
    """{dp 2, pp 4}, 8 rows: 2 data groups of 4 rows, 4 microbatches of
    one row; 4 stages of one layer: 4 x 4 x 2 layer calls, none in a
    bubble."""
    calls = []

    def stage(layers, h):
        calls.append((len(layers), tuple(h.shape)))
        return _stage(layers, h)

    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    pipeline_apply(stage, _layers(_stacked_mlp()), x, _mesh(PP))
    assert calls == [(1, (1, 16))] * (4 * 4 * 2)


def _arch(precision="float32", attention="flash"):
    return {"kind": "transformer_pp_discrete", "obs_dim": 6, "act_dim": 3, "d_model": 16,
            "n_layers": 4, "n_heads": 2, "max_seq_len": 8, "has_critic": True,
            "attention": attention, "precision": precision}


@pytest.fixture
def block_calls(monkeypatch):
    calls = []
    forward = TransformerBlock.forward

    def counted(self, x, *args, **kwargs):
        calls.append(tuple(x.shape))
        return forward(self, x, *args, **kwargs)
    monkeypatch.setattr(TransformerBlock, "forward", counted)
    return calls


def test_pipelined_evaluate_matches_jax(block_calls):
    """tests/test_pipeline.py's case: the pp family's ``evaluate`` under
    {dp 2, pp 4} against JAX's pipelined evaluate (1e-5) and the port's
    unpipelined one; 4 layers x 2 microbatches (local batch 2) x 2 groups
    block calls; the window readout runs the whole pipelined forward."""
    tree = jax.tree.map(np.asarray, jax_build_policy(_arch()).init_params(jax.random.PRNGKey(0)))
    obs = np.random.default_rng(0).standard_normal((4, 8, 6)).astype(np.float32)
    act = np.zeros((4, 8), np.int32)
    with jax_use_mesh(_jax_mesh(PP)):
        want = jax.jit(jax_build_policy(_arch()).evaluate)(tree, obs, act)
    policy = build_policy(_arch(), device="cpu")
    params = policy.load_params(tree)
    mesh = _mesh(PP)
    with torch.no_grad():
        with use_mesh(mesh):
            got = policy.evaluate(params, obs, act)
        assert block_calls == [(1, 8, 16)] * (4 * 2 * 2)
        plain = policy.evaluate(params, obs, act)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-5, rtol=1e-5)
    windows = np.zeros((4, 8, 6), np.float32)
    windows[:, :5] = obs[:, :5]
    t = np.array([5, 1, 3, 8])
    with torch.no_grad():
        with use_mesh(mesh):
            a, aux = policy.step_window(params, torch.Generator().manual_seed(3), windows, t)
        b, aux_plain = policy.step_window(params, torch.Generator().manual_seed(3), windows, t)
    assert torch.equal(a, b)
    np.testing.assert_allclose(aux["v"].numpy(), aux_plain["v"].numpy(), atol=1e-5)


@pytest.mark.parametrize("spec", [
    PP, pytest.param({"dp": 2, "fsdp": 2, "pp": 2}, marks=pytest.mark.slow)],
    ids=["dp2-pp4", "dp2-fsdp2-pp2"])
def test_sharded_reinforce_update_on_pp_mesh_matches_jax(spec):
    """One REINFORCE update of the pp family on tests/test_pipeline.py's
    meshes against the JAX package's sharded update at tests/
    test_parallel.py's bars; each stage's layers sit on its device."""
    batch = _batch()
    got, got_m, state = _port_update("transformer_pp_discrete", spec, batch)
    want, want_m = _jax_update("transformer_pp_discrete", spec, batch)
    check_update(got, want, _tree("transformer_pp_discrete"), got_m, want_m)
    stages = _mesh(spec).axis_devices("pp")
    per = 4 // spec["pp"]
    for i, block in enumerate(state.params.blocks):
        assert all(p.is_leaf and p.device == stages[i // per] for p in block.parameters())


def test_ring_attention_in_the_pipeline_fails_in_both():
    """A mesh with pp and sp: the JAX package's ring shard_map cannot nest
    in its pipeline's, and the port raises the named error."""
    arch = _arch(attention="ring")
    tree = jax.tree.map(np.asarray, jax_build_policy(arch).init_params(jax.random.PRNGKey(0)))
    obs = np.zeros((2, 8, 6), np.float32)
    act = np.zeros((2, 8), np.int32)
    spec = {"pp": 2, "sp": 2}
    with pytest.raises(ValueError, match=JAX_NESTED_SHARD_MAP):
        with jax_use_mesh(jax_make_mesh(spec, jax.devices()[:4])):
            jax.jit(jax_build_policy(arch).evaluate)(tree, obs, act)
    policy = build_policy(arch, device="cpu")
    with pytest.raises(ValueError, match="ring attention .* inside the pipeline"):
        with use_mesh(make_mesh(spec, [CPU] * 4)), torch.no_grad():
            policy.evaluate(policy.load_params(tree), obs, act)
