"""The port's sharding rules and single-controller mesh learner against the
JAX package's, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices; the port on a
mesh of ``[torch.device("cpu")] * 8`` (the single controller may repeat a
device). On the same numpy inputs:

* every leaf's spec equals ``param_pspec``'s, for ``mlp_discrete`` and the
  three transformer families on five meshes, and the flagship's splits
  are the ones the rules give at full width;
* ``tests/test_parallel.py``'s sharded update of ``mlp_discrete`` on its
  three meshes equals the JAX package's at its bars (rtol 2e-4, atol
  2e-5): fsdp gathers and tp's column/row split;
* the MoE family on ``{dp 2, ep 4}``: the expert groups on their ep
  devices give the unsharded update (fast), and JAX's sharded update
  (slow, as the JAX package marks its own);
* a placed state's shards and their Adam moments are leaves at their mesh
  coordinates, its bundle bytes equal the unplaced state's, and a
  checkpoint of it restores a learner whose next update equals the
  uninterrupted one;
* ``enable_multihost`` on REINFORCE trains from ``receive_trajectory`` and
  publishes the whole params.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu.parallel import make_mesh as jax_make_mesh
from relayrl_tpu.parallel import make_sharded_update as jax_make_sharded_update
from relayrl_tpu.parallel import place_batch as jax_place_batch
from relayrl_tpu.parallel import place_state as jax_place_state
from relayrl_tpu.parallel.sharding import params_shardings as jax_params_shardings
from relayrl_tpu_torch.algorithms import build_algorithm
from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
from relayrl_tpu_torch.algorithms.reinforce import (
    ReinforceState,
    make_optimizers,
    make_reinforce_update,
)
from relayrl_tpu_torch.checkpoint.manager import (
    CheckpointManager,
    apply_state,
    capture_state,
    train_state_digest,
)
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.parallel import (
    make_mesh,
    make_sharded_update,
    params_shardings,
    place_state,
)
from relayrl_tpu_torch.parallel.sharding import mesh_device, placement, shard_tensors
from relayrl_tpu_torch.types import ModelBundle
from relayrl_tpu_torch.weights import logical_state, params_to_jax, tree_digest

CPU = torch.device("cpu")
MESHES = [{"dp": 2, "fsdp": 2, "tp": 2}, {"dp": 4, "tp": 2}, {"dp": 2, "ep": 4},
          {"dp": 2, "pp": 4}, {"dp": 2, "fsdp": 2, "pp": 2}]
OBS, ACT = 6, 3
# tests/test_parallel.py's bars for a sharded f32 update against its
# unsharded one.
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arch(kind):
    if kind == "mlp_discrete":
        return {"kind": kind, "obs_dim": 8, "act_dim": 4, "hidden_sizes": [16, 16],
                "has_critic": True}
    return {"kind": kind, "obs_dim": OBS, "act_dim": ACT, "d_model": 16, "n_layers": 4,
            "n_heads": 2, "max_seq_len": 8, "has_critic": True, "attention": "flash"}


@functools.lru_cache(maxsize=None)
def _tree(kind, seed=0):
    return jax.tree.map(np.asarray,
                        jax_build_policy(_arch(kind)).init_params(jax.random.PRNGKey(seed)))


def _jax_specs(tree, mesh) -> dict:
    """``params/<path>`` -> JAX's spec padded to the leaf's rank."""
    out = {}
    shardings = jax.tree_util.tree_flatten_with_path(
        jax_params_shardings(tree, mesh), is_leaf=lambda x: hasattr(x, "spec"))[0]
    for path, sharding in shardings:
        names = [k.key for k in path]
        leaf = functools.reduce(lambda node, k: node[k], names, tree)
        out["/".join(names)] = tuple(sharding.spec) + (None,) * (
            np.ndim(leaf) - len(sharding.spec))
    return out


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("spec", MESHES, ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("kind", ["mlp_discrete", "transformer_discrete",
                                  "transformer_moe_discrete", "transformer_pp_discrete"])
def test_param_specs_match_jax(kind, spec):
    tree = _tree(kind)
    module = build_policy(_arch(kind), device="cpu").load_params(tree)
    mesh = make_mesh(spec, [CPU] * 8)
    got = params_shardings(module, mesh)
    assert got == _jax_specs(tree, jax_make_mesh(spec))
    place_state(ReinforceState(module, None, None), mesh)
    # A placed module answers with its logical leaves.
    assert params_shardings(module, mesh) == got


def test_flagship_splits():
    """At ``__graft_entry__.entry()``'s widths: 58 leaves of the flagship
    split at {dp 2, fsdp 2, tp 2}, all over fsdp; 8 expert stacks of the
    MoE flagship at {dp 2, ep 4}; 12 ``blocks`` leaves of the pp flagship
    at {dp 2, pp 4}; and mlp_discrete's first kernel at ("fsdp", "tp")."""
    flagship = {"obs_dim": 18, "act_dim": 16, "d_model": 256, "n_layers": 4, "n_heads": 8,
                "max_seq_len": 256, "has_critic": True}

    def split(kind, spec, **extra):
        arch = {**flagship, "kind": kind, **extra}
        module = build_policy(arch, device="cpu").init_params(torch.Generator().manual_seed(0))
        specs = params_shardings(module, make_mesh(spec, [CPU] * 8))
        shapes = jax.eval_shape(jax_build_policy(arch).init_params, jax.random.PRNGKey(0))
        assert specs == _jax_specs(jax.tree.map(lambda s: np.zeros(s.shape, np.int8), shapes),
                                   jax_make_mesh(spec))
        return {p: s for p, s in specs.items() if any(e is not None for e in s)}

    fsdp = split("transformer_discrete", MESHES[0])
    assert len(fsdp) == 58 and all("fsdp" in s and "tp" not in s for s in fsdp.values())
    ep = split("transformer_moe_discrete", MESHES[2], moe_experts=4, moe_top_k=2)
    assert len(ep) == 8 and all(s[0] == "ep" for s in ep.values())
    pp = split("transformer_pp_discrete", MESHES[3])
    assert len(pp) == 12 and all(p.startswith("params/blocks/") and s[0] == "pp"
                                 for p, s in pp.items())
    mlp = params_shardings(build_policy(_arch("mlp_discrete"), device="cpu").init_params(
        torch.Generator().manual_seed(0)), make_mesh(MESHES[0], [CPU] * 8))
    assert mlp["params/pi_trunk/dense_0/kernel"] == ("fsdp", "tp")


# -- tests/test_parallel.py's sharded update ------------------------------------

def _tiny_batch():
    rng = np.random.default_rng(0)
    return {
        "obs": rng.standard_normal((8, 5, 8)).astype(np.float32),
        "act": rng.integers(0, 4, (8, 5)).astype(np.int32),
        "act_mask": np.ones((8, 5, 4), np.float32),
        "adv": rng.standard_normal((8, 5)).astype(np.float32),
        "ret": rng.standard_normal((8, 5)).astype(np.float32),
    }


def _jax_tiny(tree, spec):
    import optax

    policy = jax_build_policy(_arch("mlp_discrete"))
    tx = optax.adam(1e-2)

    def update(state, batch):
        params, opt_state = state

        def loss_fn(p):
            logp, ent, v = policy.evaluate(p, batch["obs"], batch["act"], batch["act_mask"])
            return -jnp.mean(logp * batch["adv"]) + 0.5 * jnp.mean((v - batch["ret"]) ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (jax.tree.map(lambda p, u: p + u, params, updates), opt_state), {"loss": loss}

    state = (tree, tx.init(tree))
    mesh = jax_make_mesh(spec)
    sharded = jax_make_sharded_update(update, mesh, state, donate_state=False)
    new, metrics = sharded(jax_place_state(state, mesh), jax_place_batch(_tiny_batch(), mesh))
    return jax.tree.map(np.asarray, new[0]), float(metrics["loss"])


@dataclasses.dataclass
class _TinyState:
    params: torch.nn.Module
    opt: torch.optim.Optimizer


def _port_tiny_update(policy):
    def update(state, batch):
        logp, _, v = policy.evaluate(state.params, batch["obs"], batch["act"],
                                     batch["act_mask"])
        loss = -(logp * batch["adv"]).mean() + 0.5 * (v - batch["ret"]).square().mean()
        state.opt.zero_grad()
        loss.backward()
        state.opt.step()
        return state, {"loss": loss.detach()}
    return update


@pytest.mark.parametrize("spec", [{"dp": 8}, MESHES[0], MESHES[1]],
                         ids=["dp8", "dp2-fsdp2-tp2", "dp4-tp2"])
def test_mlp_sharded_update_matches_jax(spec):
    tree = _tree("mlp_discrete")
    want, want_loss = _jax_tiny(tree, spec)
    policy = build_policy(_arch("mlp_discrete"), device="cpu")
    params = policy.load_params(tree)
    mesh = make_mesh(spec, [CPU] * 8)
    state = place_state(_TinyState(params, torch.optim.Adam(params.parameters(), lr=1e-2)), mesh)
    if "tp" in spec:  # the first trunk layer reads its tp blocks in place
        assert placement(params.pi_trunk.dense_0, "weight").spec[0] == "tp"
    new, metrics = make_sharded_update(_port_tiny_update(policy), mesh, state)(state, _tiny_batch())
    assert float(metrics["loss"]) == pytest.approx(want_loss, rel=1e-4)
    got, w = _leaves(params_to_jax(new.params)), _leaves(want)
    assert got.keys() == w.keys()
    for path in got:
        np.testing.assert_allclose(got[path], w[path], rtol=RTOL, atol=ATOL, err_msg=path)


# -- the mesh learner: REINFORCE -------------------------------------------------

def _batch(b=8, t=8, seed=0, obs=OBS, act=ACT):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((b, t, obs)).astype(np.float32),
        "act": rng.integers(0, act, (b, t)).astype(np.int32),
        "act_mask": np.ones((b, t, act), np.float32),
        "rew": rng.standard_normal((b, t)).astype(np.float32),
        "val": np.zeros((b, t), np.float32),
        "logp": np.zeros((b, t), np.float32),
        "valid": np.ones((b, t), np.float32),
        "last_val": np.zeros((b,), np.float32),
    }


def _port_state(kind, tree=None):
    policy = build_policy(_arch(kind), device="cpu")
    params = policy.load_params(tree if tree is not None else _tree(kind))
    return policy, ReinforceState(params, *make_optimizers(params, 3e-4, 1e-3))


def _port_update(kind, spec, batch, vf_iters=1):
    """One REINFORCE update of ``kind`` from the shared tree: sharded over
    ``spec`` (a dict) or unsharded (None). Returns (flax params, metrics,
    state)."""
    policy, state = _port_state(kind)
    update = make_reinforce_update(policy, vf_iters, 0.99, 0.95, True)
    if spec is None:
        new, metrics = update(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    else:
        mesh = make_mesh(spec, [CPU] * 8)
        sharded = make_sharded_update(update, mesh, state)
        new, metrics = sharded(place_state(state, mesh), batch)
    return params_to_jax(new.params), read_metrics(metrics), new


def _jax_update(kind, spec, batch, vf_iters=1):
    """JAX's sharded REINFORCE update from the same tree (as
    tests/test_moe.py and tests/test_pipeline.py run it)."""
    from relayrl_tpu.algorithms.reinforce import ReinforceState as JaxState
    from relayrl_tpu.algorithms.reinforce import make_optimizers as jax_make_optimizers
    from relayrl_tpu.algorithms.reinforce import make_reinforce_update as jax_make_update

    tree = _tree(kind)
    policy = jax_build_policy(_arch(kind))
    tx_pi, tx_vf = jax_make_optimizers(tree, 3e-4, 1e-3)
    state = JaxState(params=tree, pi_opt_state=tx_pi.init(tree), vf_opt_state=tx_vf.init(tree),
                     rng=jax.random.PRNGKey(1), step=jnp.int32(0))
    update = jax_make_update(policy, 3e-4, 1e-3, vf_iters, 0.99, 0.95, with_baseline=True)
    mesh = jax_make_mesh(spec)
    sharded = jax_make_sharded_update(update, mesh, state, donate_state=False)
    new, metrics = sharded(jax_place_state(state, mesh), jax_place_batch(batch, mesh))
    return jax.tree.map(np.asarray, new.params), {k: float(v) for k, v in metrics.items()}


def check_update(got, want, init, got_m, want_m, steps=(3e-4, 1e-3)):
    """A sharded update against another side's, f32: metrics at rtol 1e-4
    (atol 1e-6), every leaf at tests/test_parallel.py's bars, except where
    a gradient that is zero in exact arithmetic leaves both sides taking
    Adam's normalized step on rounding noise (the key third of each qkv
    bias, tests/test_torch_reinforce.py's rule): there each side is held
    to Adam's step bound."""
    for key, value in want_m.items():
        assert got_m[key] == pytest.approx(value, rel=1e-4, abs=1e-6), key
    g, w, i = _leaves(got), _leaves(want), _leaves(init)
    assert g.keys() == w.keys()
    for path in g:
        if path.endswith("['qkv']['bias']"):
            d = g[path].shape[-1] // 3
            bound = steps[0] * (1 + 1e-3)
            for side in (g, w):
                np.testing.assert_array_less(np.abs(side[path][..., d:2 * d]
                                                    - i[path][..., d:2 * d]), bound)
            g[path], w[path] = (np.delete(x[path], np.s_[d:2 * d], axis=-1) for x in (g, w))
        np.testing.assert_allclose(g[path], w[path], rtol=RTOL, atol=ATOL, err_msg=path)


EP = {"dp": 2, "ep": 4}


def test_moe_ep_update_matches_unsharded():
    """Each ep device runs its group of E / ep experts from its shards; the
    partial combines summed in group order give the unsharded update."""
    batch = _batch()
    got, got_m, state = _port_update("transformer_moe_discrete", EP, batch)
    want, want_m, _ = _port_update("transformer_moe_discrete", None, batch)
    check_update(got, want, _tree("transformer_moe_discrete"), got_m, want_m)
    moe = state.params.block_0.moe
    assert placement(moe, "moe_w_up").spec == ("ep", None, None)
    assert len(shard_tensors(moe, "moe_w_up")) == 4
    assert tuple(shard_tensors(moe, "moe_w_up")[0].shape) == (1, 16, 64)


@pytest.mark.slow
def test_moe_ep_update_matches_jax():
    batch = _batch()
    got, got_m, _ = _port_update("transformer_moe_discrete", EP, batch)
    want, want_m = _jax_update("transformer_moe_discrete", EP, batch)
    check_update(got, want, _tree("transformer_moe_discrete"), got_m, want_m)


@pytest.mark.parametrize("kind,spec", [
    ("transformer_pp_discrete", {"dp": 2, "pp": 4}),
    ("transformer_moe_discrete", EP),
    ("transformer_discrete", {"dp": 2, "fsdp": 2, "tp": 2}),
    ("mlp_discrete", {"dp": 2, "fsdp": 2, "tp": 2}),
])
def test_placed_leaves_sit_at_their_coordinates(kind, spec):
    """Under pp each stage's layers, under ep and fsdp (and tp) each shard,
    and each one's Adam moments after an update, are leaf tensors on the
    device their mesh coordinate names; a shard's moments have its
    shape."""
    mesh = make_mesh(spec, [CPU] * 8)
    arch = _arch(kind)
    _, _, state = _port_update(kind, spec, _batch(obs=arch["obs_dim"], act=arch["act_dim"]))
    moments = {}
    for opt in (state.pi_opt, state.vf_opt):
        for p, st in opt.state.items():
            moments[id(p)] = st
    checked = 0
    for name, module in state.params.named_modules():
        for leaf in list(getattr(module, "parametrizations", {}) or {}):
            shards = placement(module, leaf)
            for t, coords, dev in zip(shard_tensors(module, leaf), shards.coords, shards.devices):
                assert t.is_leaf and t.device == dev == mesh_device(mesh, **coords)
                if id(t) in moments:
                    assert moments[id(t)]["exp_avg"].shape == t.shape
                    assert moments[id(t)]["exp_avg"].device == dev
                checked += 1
    if "pp" in spec:
        per = 4 // spec["pp"]
        for i, block in enumerate(state.params.blocks):
            stage = mesh.axis_devices("pp")[i // per]
            for p in block.parameters():
                assert p.is_leaf and p.device == stage
                assert moments[id(p)]["exp_avg"].device == stage
                checked += 1
    assert checked


# -- bundles and checkpoints ------------------------------------------------------

@pytest.mark.parametrize("kind,spec", [("transformer_moe_discrete", {"dp": 2, "fsdp": 2, "ep": 2}),
                                       ("transformer_pp_discrete", {"fsdp": 2, "pp": 4}),
                                       ("mlp_discrete", {"fsdp": 4, "tp": 2})])
def test_placed_bundle_bytes_equal_unplaced(kind, spec):
    arch = _arch(kind)
    _, unplaced = _port_state(kind)
    want = ModelBundle(3, arch, params_to_jax(unplaced.params)).to_bytes()
    _, state = _port_state(kind)
    place_state(state, make_mesh(spec, [CPU] * 8))
    assert any(placement(m, leaf) is not None for m in state.params.modules()
               for leaf in (getattr(m, "parametrizations", None) or {}))
    assert ModelBundle(3, arch, params_to_jax(state.params)).to_bytes() == want
    assert list(logical_state(state.params)) == list(unplaced.params.state_dict())


def test_checkpoint_of_a_placed_state_resumes_the_next_update(tmp_path):
    """Save a placed learner after one update; a fresh learner placed on
    the same mesh restores it, and a fresh unplaced learner restores it
    and is placed after (the moments split then): both next updates equal
    the uninterrupted learner's, bit for bit. The checkpoint holds the
    whole parameters and moments, in the unplaced layout."""
    kind, spec = "transformer_moe_discrete", {"dp": 2, "fsdp": 2, "ep": 2}
    mesh = make_mesh(spec, [CPU] * 8)
    policy, state = _port_state(kind)
    update = make_sharded_update(make_reinforce_update(policy, 2, 0.99, 0.95, True), mesh, state)
    state = place_state(state, mesh)
    state, _ = update(state, _batch(seed=1))
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    saved = capture_state(state)
    manager.save(1, saved)
    _, unplaced = _port_state(kind)
    assert list(saved["params"]) == list(unplaced.params.state_dict())
    assert len(saved["pi_opt"]["state"]) == len(unplaced.pi_opt.param_groups[0]["params"])
    state, _ = update(state, _batch(seed=2))
    want = tree_digest(params_to_jax(state.params))
    restored, _, _ = manager.restore(1)
    for place_first in (True, False):
        _, other = _port_state(kind)
        if place_first:
            other = apply_state(place_state(other, mesh), restored)
        else:
            other = place_state(apply_state(other, restored), mesh)
        assert train_state_digest(capture_state(other)) == train_state_digest(restored)
        other, _ = update(other, _batch(seed=2))
        assert tree_digest(params_to_jax(other.params)) == want


@pytest.mark.parametrize("placed", [False, True], ids=["unplaced", "placed"])
def test_restore_refuses_a_mismatched_entry(placed):
    """A checkpoint whose params lack a key, or hold one of another shape,
    is refused whether or not the learner is placed, and the refused
    restore leaves the parameters as they were."""
    kind = "mlp_discrete"
    _, state = _port_state(kind)
    saved = capture_state(state)
    if placed:
        state = place_state(state, make_mesh({"fsdp": 4, "tp": 2}, [CPU] * 8))
    before = tree_digest(params_to_jax(state.params))
    key = "pi_trunk.dense_0.weight"
    missing = {**saved, "params": {k: v for k, v in saved["params"].items() if k != key}}
    with pytest.raises(KeyError, match="state keys differ"):
        apply_state(state, missing)
    wrong = {**saved, "params": {**saved["params"], key: saved["params"][key][:, :1]}}
    with pytest.raises(ValueError, match="does not match"):
        apply_state(state, wrong)
    assert tree_digest(params_to_jax(state.params)) == before


# -- the entry point ---------------------------------------------------------------

def _episode(rng, n, obs_dim, act_dim):
    from relayrl_tpu_torch.types import ActionRecord

    return [ActionRecord(obs=rng.standard_normal(obs_dim).astype(np.float32),
                         act=int(rng.integers(act_dim)),
                         mask=np.ones(act_dim, np.float32),
                         rew=float(rng.standard_normal()), done=i == n - 1,
                         data={"logp_a": np.float32(-1.0), "v": np.float32(0.0)})
            for i in range(n)]


def test_enable_multihost_reinforce(tmp_cwd):
    """``enable_multihost`` over a dp 2 x fsdp 2 x tp 2 mesh: REINFORCE
    trains from ``receive_trajectory`` as the unsharded learner does (the
    same params at the f32 bars after two epochs), its optimizers hold the
    shard leaves, its bundle and publish snapshot carry the whole params,
    and ``mh_zero_batch`` is the JAX package's."""
    from relayrl_tpu.algorithms.onpolicy import OnPolicyAlgorithm as JaxOnPolicy

    kw = dict(obs_dim=8, act_dim=4, traj_per_epoch=4, with_vf_baseline=True,
              hidden_sizes=[16, 16], device="cpu", seed_salt=0, train_vf_iters=2,
              bucket_lengths=[8])
    algos = [build_algorithm("REINFORCE", env_dir=str(tmp_cwd / name), **kw)
             for name in ("mesh", "plain")]
    mesh = make_mesh(MESHES[0], [CPU] * 8)
    algos[0].enable_multihost(mesh)
    leaves = {id(p) for g in algos[0].state.pi_opt.param_groups for p in g["params"]}
    assert {id(t) for t in shard_tensors(algos[0].state.params.pi_trunk.dense_0, "weight")} <= leaves
    rng = np.random.default_rng(0)
    episodes = [_episode(rng, n, 8, 4) for n in (5, 8, 3, 6, 2, 7, 8, 4)]
    for algo in algos:
        trained = [algo.receive_trajectory(ep) for ep in episodes]
        assert trained == [False, False, False, True] * 2 and algo.version == 2
    got, want = (_leaves(a.bundle().params) for a in algos)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=RTOL, atol=ATOL, err_msg=path)
    snap = algos[0].snapshot_for_publish()
    assert tree_digest(snap.host_params()) == tree_digest(algos[0].bundle().params)
    zero = algos[0].mh_zero_batch(4, 8)
    want_zero = JaxOnPolicy.mh_zero_batch(algos[0], 4, 8)
    assert zero.keys() == want_zero.keys()
    for key in zero:
        assert zero[key].dtype == want_zero[key].dtype and zero[key].shape == want_zero[key].shape
