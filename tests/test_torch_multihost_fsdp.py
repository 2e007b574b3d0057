"""fsdp, ep and tp across processes on the CPU: ``gloo`` ranks that each
hold only their own shards.

OS processes run ``tests/_torch_multihost_fsdp_worker.py`` against a real
``torch.distributed`` group (the pattern of ``tests/test_torch_multihost.py``)
and this process holds what they computed against the JAX package's
unsharded ``make_reinforce_update`` on the same params and batch:

* ``mlp_discrete`` [16, 16] at B 8, T 16 under ``{"dp": 1, "fsdp": -1}``
  over 2 processes of 2 CPU devices (fsdp 4, two coordinates a rank) and
  under ``{"dp": 2, "fsdp": 2}`` over 4 processes (both axes across
  ranks), f32 within 1e-5;
* a transformer (d_model 32, 1 layer, 2 heads, T 64, flash through its
  plain version) under ``{"dp": 1, "fsdp": 2}``, within
  ``tests/test_flash.py``'s 2e-5 on the metrics and 5e-5 on the params;
* the MoE transformer of ``tests/test_torch_sharding.py``'s ep tests (4
  experts, 4 layers) under ``{"dp": 1, "ep": 2}``, two experts a rank, at
  that file's bars (``check_update``);
* ``mlp_discrete`` under ``{"dp": 1, "tp": 2}`` (a device a rank), within
  1e-5;

and, for each, every rank's gathered params bit-equal after each of two
updates, and each rank holding only the shards at its coordinates, with
their Adam moments. IMPALA's ``mlp_discrete`` under ``{"dp": 1, "fsdp":
2}`` with a ``max_grad_norm`` whose clip engages: each rank's gradient
leaves are only its shards, and the clip must read the whole model's
norm, so the update matches the JAX package's (1e-5) and the ranks stay
bit-equal. Then a collective checkpoint under ``{"dp": 1,
"fsdp": 2}``: each rank's shards restore bit for bit, the saved train
state equals a single-process save of the same state tensor for tensor,
and the bundle equals the single-process bundle byte for byte.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from _util import free_port
from test_torch_multihost import (
    FWD_TOL,
    GRAD_TOL,
    HP,
    MLP_TOL,
    _batch,
    _check_params,
    _equal_trees,
    _jax_update,
)
from test_torch_sharding import check_update
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.weights import params_to_jax

_WORKER = os.path.join(os.path.dirname(__file__), "_torch_multihost_fsdp_worker.py")
MLP = {"kind": "mlp_discrete", "obs_dim": 6, "act_dim": 3, "hidden_sizes": [16, 16],
       "activation": "tanh", "has_critic": True, "precision": "float32"}
TRANSFORMER = {"kind": "transformer_discrete", "obs_dim": 6, "act_dim": 3, "d_model": 32,
               "n_layers": 1, "n_heads": 2, "max_seq_len": 64, "attention": "flash",
               "has_critic": True, "precision": "float32"}
MOE = {"kind": "transformer_moe_discrete", "obs_dim": 6, "act_dim": 3, "d_model": 16,
       "n_layers": 4, "n_heads": 2, "max_seq_len": 8, "attention": "flash",
       "has_critic": True, "precision": "float32"}
# name: (arch, mesh, devices a rank, T, processes)
CASES = {
    "mlp_fsdp4": (MLP, {"dp": 1, "fsdp": -1}, 2, 16, 2),
    "transformer_fsdp2": (TRANSFORMER, {"dp": 1, "fsdp": 2}, 1, 64, 2),
    "moe_ep2": (MOE, {"dp": 1, "ep": 2}, 1, 8, 2),
    "mlp_tp2": (MLP, {"dp": 1, "tp": 2}, 1, 16, 2),
    "mlp_dp2_fsdp2": (MLP, {"dp": 2, "fsdp": 2}, 1, 16, 4),
}
CROSS = {"mlp_fsdp4": ("fsdp",), "transformer_fsdp2": ("fsdp",), "moe_ep2": ("ep",),
         "mlp_tp2": ("tp",), "mlp_dp2_fsdp2": ("dp", "fsdp")}
# The clip scales the gradients to a norm at which each element is near
# Adam's eps (1e-8), so the step depends on the norm the clip read.
IMPALA_HP = {"lr": 1e-3, "gamma": 0.99, "vf_coef": 0.5, "ent_coef": 0.01,
             "rho_bar": 1.0, "c_bar": 0.9, "max_grad_norm": 1e-7}
IMPALA_MESH = {"dp": 1, "fsdp": 2}
CKPT_KW = {"obs_dim": 6, "act_dim": 3, "hidden_sizes": [16, 16], "traj_per_epoch": 8,
           "with_vf_baseline": True, "seed": 5, "seed_salt": 0}
CKPT_MESH = {"dp": 1, "fsdp": 2}


def _update_cases():
    rng = np.random.default_rng(11)
    cases = {}
    for name, (arch, mesh, local, t, world) in CASES.items():
        tree = params_to_jax(build_policy(arch, "cpu").init_params(
            torch.Generator().manual_seed(3)))
        lengths = [t, t - 1, t // 2, 3, t, 2, t - 3, 1]
        cases[name] = {"kind": "update", "arch": arch, "tree": tree, "hp": HP,
                       "mesh": mesh, "local_devices": local, "world": world,
                       "batch": _batch(rng, 8, t, arch["obs_dim"], arch["act_dim"], lengths)}
    return cases


def _start(workdir, cases, world):
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return [subprocess.Popen(
        [sys.executable, _WORKER, str(rank), str(world), str(port),
         str(workdir / "cases.pkl"), str(workdir)],
        cwd=str(workdir), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in range(world)]


def _wait(workdir, procs, deadline):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        hung = [p.communicate()[0] or "" for p in procs[len(outs):]]
        pytest.fail("multi-process workers hung:\n" + "\n---\n".join(outs + hung))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert f"TORCH_MULTIHOST_FSDP_OK rank={rank}" in out, out[-4000:]
    results = []
    for rank in range(len(procs)):
        with open(workdir / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _impala_case():
    rng = np.random.default_rng(13)
    tree = params_to_jax(build_policy(MLP, "cpu").init_params(
        torch.Generator().manual_seed(3)))
    return {"kind": "impala", "arch": MLP, "tree": tree, "hp": IMPALA_HP,
            "mesh": IMPALA_MESH, "local_devices": 1, "world": 2,
            "batch": _batch(rng, 8, 16, 6, 3, [16, 11, 16, 4, 9, 16, 2, 13])}


def _jax_impala(case, max_grad_norm):
    import jax
    import jax.numpy as jnp

    from relayrl_tpu.algorithms.impala import ImpalaState as JaxImpalaState
    from relayrl_tpu.algorithms.impala import make_impala_tx
    from relayrl_tpu.algorithms.impala import make_impala_update as jax_impala_update
    from relayrl_tpu.models import build_policy as jax_build_policy

    hp, tree = case["hp"], case["tree"]
    # jaxlint: disable=JAX05 - one update on a tiny state; no donation
    update = jax.jit(jax_impala_update(
        jax_build_policy(case["arch"]), hp["lr"], hp["gamma"], hp["vf_coef"],
        hp["ent_coef"], hp["rho_bar"], hp["c_bar"], max_grad_norm, (),
        params_template=tree))
    tx = make_impala_tx(hp["lr"], max_grad_norm, (), tree)
    state = JaxImpalaState(params=tree, opt_state=tx.init(tree),
                           rng=jax.random.PRNGKey(0), step=jnp.int32(0))
    new, metrics = update(state, {k: jnp.asarray(v) for k, v in case["batch"].items()})
    return (jax.tree.map(np.asarray, new.params),
            {k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's ranks (2-process and 4-process runs side by side),
    the JAX references computed while they run."""
    root = tmp_path_factory.mktemp("fsdp")
    cases = _update_cases()
    rng = np.random.default_rng(12)
    ckpt = {"kind": "checkpoint", "kwargs": CKPT_KW, "mesh": CKPT_MESH,
            "dir": str(root / "two" / "checkpoints"),
            "batches": [_batch(rng, 8, 16, 6, 3, [16, 9, 16, 4, 12, 16, 2, 7])
                        for _ in range(2)]}
    two = {n: c for n, c in cases.items() if c["world"] == 2}
    two["checkpoint"] = ckpt
    two["impala"] = _impala_case()
    four = {n: c for n, c in cases.items() if c["world"] == 4}
    procs = {2: _start(root / "two", two, 2), 4: _start(root / "four", four, 4)}
    deadline = time.monotonic() + 300
    try:
        wants = {n: _jax_update(c["arch"], c["tree"], c["batch"]) for n, c in cases.items()}
        wants["impala"] = _jax_impala(two["impala"], IMPALA_HP["max_grad_norm"])
        wants["impala_unclipped"] = _jax_impala(two["impala"], 1e6)
    except BaseException:
        for ps in procs.values():
            for p in ps:
                p.kill()
        raise
    ranks = {2: _wait(root / "two", procs[2], deadline),
             4: _wait(root / "four", procs[4], deadline)}
    return {"cases": cases, "ckpt": ckpt, "ranks": ranks, "wants": wants, "root": root}


def _ranks_of(runs, name):
    return [r[name] for r in runs["ranks"][runs["cases"][name]["world"]]]


@pytest.mark.parametrize("name", list(CASES))
def test_update_matches_jax(runs, name):
    """The first update across ranks against the JAX package's unsharded
    one at the case's bars."""
    case, (want_params, want) = runs["cases"][name], runs["wants"][name]
    got = _ranks_of(runs, name)[0]
    assert got["cross"] == CROSS[name]
    metrics, params = got["metrics"][0], got["params"][0]
    assert set(metrics) == set(want)
    if name == "moe_ep2":
        check_update(params, want_params, case["tree"], metrics, want)
        return
    tol_fwd, tol_grad = ((MLP_TOL, MLP_TOL) if case["arch"]["kind"] == "mlp_discrete"
                         else (FWD_TOL, GRAD_TOL))
    for key, value in want.items():
        assert metrics[key] == pytest.approx(value, rel=tol_fwd, abs=tol_fwd), key
    _check_params(params, want_params, case["tree"], tol_grad)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_gather_bit_equal(runs, name):
    """After each of two updates every rank gathers the same params, bit
    for bit, and reads the same metrics."""
    ranks = _ranks_of(runs, name)
    for i in range(2):
        for other in ranks[1:]:
            _equal_trees(other["params"][i], ranks[0]["params"][i])
            assert other["metrics"][i] == ranks[0]["metrics"][i]
    # The second update moved them.
    assert any(not np.array_equal(a, b) for a, b in zip(
        _flat(ranks[0]["params"][0]), _flat(ranks[0]["params"][1])))


def _flat(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat(tree[k])]
    return [np.asarray(tree)]


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_own_shards(runs, name):
    """A split parameter whose axis crosses ranks: each rank holds the
    shards at its coordinates only (leaf tensors on its CPU device, Adam
    moments of their shape); the ranks' blocks along the axis are disjoint
    and cover it; an fsdp shard is marked summed over fsdp."""
    ranks = _ranks_of(runs, name)
    axis = CROSS[name][-1]
    held = ranks[0]["holdings"]
    crossing = [leaf for leaf, h in held.items() if h["crosses"]]
    assert crossing, held.keys()
    for leaf in crossing:
        h0 = held[leaf]
        k = h0["spec"].index(axis) if axis in h0["spec"] else None
        dims = [d for d, e in enumerate(h0["spec"]) if e is not None]
        covered = []
        for r in ranks:
            h = r["holdings"][leaf]
            assert all(h["leaf"]) and set(h["devices"]) == {"cpu"}
            assert h["moments"] == h["shards"]
            assert h["summed_over_fsdp"] == [axis == "fsdp" and k is not None] * len(h["shards"])
            if k is not None:
                lo, hi = h["local"][dims.index(k)]
                covered += list(range(lo, hi))
                assert hi - lo < h["parts"][dims.index(k)]
                assert all(lo <= c[axis] < hi for c in h["coords"])
                whole = h["shape"][k]
                assert all(s[k] == whole // h["parts"][dims.index(k)] for s in h["shards"])
        if k is not None:
            assert set(covered) == set(range(h0["parts"][dims.index(k)]))


def test_impala_clip_reads_the_whole_norm(runs):
    """IMPALA under fsdp across two ranks with the clip engaged (the
    reference's clipped step differs from its unclipped one): the first
    update within 1e-5 of the JAX package's, and both ranks' gathered
    params and metrics bit-equal after each of two updates."""
    want_params, want = runs["wants"]["impala"]
    free_params, _ = runs["wants"]["impala_unclipped"]
    moved = max(float(np.abs(a - b).max()) for a, b in zip(_flat(want_params),
                                                          _flat(free_params)))
    assert moved > 10 * MLP_TOL, moved
    ranks = [r["impala"] for r in runs["ranks"][2]]
    assert ranks[0]["cross"] == ("fsdp",)
    metrics, params = ranks[0]["metrics"][0], ranks[0]["params"][0]
    assert set(metrics) == set(want)
    for key, value in want.items():
        assert metrics[key] == pytest.approx(value, rel=MLP_TOL, abs=MLP_TOL), key
    _check_params(params, want_params, _impala_case()["tree"], MLP_TOL)
    for i in range(2):
        _equal_trees(ranks[1]["params"][i], ranks[0]["params"][i])
        assert ranks[1]["metrics"][i] == ranks[0]["metrics"][i]


def test_checkpoint_round_trip_restores_each_rank_s_shards(runs):
    """A collective checkpoint, a further update, then a restore on every
    rank: each rank's shards and moments are the saved ones, bit for bit."""
    for r in runs["ranks"][2]:
        got = r["checkpoint"]
        assert got["version"] == 1
        saved, moved, restored = got["saved"]["shards"], got["moved"], got["restored"]
        assert saved.keys() == restored.keys() == moved.keys()
        assert any(not torch.equal(saved[k], moved[k]) for k in saved)
        for key, value in saved.items():
            assert restored[key].dtype == value.dtype and torch.equal(restored[key], value), key


def _single_process(runs, tmp_path):
    """A single-process REINFORCE of the same build holding the saved state
    (``apply_state``), and the saved dict."""
    from relayrl_tpu_torch.algorithms import build_algorithm
    from relayrl_tpu_torch.checkpoint.manager import CheckpointManager, apply_state

    saved = CheckpointManager(runs["ckpt"]["dir"]).restore(1)[0]
    algo = build_algorithm("REINFORCE", env_dir=str(tmp_path), device="cpu", **CKPT_KW)
    algo.train_on_batch(runs["ckpt"]["batches"][0])
    trained = {k: v.clone() for k, v in algo.state.params.state_dict().items()}
    algo.state = apply_state(algo.state, saved["train"])
    return algo, saved, trained


def test_checkpoint_equals_single_process_save(runs, tmp_path):
    """The saved train state is the unplaced layout: a single-process
    learner that loads it captures it back equal tensor for tensor (keys,
    dtypes, shapes, values, the optimizers' groups and steps), and its
    params are the single-process update's within 1e-5 (f32)."""
    from relayrl_tpu_torch.checkpoint.manager import capture_state

    algo, saved, trained = _single_process(runs, tmp_path)
    again = capture_state(algo.state)
    assert again.keys() == saved["train"].keys()

    def equal(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                equal(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), path
        else:
            assert a == b, path

    equal(again, saved["train"], "train")
    for key, value in trained.items():
        torch.testing.assert_close(saved["train"]["params"][key], value, rtol=0, atol=MLP_TOL)


def test_bundle_equals_single_process_bundle(runs, tmp_path):
    """Both ranks' bundles of the checkpointed state are byte-equal to the
    single-process bundle of the same state."""
    algo, _, _ = _single_process(runs, tmp_path)
    want = algo.bundle().to_bytes()
    for r in runs["ranks"][2]:
        assert r["checkpoint"]["saved"]["bundle"] == want
