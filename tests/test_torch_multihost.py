"""The port's multi-process learner on the CPU: two ``gloo`` ranks.

Two OS processes run ``tests/_torch_multihost_worker.py`` against a real
``torch.distributed`` process group (the counterpart of
``tests/test_multihost.py``), and this process holds what they computed:

* the coordinator's broadcast, bit-equal on both ranks;
* ``mlp_discrete`` [16, 16] REINFORCE at B 8, T 16 over ``{"dp": 2 ranks,
  "fsdp": 2}`` (two CPU devices a rank) against the JAX package's unsharded
  ``make_reinforce_update`` on the same params and batch, f32 within 1e-5;
* a transformer (d_model 32, 1 layer, 2 heads, T 64, the kernels' plain
  versions on the CPU) whose rank-1 rows are mostly padding, against the
  JAX update within ``tests/test_flash.py``'s bars (2e-5 on the forward's
  metrics, 5e-5 on the params the gradients moved): each rank's losses
  are its rows' sums over the global count;
* DQN and SAC, 2 sampled batches each, against the port's single-process
  updates on the same batches (SAC's noise drawn whole on every rank);
  PPO (4 minibatches of 2 rows, so a rank may hold none of a minibatch's
  rows) and IMPALA, 2 epoch batches each, the same way;

and, after every update, both ranks' params bit-equal.
"""

import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _util import free_port
from relayrl_tpu.algorithms.reinforce import ReinforceState as JaxState
from relayrl_tpu.algorithms.reinforce import make_optimizers as jax_make_optimizers
from relayrl_tpu.algorithms.reinforce import make_reinforce_update as jax_make_update
from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu_torch.algorithms import build_algorithm
from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.weights import params_to_jax

_WORKER = os.path.join(os.path.dirname(__file__), "_torch_multihost_worker.py")
HP = {"pi_lr": 3e-4, "vf_lr": 1e-3, "vf_iters": 4, "gamma": 0.99, "lam": 0.95}
MLP_TOL = 1e-5                       # f32, the same arithmetic in another order
FWD_TOL, GRAD_TOL = 2e-5, 5e-5       # tests/test_flash.py:29,50
OFF_TOL = 1e-5
OFF_KW = {"obs_dim": 5, "hidden_sizes": [16, 16], "batch_size": 8, "seed": 4}


def _jax_update(arch, tree, batch):
    policy = jax_build_policy(arch)
    # jaxlint: disable=JAX05 - one update on a tiny state; no donation
    update = jax.jit(jax_make_update(policy, HP["pi_lr"], HP["vf_lr"], HP["vf_iters"],
                                     HP["gamma"], HP["lam"], True))
    tx_pi, tx_vf = jax_make_optimizers(tree, HP["pi_lr"], HP["vf_lr"])
    state = JaxState(params=tree, pi_opt_state=tx_pi.init(tree),
                     vf_opt_state=tx_vf.init(tree), rng=jax.random.PRNGKey(0),
                     step=jnp.int32(0))
    new, metrics = update(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, new.params),
            {k: float(v) for k, v in metrics.items()})


def _batch(rng, b, t, obs, act, lengths):
    valid = (np.arange(t)[None] < np.asarray(lengths)[:, None]).astype(np.float32)
    return {
        "obs": rng.standard_normal((b, t, obs)).astype(np.float32) * valid[..., None],
        "act": (rng.integers(0, act, (b, t)) * valid).astype(np.int32),
        "act_mask": np.ones((b, t, act), np.float32),
        "rew": rng.standard_normal((b, t)).astype(np.float32) * valid,
        "val": rng.standard_normal((b, t)).astype(np.float32) * valid,
        "logp": -rng.random((b, t)).astype(np.float32) * valid,
        "valid": valid,
        "last_val": rng.standard_normal(b).astype(np.float32) * 0.5,
    }


def _on_policy_cases():
    rng = np.random.default_rng(42)
    mlp = {"kind": "mlp_discrete", "obs_dim": 6, "act_dim": 3,
           "hidden_sizes": [16, 16], "activation": "tanh", "has_critic": True,
           "precision": "float32"}
    transformer = {"kind": "transformer_discrete", "obs_dim": 6, "act_dim": 3,
                   "d_model": 32, "n_layers": 1, "n_heads": 2, "max_seq_len": 64,
                   "attention": "flash", "has_critic": True, "precision": "float32"}
    cases = []
    for arch, mesh, local, t, lengths in (
            (mlp, {"dp": -1, "fsdp": 2}, 2, 16, [16] * 8),
            # Rank 1's rows (4-7) are mostly padding: its share of the
            # count is small, and the losses must still use the global one.
            (transformer, {"dp": -1}, 1, 64, [64, 60, 47, 33, 5, 3, 1, 2])):
        # The port's init as a flax tree (JAX's eager init compiles op by op).
        tree = params_to_jax(build_policy(arch, "cpu").init_params(
            torch.Generator().manual_seed(3)))
        cases.append({"kind": "on_policy", "arch": arch, "tree": tree, "hp": HP,
                      "mesh": mesh, "local_devices": local,
                      "batch": _batch(rng, 8, t, 6, 3, lengths)})
    return cases


def _algorithm_cases():
    rng = np.random.default_rng(7)
    cases = []
    for algo, kw in (("PPO", {"minibatch_count": 4, "train_iters": 2, "target_kl": 0.05}),
                     ("IMPALA", {})):
        batches = [_batch(rng, 8, 16, OFF_KW["obs_dim"], 3,
                          [16, 11, 16, 4, 9, 16, 2, 13]) for _ in range(2)]
        cases.append({"kind": "algorithm", "algo": algo,
                      "kwargs": {"obs_dim": OFF_KW["obs_dim"], "act_dim": 3,
                                 "hidden_sizes": [16, 16], "traj_per_epoch": 8,
                                 "seed": 5, "seed_salt": 0, **kw},
                      "batches": batches})
    for algo, act_dim, kw in (("DQN", 2, {}),
                              ("SAC", 2, {"discrete": False, "act_limit": 1.0})):
        b = OFF_KW["batch_size"]
        batches = []
        for _ in range(2):
            act = (rng.integers(0, act_dim, b).astype(np.int32) if algo == "DQN"
                   else rng.uniform(-1, 1, (b, act_dim)).astype(np.float32))
            batches.append({
                "obs": rng.standard_normal((b, OFF_KW["obs_dim"])).astype(np.float32),
                "act": act,
                "rew": rng.standard_normal(b).astype(np.float32),
                "obs2": rng.standard_normal((b, OFF_KW["obs_dim"])).astype(np.float32),
                "mask2": np.ones((b, act_dim), np.float32),
                "done": (rng.random(b) < 0.2).astype(np.float32),
            })
        cases.append({"kind": "algorithm", "algo": algo,
                      "kwargs": {**OFF_KW, "act_dim": act_dim, **kw},
                      "batches": batches})
    return cases


def _start_ranks(tmp_path, spec) -> list[subprocess.Popen]:
    case_file = tmp_path / "cases.pkl"
    with open(case_file, "wb") as f:
        pickle.dump(spec, f)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(rank), str(port), str(case_file), str(tmp_path)],
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for rank in range(2)]
    return procs


def _wait_ranks(tmp_path, procs) -> list[dict]:
    deadline = time.monotonic() + 240
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
        assert f"TORCH_MULTIHOST_OK rank={rank}" in out, out[-4000:]
    results = []
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _leaves(tree):
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for path in la:
        assert la[path].dtype == lb[path].dtype and np.array_equal(la[path], lb[path]), path


def _check_params(got, want, init, atol):
    """Every leaf within ``atol``, except the key third of a qkv bias:
    its gradient is zero in exact arithmetic (a softmax does not change when
    one constant is added to all of a query's scores), so each side takes
    Adam's normalized step on rounding noise and is held to Adam's step
    bound, ``pi_lr`` (tests/test_torch_reinforce.py)."""
    g, w, i = _leaves(got), _leaves(want), _leaves(init)
    assert g.keys() == w.keys()
    for path in g:
        if path.endswith("['qkv']['bias']"):
            d = g[path].shape[0] // 3
            for side in (g, w):
                np.testing.assert_array_less(
                    np.abs(side[path][d:2 * d] - i[path][d:2 * d]),
                    HP["pi_lr"] * (1 + 1e-3))
            for part in (slice(0, d), slice(2 * d, None)):
                np.testing.assert_allclose(g[path][part], w[path][part], atol=atol,
                                           rtol=0, err_msg=path)
        else:
            np.testing.assert_allclose(g[path], w[path], atol=atol, rtol=0,
                                       err_msg=path)


def test_two_ranks_match_the_reference(tmp_cwd):
    tmp_path = tmp_cwd
    rng = np.random.default_rng(0)
    sent = {"obs": rng.standard_normal((8, 16, 6)).astype(np.float32),
            "act": rng.integers(0, 3, (8, 16)).astype(np.int32),
            "desc": np.array([1, 8, 16], np.int64),
            "flags": rng.random(5) < 0.5,
            "nested": [torch.arange(6, dtype=torch.bfloat16),
                       (torch.randn(3, 2, generator=torch.Generator().manual_seed(1)),)]}
    on_cases, off_cases = _on_policy_cases(), _algorithm_cases()
    procs = _start_ranks(tmp_path, {"broadcast": sent, "cases": on_cases + off_cases})
    # The references run while the ranks do.
    wants = [_jax_update(case["arch"], case["tree"], case["batch"]) for case in on_cases]
    ranks = _wait_ranks(tmp_path, procs)

    # The broadcast: rank 1 passed zeros and holds rank 0's bytes.
    for got in (r["broadcast"] for r in ranks):
        for key in ("obs", "act", "desc", "flags"):
            assert got[key].dtype == sent[key].dtype
            assert np.array_equal(got[key], sent[key]), key
        assert got["nested"][0].dtype == torch.bfloat16
        assert torch.equal(got["nested"][0], sent["nested"][0])
        assert torch.equal(got["nested"][1][0], sent["nested"][1][0])

    # On-policy: both ranks bit-equal, and the JAX package's single-process
    # update within the bars.
    for i, case in enumerate(on_cases):
        r0, r1 = ranks[0]["cases"][i], ranks[1]["cases"][i]
        assert r0["step"] == r1["step"] == 1
        _equal_trees(r0["params"], r1["params"])
        assert r0["metrics"] == r1["metrics"]
        want_params, want = wants[i]
        mlp = case["arch"]["kind"] == "mlp_discrete"
        fwd_tol, grad_tol = (MLP_TOL, MLP_TOL) if mlp else (FWD_TOL, GRAD_TOL)
        assert set(r0["metrics"]) == set(want)
        for key, value in want.items():
            assert r0["metrics"][key] == pytest.approx(value, rel=fwd_tol, abs=fwd_tol), key
        _check_params(r0["params"], want_params, case["tree"], grad_tol)

    # Whole algorithms: both ranks bit-equal, and the port's
    # single-process updates on the same batches within the bar.
    for j, case in enumerate(off_cases):
        r0, r1 = (ranks[k]["cases"][len(on_cases) + j] for k in range(2))
        assert r0["version"] == r1["version"] == len(case["batches"])
        assert r0["metrics"] == r1["metrics"]
        for field in r0["trees"]:
            _equal_trees(r0["trees"][field], r1["trees"][field])
        algo = build_algorithm(case["algo"], env_dir=str(tmp_path / f"single_{j}"),
                               device="cpu", **case["kwargs"])
        metrics = []
        for batch in case["batches"]:
            algo.train_on_batch(batch)
            metrics.append(read_metrics(algo._last_metrics))
        for got, want in zip(r0["metrics"], metrics):
            for key, value in want.items():
                assert got[key] == pytest.approx(value, rel=OFF_TOL, abs=OFF_TOL), key
        want_trees = (algo.state_trees() if hasattr(algo, "state_trees")
                      else {"params": params_to_jax(algo.state.params)})
        assert want_trees.keys() == r0["trees"].keys()
        assert r0["version"] == algo.version
        for field, tree in want_trees.items():
            g, w = _leaves(r0["trees"][field]), _leaves(tree)
            for path in w:
                np.testing.assert_allclose(g[path], w[path], atol=OFF_TOL, rtol=0,
                                           err_msg=f"{case['algo']} {field}{path}")
