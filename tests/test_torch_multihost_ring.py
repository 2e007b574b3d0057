"""The port's sequence-parallel ring across two processes, on the CPU.

Two OS processes run ``tests/_torch_multihost_ring_worker.py`` against a
real ``torch.distributed`` process group (gloo), the counterpart of the
ring section of ``tests/_multihost_worker.py``: the reference worker's
ring transformer (d_model 32, 1 layer, 2 heads, T 64, ``train_vf_iters``
1, B 2) trained over ``{"dp": 1, "sp": 8}``, 4 CPU devices a rank, so the
ring's K/V chunks cross the process boundary. Its chunk of 8 tiles, so
the kernels' plain versions run (K4-K6's, through the wrappers). This
process holds what the ranks computed:

* rank 1 started from zeros and holds the coordinator's batch;
* both ranks' params and metrics bit-equal;
* the update bit-equal to the port's single-process ``{"sp": 8}`` update
  over ``[cpu] * 8`` (one intra-op thread on both sides);
* the update within ``tests/test_flash.py``'s bars of the JAX package's
  update on the same params and batch;
* each rank ran its shards' chunk calls, hopped and gathered as many
  times as the ring's schedule says.
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
from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
from relayrl_tpu_torch.algorithms.reinforce import (
    ReinforceState,
    make_optimizers,
    make_reinforce_update,
)
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.parallel import make_mesh, make_sharded_update, place_state
from relayrl_tpu_torch.weights import params_to_jax

_WORKER = os.path.join(os.path.dirname(__file__), "_torch_multihost_ring_worker.py")
OBS, ACT, B, T, SP = 6, 3, 2, 64, 8
ARCH = {"kind": "transformer_discrete", "obs_dim": OBS, "act_dim": ACT,
        "d_model": 32, "n_layers": 1, "n_heads": 2, "max_seq_len": T,
        "has_critic": True, "attention": "ring", "precision": "float32"}
# tests/_multihost_worker.py's ring section: train_vf_iters 1.
HP = {"pi_lr": 3e-4, "vf_lr": 1e-3, "vf_iters": 1, "gamma": 0.99, "lam": 0.95}
FWD_TOL = 2e-5   # tests/test_flash.py:29, on the metrics
GRAD_TOL = 5e-5  # tests/test_flash.py:50, on the params


def _batch():
    """The reference worker's ring batch (``np.random.default_rng(9)``)."""
    rng = np.random.default_rng(9)
    return {
        "obs": rng.standard_normal((B, T, OBS)).astype(np.float32),
        "act": rng.integers(0, ACT, (B, T)).astype(np.int32),
        "act_mask": np.ones((B, T, ACT), np.float32),
        "rew": np.ones((B, T), np.float32),
        "val": np.zeros((B, T), np.float32),
        "logp": np.zeros((B, T), np.float32),
        "valid": np.ones((B, T), np.float32),
        "last_val": np.zeros((B,), np.float32),
    }


def _jax_update(tree, batch):
    policy = jax_build_policy(ARCH)
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


def _single_process_update(tree, batch):
    """The port's ``{"sp": 8}`` update over ``[cpu] * 8`` in this process,
    on one intra-op thread as the ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        policy = build_policy(ARCH, device="cpu")
        params = policy.load_params(tree)
        state = ReinforceState(params, *make_optimizers(params, HP["pi_lr"], HP["vf_lr"]))
        update = make_reinforce_update(policy, HP["vf_iters"], HP["gamma"], HP["lam"], True)
        mesh = make_mesh({"sp": SP}, [torch.device("cpu")] * SP)
        sharded = make_sharded_update(update, mesh, state, shard_time=True)
        new, metrics = sharded(place_state(state, mesh), batch)
        return params_to_jax(new.params), read_metrics(metrics)
    finally:
        torch.set_num_threads(threads)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _run_ranks(tmp_path, case) -> list[dict]:
    case_file = tmp_path / "case.pkl"
    with open(case_file, "wb") as f:
        pickle.dump(case, f)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(rank), str(port), str(case_file), str(tmp_path)],
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for rank in range(2)]
    return procs


def _wait(tmp_path, procs) -> list[dict]:
    deadline = time.monotonic() + 240
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        hung = [p.communicate()[0] or "" for p in procs[len(outs):]]
        pytest.fail("ring workers hung:\n" + "\n---\n".join(outs + hung))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert f"TORCH_MULTIHOST_RING_OK rank={rank}" in out, out[-4000:]
    results = []
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def test_two_ranks_train_the_ring_across_processes(tmp_cwd):
    tmp_path = tmp_cwd
    tree = params_to_jax(build_policy(ARCH, "cpu").init_params(
        torch.Generator().manual_seed(5)))
    batch = _batch()
    procs = _run_ranks(tmp_path, {"arch": ARCH, "tree": tree, "hp": HP, "batch": batch})
    # The references run while the ranks do.
    single_params, single_metrics = _single_process_update(tree, batch)
    want_params, want_metrics = _jax_update(tree, batch)
    ranks = _wait(tmp_path, procs)

    # The broadcast: rank 1 passed zeros and holds the coordinator's batch.
    for r in ranks:
        for key, value in batch.items():
            assert r["batch"][key].dtype == value.dtype
            assert np.array_equal(r["batch"][key], value), key

    # The ranks agree bit for bit, and with the single-process ring.
    r0, r1 = ranks
    assert r0["step"] == r1["step"] == 1
    assert r0["metrics"] == r1["metrics"] == single_metrics
    got, other, single = _leaves(r0["params"]), _leaves(r1["params"]), _leaves(single_params)
    assert got.keys() == other.keys() == single.keys()
    for path in got:
        assert np.array_equal(got[path], other[path]), path
        assert np.array_equal(got[path], single[path]), path

    # The JAX package's update within the flash tests' bars.
    assert set(r0["metrics"]) == set(want_metrics)
    for key, value in want_metrics.items():
        # A DeltaLoss metric is a difference of two values of its loss
        # (LossV ~908 here, whose f32 ulp is 6.1e-5): FWD_TOL holds it
        # relative to that loss, whose rounding it carries.
        scale = max(1.0, abs(want_metrics[key.replace("Delta", "")]))
        assert r0["metrics"][key] == pytest.approx(value, rel=FWD_TOL,
                                                   abs=FWD_TOL * scale), key
    want, init = _leaves(want_params), _leaves(tree)
    assert want.keys() == got.keys()
    for path in want:
        if path.endswith("['qkv']['bias']"):
            # The key third's gradient is zero in exact arithmetic (a
            # softmax does not change when one constant is added to all of
            # a query's scores): each side takes Adam's normalized step on
            # rounding noise, held to Adam's step bound, pi_lr
            # (tests/test_torch_multihost.py).
            d = got[path].shape[0] // 3
            for side in (got, want):
                np.testing.assert_array_less(
                    np.abs(side[path][d:2 * d] - init[path][d:2 * d]),
                    HP["pi_lr"] * (1 + 1e-3))
            for part in (slice(0, d), slice(2 * d, None)):
                np.testing.assert_allclose(got[path][part], want[path][part],
                                           atol=GRAD_TOL, rtol=0, err_msg=path)
        else:
            np.testing.assert_allclose(got[path], want[path], atol=GRAD_TOL, rtol=0,
                                       err_msg=path)

    # The ring's schedule per rank: each forward ring runs its shards'
    # causal pairs (rank 0 shards 0-3: 10 pairs; rank 1 shards 4-7: 26) and
    # hops SP - 1 times; the one backward ring the same pairs and SP hops.
    # One gather per forward ring, one per backward ring (the gradients).
    forwards = [r["calls"]["fwd"] // (10 if i == 0 else 26) for i, r in enumerate(ranks)]
    assert forwards[0] == forwards[1] > 0
    n = forwards[0]
    for i, r in enumerate(ranks):
        pairs = 10 if i == 0 else 26
        assert r["calls"] == {"fwd": n * pairs, "dq": pairs, "dkv": pairs}, r["calls"]
        assert r["hops"] == n * (SP - 1) + SP, r["hops"]
        assert r["gathers"] == n + 1, r["gathers"]
    assert r0["hop_bytes"] == r1["hop_bytes"] > 0
