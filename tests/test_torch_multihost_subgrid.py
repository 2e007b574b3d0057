"""Process blocks that are not a sub-grid of the mesh, on the CPU: ``gloo``
ranks whose entries straddle the mesh's lines.

OS processes run ``tests/_torch_multihost_subgrid_worker.py`` against a
real ``torch.distributed`` group (the pattern of
``tests/test_torch_multihost_pp_split.py``), one spawn a world size, and
this process holds what they computed against the JAX package's update on
the same mesh of the conftest's virtual devices and the port's
single-process update on the same spec:

* ``{"dp": 3, "fsdp": 2}`` over 2 processes of 3: rank 0 holds dp 0 whole
  and fsdp 0 of dp 1, rank 1 the rest; each holds both fsdp coordinates,
  so every split parameter whole (no gather), and the data group is both
  ranks (the flash transformer of ``tests/test_torch_sharding.py``);
* ``{"dp": 3, "sp": 2}`` over 2 x 3, with and without ``shard_time``: dp
  1's ring crosses (sp 0 on rank 0, sp 1 on rank 1), rank 0 accounts for
  dp 1's rows and rank 1 computes them with a zero ``valid`` mask (the
  ring transformer at T 16, whose chunks of 8 take the flash ring's plain
  versions);
* ``{"dp": 3, "sp": 4}`` over 4 x 3: every ring crosses, ranks 1 and 2
  each sit in two, rank 3 accounts for no rows (T 32; the JAX package's update
  on ``{"dp": 3, "sp": 2}``: the conftest holds 8 devices);
* PPO through a server's learner (``enable_multihost``) over ``{"dp": 3,
  "sp": 2}`` and ``{"dp": 3, "sp": 4}``: each minibatch's rows grouped by
  data cell, each ring fed its cell's rows (none, for some minibatches),
  against the port's single-process PPO on the same spec.

For each update: within ``check_update``'s bars of the JAX package's
update and of the port's single-process update (dp crosses, so the data
group's sums add the ranks' parts in another order than one process's
reductions: not bit for bit), the ranks bit-equal after each of two
updates, each rank holding every block of every parameter with its
moments, the collectives the schedule says. A collective checkpoint
round-trips, equals a single-process save, and its bundle is the
single-process bundle byte for byte. A split parameter that a rank would
hold only in part (``{"dp": 1, "fsdp": 2, "tp": 3}`` over 3 x 2,
``{"dp": 2, "fsdp": 3}`` over 3 x 2) is refused on every rank. The layouts (owners, lines, per-line
shard indices, rows, groups) are held against the JAX package's reshape
of its devices with the topology stubbed.
"""

import itertools
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
from test_torch_multihost import _batch as _episode_batch
from test_torch_multihost import _equal_trees
from test_torch_sharding import ATOL, OBS, ACT, RTOL, _arch, _batch, check_update
from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
from relayrl_tpu_torch.algorithms.reinforce import (
    ReinforceState,
    make_optimizers,
    make_reinforce_update,
)
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.parallel import (
    context,
    distributed,
    make_mesh,
    make_sharded_update,
    place_state,
)
from relayrl_tpu_torch.parallel.mesh import AXES, CrossProcessAxisError
from relayrl_tpu_torch.weights import params_to_jax

_WORKER = os.path.join(os.path.dirname(__file__), "_torch_multihost_subgrid_worker.py")
HP = {"pi_lr": 3e-4, "vf_lr": 1e-3, "vf_iters": 1, "gamma": 0.99, "lam": 0.95}
TRANSFORMER = _arch("transformer_discrete")
# T 16 over sp 2 and T 32 over sp 4: chunks of 8, the flash ring's tiles.
RING = {**TRANSFORMER, "attention": "ring", "max_seq_len": 16}
RING4 = {**RING, "max_seq_len": 32}
# Hidden widths that tp 3 and fsdp 2 split.
MLP = {"kind": "mlp_discrete", "obs_dim": 8, "act_dim": 4, "hidden_sizes": [12, 12],
       "has_critic": True}
ROWS = 12
# name: (arch, mesh, devices a rank, processes, shard_time, crossing axes)
CASES = {
    "dp3_fsdp2": (TRANSFORMER, {"dp": 3, "fsdp": 2}, 3, 2, False, ("dp", "fsdp")),
    "dp3_sp2": (RING, {"dp": 3, "sp": 2}, 3, 2, False, ("dp", "sp")),
    "dp3_sp2_time": (RING, {"dp": 3, "sp": 2}, 3, 2, True, ("dp", "sp")),
    "dp3_sp4": (RING4, {"dp": 3, "sp": 4}, 3, 4, True, ("dp", "sp")),
}
# The layouts whose blocks straddle lines: (spec, devices a rank, processes).
LAYOUTS = {
    "dp3_fsdp2": ({"dp": 3, "fsdp": 2}, 3, 2),
    "dp3_sp2": ({"dp": 3, "sp": 2}, 3, 2),
    "dp3_sp4": ({"dp": 3, "sp": 4}, 3, 4),
    "fsdp2_tp3": ({"dp": 1, "fsdp": 2, "tp": 3}, 2, 3),
    "dp2_fsdp3": ({"dp": 2, "fsdp": 3}, 2, 3),
}
# The conftest's 8 devices hold no 12-entry mesh: the JAX package's update
# of the same model and batch on a mesh they hold (the same function).
JAX_MESH = {"dp3_sp4": {"dp": 3, "sp": 2}}
CKPT = {
    "dp3_fsdp2": ({"obs_dim": OBS, "act_dim": ACT, "model_kind": "transformer_discrete",
                   "d_model": 16, "n_layers": 4, "n_heads": 2, "max_seq_len": 8,
                   "attention": "flash", "traj_per_epoch": ROWS, "train_vf_iters": 1,
                   "with_vf_baseline": True, "seed": 5, "seed_salt": 0},
                  {"dp": 3, "fsdp": 2}, 3, 2, 8),
    "dp3_sp2": ({"obs_dim": OBS, "act_dim": ACT, "model_kind": "transformer_discrete",
                 "d_model": 16, "n_layers": 4, "n_heads": 2, "max_seq_len": 16,
                 "attention": "ring", "traj_per_epoch": ROWS, "train_vf_iters": 1,
                 "with_vf_baseline": True, "seed": 5, "seed_salt": 0},
                {"dp": 3, "sp": 2}, 3, 2, 16),
}
# PPO, 4 minibatches of 3 rows, 2 sweeps an epoch, 2 epochs: (T, mesh,
# devices a rank, processes).
PPO_KW = {"obs_dim": OBS, "act_dim": ACT, "model_kind": "transformer_discrete",
          "d_model": 16, "n_layers": 2, "n_heads": 2, "attention": "ring",
          "traj_per_epoch": ROWS, "minibatch_count": 4, "train_iters": 2,
          "target_kl": 10.0, "seed": 5, "seed_salt": 0}
PPO = {
    "dp3_sp2": (16, {"dp": 3, "sp": 2}, 3, 2),
    "dp3_sp4": (32, {"dp": 3, "sp": 4}, 3, 4),
}
# Layouts in which a rank would hold a split parameter in part: (arch,
# spec, devices a rank, processes).
PARTIAL = {
    "fsdp2_tp3": (MLP, {"dp": 1, "fsdp": 2, "tp": 3}, 2, 3),
    "dp2_fsdp3": (TRANSFORMER, {"dp": 2, "fsdp": 3}, 2, 3),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the workers run: a CPU reduction's order
    depends on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(arch, seed=0):
    from relayrl_tpu.models import build_policy as jax_build_policy

    return jax.tree.map(np.asarray, jax_build_policy(arch).init_params(
        jax.random.PRNGKey(seed)))


def _rows(arch):
    t = arch.get("max_seq_len", 8)
    batch = _batch(b=ROWS, t=t, seed=26, obs=arch["obs_dim"], act=arch["act_dim"])
    # Uneven episodes, so a row's place in the batch matters.
    lengths = np.array([t, t - 1, 3, t, 2, t - 3, 1, t, 5, t - 2, t, 4])
    valid = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    return {**batch, "valid": valid, "rew": batch["rew"] * valid}


def _jax_update(arch, tree, spec, batch, shard_time):
    """The JAX package's sharded update on ``spec`` (the conftest's virtual
    CPU devices, as many as the spec names)."""
    from relayrl_tpu.algorithms.reinforce import ReinforceState as JaxState
    from relayrl_tpu.algorithms.reinforce import make_optimizers as jax_make_optimizers
    from relayrl_tpu.algorithms.reinforce import make_reinforce_update as jax_make_update
    from relayrl_tpu.models import build_policy as jax_build_policy
    from relayrl_tpu.parallel import make_mesh as jax_make_mesh
    from relayrl_tpu.parallel import make_sharded_update as jax_make_sharded_update
    from relayrl_tpu.parallel import place_batch as jax_place_batch
    from relayrl_tpu.parallel import place_state as jax_place_state

    tx_pi, tx_vf = jax_make_optimizers(tree, HP["pi_lr"], HP["vf_lr"])
    state = JaxState(params=tree, pi_opt_state=tx_pi.init(tree), vf_opt_state=tx_vf.init(tree),
                     rng=jax.random.PRNGKey(1), step=jnp.int32(0))
    update = jax_make_update(jax_build_policy(arch), HP["pi_lr"], HP["vf_lr"], HP["vf_iters"],
                             HP["gamma"], HP["lam"], with_baseline=True)
    mesh = jax_make_mesh(spec, jax.devices()[:int(np.prod(list(spec.values())))])
    sharded = jax_make_sharded_update(update, mesh, state, donate_state=False,
                                      shard_time=shard_time)
    new, metrics = sharded(jax_place_state(state, mesh),
                           jax_place_batch(batch, mesh, shard_time=shard_time))
    return jax.tree.map(np.asarray, new.params), {k: float(v) for k, v in metrics.items()}


def _single_process(arch, tree, spec, batch, shard_time):
    """The port's single-process update on the same spec (its entries all
    this process's CPU): flax params and metrics."""
    policy = build_policy(arch, device="cpu")
    params = policy.load_params(tree)
    state = ReinforceState(params, *make_optimizers(params, HP["pi_lr"], HP["vf_lr"]))
    update = make_reinforce_update(policy, HP["vf_iters"], HP["gamma"], HP["lam"], True)
    mesh = make_mesh(spec, [torch.device("cpu")] * int(np.prod(list(spec.values()))))
    new, metrics = make_sharded_update(update, mesh, state, shard_time=shard_time)(
        place_state(state, mesh), batch)
    return params_to_jax(new.params), read_metrics(metrics)


def _single_ppo(case, workdir):
    """The port's single-process PPO over the case's spec (its entries all
    this process's CPU) on the case's batches: its initial params, then
    the metrics of each epoch, the params and the version."""
    from relayrl_tpu_torch.algorithms import build_algorithm

    algo = build_algorithm("PPO", env_dir=str(workdir), device="cpu", **case["kwargs"])
    init = params_to_jax(algo.state.params)
    spec = case["mesh"]
    algo.enable_multihost(make_mesh(spec, [torch.device("cpu")]
                                    * int(np.prod(list(spec.values())))))
    metrics = []
    for batch in case["batches"]:
        algo.train_on_batch(batch)
        metrics.append(read_metrics(algo._last_metrics))
    return init, metrics, params_to_jax(algo.state.params), algo.version


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
        assert f"TORCH_MULTIHOST_SUBGRID_OK rank={rank}" in out, out[-4000:]
    results = []
    for rank in range(len(procs)):
        with open(workdir / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn a world size (2, 3 and 4 ranks) side by side, the
    references computed while they run."""
    root = tmp_path_factory.mktemp("subgrid")
    rng = np.random.default_rng(26)
    by_world, trees, batches = {}, {}, {}
    for name, (arch, mesh, local, world, shard_time, _) in CASES.items():
        trees[name], batches[name] = _tree(arch), _rows(arch)
        by_world.setdefault(world, {})[name] = {
            "kind": "update", "arch": arch, "tree": trees[name], "hp": HP, "mesh": mesh,
            "local_devices": local, "shard_time": shard_time, "batch": batches[name]}
    ckpts = {}
    for name, (kwargs, mesh, local, world, t) in CKPT.items():
        obs, act = kwargs["obs_dim"], kwargs["act_dim"]
        lengths = [t, t - 1, 3, t, 2, t - 3, 1, t, 5, t - 2, t, 4]
        ckpts[name] = {"kind": "checkpoint", "kwargs": kwargs, "mesh": mesh,
                       "local_devices": local,
                       "dir": str(root / f"w{world}" / f"checkpoints_{name}"),
                       "batches": [_episode_batch(rng, ROWS, t, obs, act, lengths)
                                   for _ in range(2)]}
        by_world[world][f"ckpt_{name}"] = ckpts[name]
    ppos = {}
    for name, (t, mesh, local, world) in PPO.items():
        lengths = [t, t - 1, 3, t, 2, t - 3, 1, t, 5, t - 2, t, 4]
        ppos[name] = {"kind": "ppo", "kwargs": {**PPO_KW, "max_seq_len": t}, "mesh": mesh,
                      "local_devices": local,
                      "batches": [_episode_batch(rng, ROWS, t, OBS, ACT, lengths)
                                  for _ in range(2)]}
        by_world[world][f"ppo_{name}"] = ppos[name]
    procs = {world: _start(root / f"w{world}", cases, world)
             for world, cases in by_world.items()}
    deadline = time.monotonic() + 420
    try:
        wants, singles = {}, {}
        for name, (arch, mesh, _, _, shard_time, _) in CASES.items():
            wants[name] = _jax_update(arch, trees[name], JAX_MESH.get(name, mesh),
                                      batches[name], shard_time)
            singles[name] = _single_process(arch, trees[name], mesh, batches[name],
                                            shard_time)
        for name, case in ppos.items():
            singles[f"ppo_{name}"] = _single_ppo(case, root / f"single_ppo_{name}")
    except BaseException:
        for ps in procs.values():
            for p in ps:
                p.kill()
        raise
    ranks = {world: _wait(root / f"w{world}", ps, deadline) for world, ps in procs.items()}
    return {"ranks": ranks, "wants": wants, "singles": singles, "trees": trees,
            "ckpts": ckpts, "ppos": ppos}


def _ranks_of(runs, name):
    return [r[name] for r in runs["ranks"][CASES[name][3]]]


@pytest.mark.parametrize("name", list(CASES))
def test_update_matches_jax(runs, name):
    """The first update across ranks against the JAX package's sharded
    update on the same mesh (``JAX_MESH`` where the conftest's devices
    hold none), at ``check_update``'s bars."""
    want_params, want = runs["wants"][name]
    for got in _ranks_of(runs, name):
        assert got["straddles"] and got["cross"] == CASES[name][5]
        assert set(got["metrics"][0]) == set(want)
        check_update(got["params"][0], want_params, runs["trees"][name],
                     got["metrics"][0], want)


@pytest.mark.parametrize("name", list(CASES))
def test_update_matches_single_process(runs, name):
    """The first update against the port's single-process update of the
    same spec, at ``check_update``'s bars: the ranks' parts of each
    gradient and statistic are summed over the data group, in another
    order than one process's reductions over the whole batch, so the
    last bits move (as where dp crosses a sub-grid,
    ``tests/test_torch_multihost_pp.py``)."""
    single_params, single = runs["singles"][name]
    for got in _ranks_of(runs, name):
        assert set(got["metrics"][0]) == set(single)
        check_update(got["params"][0], single_params, runs["trees"][name],
                     got["metrics"][0], single)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_agree_after_each_update(runs, name):
    """After each of two updates every rank gathers the same whole params
    and reads the same metrics, bit for bit; the second update moved the
    params."""
    ranks = _ranks_of(runs, name)
    for i in range(2):
        for other in ranks[1:]:
            _equal_trees(other["params"][i], ranks[0]["params"][i])
            assert other["metrics"][i] == ranks[0]["metrics"][i]
    first, second = (jax.tree.leaves(p) for p in ranks[0]["params"])
    assert any(not np.array_equal(a, b) for a, b in zip(first, second))


def _mesh(spec, n, world, rank, monkeypatch):
    monkeypatch.setattr(distributed, "_info", {
        "multi_host": True, "process_id": rank, "num_processes": world})
    return make_mesh(spec, [torch.device("cpu")] * n)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_the_blocks_at_its_entries(runs, name):
    """Every parameter leaf is on the CPU with Adam moments of its own
    shape, and no squares sum over a split: each rank's entries cover the
    split axes (``{"dp": 3, "fsdp": 2}``: both fsdp coordinates on each
    rank), so it holds every block of every parameter and its bytes are
    the whole model's."""
    total = sum(np.size(v) for v in jax.tree.leaves(runs["trees"][name]))
    for got in _ranks_of(runs, name):
        held = 0
        for leaf, h in got["holdings"].items():
            assert h["device"] == "cpu" and h["moments"] == h["shape"], leaf
            assert h["split_comms"] == [], leaf
            held += int(np.prod(h["shape"]))
        assert held == total


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_follow_the_schedule(runs, name, monkeypatch):
    """Per update (``4 + vf_iters`` forwards through the trunk; one
    backward through it, the policy step's: a value step trains the value
    head alone): no reduce-scatter, no split all-reduce and no gather
    anywhere (the data group's sums are the learner's); on a ring that
    crosses, each forward hops ``size - 1``
    times and gathers the output once, the backward hops ``size`` times,
    gathers the input gradients once and takes the lead's output gradient
    in one broadcast; a whole ring in one rank hops never."""
    arch, spec, local, world, _, _ = CASES[name]
    forwards, backwards = 4 + HP["vf_iters"], 1
    for rank, got in enumerate(_ranks_of(runs, name)):
        comm = got["comm"]
        assert comm["scatters"] == comm["reduces"] == comm["deferred"] == 0
        assert comm["gathers"] == 0 and not got["gathers"]
        if "sp" not in spec:
            assert comm["ring_hops"] == comm["ring_leads"] == 0
            continue
        mesh = _mesh(spec, local, world, rank, monkeypatch)
        crossing = [line for line in mesh.lines("sp")
                    if len(mesh.axis_ranks("sp", line)) > 1]
        layers = arch["n_layers"]
        assert comm["ring_hops"] == len(crossing) * layers * (
            forwards * (spec["sp"] - 1) + backwards * spec["sp"])
        assert comm["ring_gathers"] == len(crossing) * layers * (forwards + backwards)
        assert comm["ring_leads"] == len(crossing) * layers * backwards


@pytest.mark.parametrize("name", list(CASES))
def test_rows_and_accounting(runs, name):
    """Each rank keeps the rows of every data cell it holds an entry of
    (contiguous, overlapping another rank's where a cell's entries are
    split), and only those it accounts for keep a nonzero ``valid``
    mask: over the ranks every row counts once."""
    arch, spec, _, world, _, _ = CASES[name]
    cells = spec["dp"] * spec.get("fsdp", 1)
    per = ROWS // cells
    counted = []
    for got in _ranks_of(runs, name):
        assert got["cells"] == list(range(got["cells"][0], got["cells"][-1] + 1))
        assert got["rows"] == per * len(got["cells"])
        assert set(got["accountable"]) <= set(got["cells"])
        counted += got["accountable"]
        assert got["valid_rows"] == per * len(got["accountable"])
    assert sorted(counted) == list(range(cells))


def _ckpt_ranks(runs, name):
    return [r[f"ckpt_{name}"] for r in runs["ranks"][CKPT[name][3]]]


@pytest.mark.parametrize("name", list(CKPT))
def test_checkpoint_round_trip_restores_each_rank(runs, name):
    """A collective checkpoint, a further update, then a restore on every
    rank: each rank's tensors (its blocks and their moments) are the saved
    ones, bit for bit."""
    for got in _ckpt_ranks(runs, name):
        assert got["version"] == 1
        saved, moved, restored = got["saved"]["tensors"], got["moved"], got["restored"]
        assert saved.keys() == restored.keys() == moved.keys()
        assert any(not torch.equal(saved[k], moved[k]) for k in saved)
        for key, value in saved.items():
            assert restored[key].dtype == value.dtype and torch.equal(restored[key], value), key


def _single_algo(runs, name, tmp_path):
    from relayrl_tpu_torch.algorithms import build_algorithm
    from relayrl_tpu_torch.checkpoint.manager import CheckpointManager, apply_state

    saved = CheckpointManager(runs["ckpts"][name]["dir"]).restore(1)[0]
    algo = build_algorithm("REINFORCE", env_dir=str(tmp_path), device="cpu",
                           **CKPT[name][0])
    algo.state = apply_state(algo.state, saved["train"])
    return algo, saved


@pytest.mark.parametrize("name", list(CKPT))
def test_checkpoint_equals_single_process_save(runs, name, tmp_path):
    """The saved train state is the unplaced layout: a single-process
    learner that loads it captures it back equal, tensor for tensor."""
    from relayrl_tpu_torch.checkpoint.manager import capture_state

    algo, saved = _single_algo(runs, name, tmp_path)
    again = capture_state(algo.state)

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
    assert not any(r["gathers"] for r in _ckpt_ranks(runs, name))


@pytest.mark.parametrize("name", list(CKPT))
def test_bundle_equals_single_process_bundle(runs, name, tmp_path):
    """Every rank's bundle of the checkpointed state is byte-equal to the
    single-process bundle of the same state."""
    algo, _ = _single_algo(runs, name, tmp_path)
    want = algo.bundle().to_bytes()
    for r in _ckpt_ranks(runs, name):
        assert r["saved"]["bundle"] == want


def _ppo_ranks(runs, name):
    return [r[f"ppo_{name}"] for r in runs["ranks"][PPO[name][3]]]


@pytest.mark.parametrize("name", list(PPO))
def test_ppo_matches_single_process(runs, name):
    """PPO's two epochs across ranks against the port's single-process PPO
    on the same spec and batches: every epoch's metrics at
    ``check_update``'s bars and every param at its leaf bars (each
    minibatch's rows are summed over the data group, in another order),
    but the key third of each qkv bias, whose gradient is zero in exact
    arithmetic: there each side is held to Adam's step bound over the
    run's pi steps from the shared initial params."""
    init, want_metrics, want_params, version = runs["singles"][f"ppo_{name}"]
    steps = 2 * PPO_KW["minibatch_count"] * PPO_KW["train_iters"]
    for got in _ppo_ranks(runs, name):
        assert got["version"] == version == 2
        for got_m, want_m in zip(got["metrics"], want_metrics):
            assert set(got_m) == set(want_m)
            for key, value in want_m.items():
                assert got_m[key] == pytest.approx(value, rel=1e-4, abs=1e-6), key
        g, w, i = (dict(jax.tree_util.tree_flatten_with_path(t)[0])
                   for t in (got["params"], want_params, init))
        assert g.keys() == w.keys()
        for path in g:
            a, b = g[path], w[path]
            if jax.tree_util.keystr(path).endswith("['qkv']['bias']"):
                d = a.shape[-1] // 3
                for side in (a, b):
                    np.testing.assert_array_less(np.abs(side[..., d:2 * d] - i[path][..., d:2 * d]),
                                                 steps * 3e-4 * (1 + 1e-3))
                a, b = (np.delete(x, np.s_[d:2 * d], axis=-1) for x in (a, b))
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(PPO))
def test_ppo_ranks_agree(runs, name):
    """After PPO's epochs every rank holds the same params and read the
    same metrics, bit for bit."""
    ranks = _ppo_ranks(runs, name)
    for other in ranks[1:]:
        _equal_trees(other["params"], ranks[0]["params"])
        assert other["metrics"] == ranks[0]["metrics"]


@pytest.mark.parametrize("name", list(PPO))
def test_ppo_feeds_each_ring_its_cells_rows(runs, name):
    """Each minibatch's rows go to a rank's data cells by cell: every rank
    that holds a cell counts the same rows there (the rows a crossing
    ring's holders hop and gather), the counts of a minibatch add up to
    its rows over the cells, and some minibatch left a crossing ring with
    no row (skipped by all its holders) while others fed it rows."""
    ranks = _ppo_ranks(runs, name)
    mb = ROWS // PPO_KW["minibatch_count"]
    n = len(ranks[0]["fed"])
    assert n > 0 and all(len(r["fed"]) == n for r in ranks)
    shared = set(ranks[0]["cells"]) & set(ranks[1]["cells"])
    assert shared
    for k in range(n):
        per_cell = {}
        for r in ranks:
            assert len(r["fed"][k]) == len(r["cells"])
            for cell, rows in zip(r["cells"], r["fed"][k]):
                assert per_cell.setdefault(cell, rows) == rows, (k, cell)
        assert sum(per_cell.values()) == mb
    fed = [ranks[0]["fed"][k][ranks[0]["cells"].index(min(shared))] for k in range(n)]
    assert 0 in fed and any(fed)


@pytest.mark.parametrize("name,rank", [(name, rank) for name, (_, _, _, world)
                                       in PARTIAL.items() for rank in range(world)])
def test_a_split_parameter_held_in_part_is_refused(monkeypatch, name, rank):
    """Where a rank's entries would give it only part of a split
    parameter across the split axis's lines, placing the model raises on
    every rank (so none waits on another), naming ROADMAP.md queue 1;
    the mesh itself builds."""
    arch, spec, n, world = PARTIAL[name]
    mesh = _mesh(spec, n, world, rank, monkeypatch)
    assert mesh.straddles
    policy = build_policy(arch, device="cpu")
    params = policy.init_params(torch.Generator().manual_seed(0))
    state = ReinforceState(params, *make_optimizers(params, HP["pi_lr"], HP["vf_lr"]))
    with pytest.raises(CrossProcessAxisError, match="held in part.*queue 1"):
        place_state(state, mesh)


def _jax_owners(spec, n, world):
    """Each entry's rank under the JAX package's mesh: its reshape of
    ``jax.devices()`` in process order, ``n`` devices a process (beyond
    the conftest's 8 devices, its shape's reshape of as many ids)."""
    from relayrl_tpu.parallel import make_mesh as jax_make_mesh
    from relayrl_tpu.parallel.mesh import resolve_mesh_shape as jax_shape

    if n * world <= len(jax.devices()):
        mesh = jax_make_mesh(spec, jax.devices()[:n * world])
        ids = np.vectorize(lambda d: d.id)(mesh.devices)
    else:
        shape = jax_shape(spec, n * world)
        ids = np.arange(n * world).reshape([shape[ax] for ax in AXES])
    return ids // n


_LAYOUT_CASES = [(name, rank) for name, (_, _, world) in LAYOUTS.items()
                 for rank in range(world)]


@pytest.mark.parametrize("name,rank", _LAYOUT_CASES)
def test_layout_follows_the_jax_reshape(monkeypatch, name, rank):
    """The owners are the JAX package's reshape of its devices, ``n`` a
    process; the mesh straddles; this rank's lines along each crossing
    axis are those of the reshape on which it owns an entry, its shard
    indices on each line the entries it owns there, its data cells those
    it owns an entry of and the ones it accounts for those no lower rank
    owns an entry of."""
    spec, n, world = LAYOUTS[name]
    want = _jax_owners(spec, n, world)
    mesh = _mesh(spec, n, world, rank, monkeypatch)
    assert mesh.straddles and np.array_equal(mesh.owners, want)
    for axis in mesh.cross_axes:
        a = AXES.index(axis)
        others = [range(s) if i != a else [None] for i, s in enumerate(want.shape)]
        lines = []
        for line in itertools.product(*others):
            index = tuple(slice(None) if c is None else c for c in line)
            if (want[index] == rank).any():
                lines.append(line)
                assert mesh.shard_indices(axis, line) == [
                    int(i) for i in np.flatnonzero(want[index] == rank)]
                assert mesh.axis_ranks(axis, line) == tuple(dict.fromkeys(
                    int(r) for r in want[index]))
        assert mesh.lines(axis) == lines
    cells = want.reshape(spec["dp"] * spec.get("fsdp", 1), -1)
    assert mesh.cells == [int(c) for c in np.flatnonzero((cells == rank).any(axis=1))]
    assert mesh.accountable_cells == [c for c in mesh.cells if cells[c].min() == rank]


@pytest.mark.parametrize("name,rank", _LAYOUT_CASES)
def test_groups_of_a_straddling_rank(monkeypatch, name, rank):
    """With the runtime stubbed, a rank's group over a crossing axis on
    each of its lines is the group of that line's ranks (a rank in two
    lines of one axis has two), every such group is among the ones every
    rank forms, and the data group is every rank with this rank's data
    cells, from which the global rows, this rank's row range and its share
    of a mean follow."""
    spec, n, world = LAYOUTS[name]
    mesh = _mesh(spec, n, world, rank, monkeypatch)
    monkeypatch.setattr(distributed, "_runtime",
                        distributed._Runtime(rank, world, [], "gloo", None))
    formed = {ranks: object() for axis in mesh.cross_axes
              for ranks in mesh.axis_groups(axis)}
    distributed._runtime.groups.update(formed)
    for axis in mesh.cross_axes:
        for line in mesh.lines(axis):
            ranks = mesh.axis_ranks(axis, line)
            comm = distributed.axis_comm(mesh, axis, line=line)
            if len(ranks) == 1:
                assert comm is None
                continue
            assert comm.ranks == ranks and comm.rank == ranks.index(rank)
            if len(ranks) < world:
                assert comm.group is formed[ranks]
    group = distributed.data_parallel_group(mesh)
    assert (group.rank, group.size, group.dp) == (rank, world, None)
    cells, total = mesh.cells, spec["dp"] * spec.get("fsdp", 1)
    assert group.cells == (cells[0], len(cells), total)
    with context.use_dp_group(group):
        assert context.dp_global_rows(2 * len(cells)) == 2 * total
        assert context.dp_row_range(2 * total) == (2 * cells[0], 2 * (cells[-1] + 1))
        rows = torch.ones(2 * len(cells), 3)
        assert context.dp_mean(rows) == pytest.approx(len(cells) / total)


@pytest.mark.parametrize("spec,n,world", [({"dp": 3, "pp": 2}, 3, 2),
                                          ({"dp": 1, "fsdp": 2, "pp": 3}, 2, 3)])
def test_a_straddled_pipeline_is_refused(monkeypatch, spec, n, world):
    """A block that straddles the lines of a crossing pp axis is still
    refused, on every rank, naming ROADMAP.md queue 1."""
    for rank in range(world):
        with pytest.raises(CrossProcessAxisError, match="pipeline.*queue 1"):
            _mesh(spec, n, world, rank, monkeypatch)
