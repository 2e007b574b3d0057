"""The GPipe pipeline across processes beside a crossing fsdp, ep, tp or sp
axis, on the CPU: four ``gloo`` ranks, each holding one pipeline stage.

OS processes run ``tests/_torch_multihost_pp_split_worker.py`` against a
real ``torch.distributed`` group (the pattern of
``tests/test_torch_multihost_pp.py``), and this process holds what they
computed. The model is ``tests/test_torch_sharding.py``'s
``transformer_pp_discrete`` (4 layers, d_model 16, 2 heads, T 8, the
flash kernels' plain versions), REINFORCE from its shared params on its
batch; one spawn of 4 ranks works through every 4-rank mesh, one of 2
ranks through the 2x2 comparisons, side by side.

* ``{"dp": 1, "fsdp": 2, "pp": 2}`` over 4 ranks of 1 CPU device: pp
  groups (0, 1) and (2, 3), fsdp groups (0, 2) and (1, 3); each rank holds
  one stage and half of every split end (the parameters outside the
  stack). Its update is bit-equal to the same mesh over 2 processes of 2
  devices (only fsdp crosses there: the stages hand off inside a rank),
  within ``check_update``'s bars of the JAX package's, the ranks agree
  after each of two updates, each holds only its stage and its half of
  the ends with their moments, the hops, gathers and reduce-scatters
  count what the schedule says; a collective checkpoint restores each
  rank bit for bit and equals a single-process save; the bundle is the
  single-process bundle byte for byte; IMPALA's clip reads the whole
  model's norm once on every rank, and its clipped update is within
  ``check_update``'s bars of the JAX package's on the same mesh.
* ``{"dp": 1, "tp": 2, "pp": 2}`` over 4 x 1, ``{"dp": 1, "ep": 2, "pp":
  4}`` and ``{"dp": 1, "sp": 2, "pp": 4}`` over 4 x 2 (with and without
  ``shard_time``): the sharding rules split no leaf of the pipeline
  family over tp (``dense_N`` kernels only) or ep (``moe`` leaves only),
  and the ring inside the pipeline is refused in both packages, so these
  are replica axes beside the pipeline: the JAX package's update on each
  equals its own pp-only update bit for bit, except sp with
  ``shard_time``, where XLA's sums over the time-split batch move the last
  bits (about 1e-4). The port's update on each equals its single-process
  pp-only update bit for bit (its batch is never cut in time), and is
  within ``check_update``'s bars of the JAX package's on the same mesh.
"""

import os
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from _util import free_port
from test_torch_multihost import _batch as _episode_batch
from test_torch_multihost import _equal_trees
from test_torch_multihost_pp import (
    CKPT_KW,
    HP,
    IMPALA_HP,
    KIND,
    _single_process,
)
from test_torch_multihost_pp import _jax_update as _jax_pp_update
from test_torch_sharding import _arch, _batch, _tree, check_update
from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.parallel import make_mesh, make_sharded_update, place_state
from relayrl_tpu_torch.weights import params_to_jax

_WORKER = os.path.join(os.path.dirname(__file__), "_torch_multihost_pp_split_worker.py")
FSDP_PP = {"dp": 1, "fsdp": 2, "pp": 2}
# name: (mesh, devices a rank, shard_time, the pp-only mesh it replicates)
REPLICA = {
    "tp_pp": ({"dp": 1, "tp": 2, "pp": 2}, 1, False, {"dp": 1, "pp": 2}),
    "ep_pp": ({"dp": 1, "ep": 2, "pp": 4}, 2, False, {"dp": 1, "pp": 4}),
    "sp_pp": ({"dp": 1, "sp": 2, "pp": 4}, 2, False, {"dp": 1, "pp": 4}),
    "sp_pp_time": ({"dp": 1, "sp": 2, "pp": 4}, 2, True, {"dp": 1, "pp": 4}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the workers run: a CPU reduction's order
    depends on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_update(spec, batch, shard_time=False):
    """The JAX package's sharded update on ``spec`` (the conftest's virtual
    CPU devices), its batch's time axis held to sp with ``shard_time``."""
    if not shard_time:
        return _jax_pp_update(spec, batch)
    import relayrl_tpu.parallel as jax_parallel

    make, place = jax_parallel.make_sharded_update, jax_parallel.place_batch
    jax_parallel.make_sharded_update = lambda *a, **k: make(*a, **k, shard_time=True)
    jax_parallel.place_batch = lambda batch, mesh: place(batch, mesh, shard_time=True)
    try:
        return _jax_pp_update(spec, batch)
    finally:
        jax_parallel.make_sharded_update, jax_parallel.place_batch = make, place


def _jax_impala(batch):
    """The JAX package's IMPALA update, the clip engaged, under its
    ``make_sharded_update`` on ``FSDP_PP`` (the conftest's virtual CPU
    devices): flax params and metrics."""
    import jax.numpy as jnp

    from relayrl_tpu.algorithms.impala import ImpalaState as JaxImpalaState
    from relayrl_tpu.algorithms.impala import make_impala_tx
    from relayrl_tpu.algorithms.impala import make_impala_update as jax_impala_update
    from relayrl_tpu.models import build_policy as jax_build_policy
    from relayrl_tpu.parallel import make_mesh as jax_make_mesh
    from relayrl_tpu.parallel import make_sharded_update as jax_make_sharded_update
    from relayrl_tpu.parallel import place_batch as jax_place_batch
    from relayrl_tpu.parallel import place_state as jax_place_state

    hp, tree = IMPALA_HP, _tree(KIND)
    update = jax_impala_update(jax_build_policy(_arch(KIND)), hp["lr"], hp["gamma"],
                               hp["vf_coef"], hp["ent_coef"], hp["rho_bar"], hp["c_bar"],
                               hp["max_grad_norm"], (), params_template=tree)
    tx = make_impala_tx(hp["lr"], hp["max_grad_norm"], (), tree)
    state = JaxImpalaState(params=tree, opt_state=tx.init(tree),
                           rng=jax.random.PRNGKey(0), step=jnp.int32(0))
    mesh = jax_make_mesh(FSDP_PP, jax.devices()[:4])
    sharded = jax_make_sharded_update(update, mesh, state, donate_state=False)
    new, metrics = sharded(jax_place_state(state, mesh), jax_place_batch(batch, mesh))
    return jax.tree.map(np.asarray, new.params), {k: float(v) for k, v in metrics.items()}


def _single_impala(batch, max_grad_norm, local):
    """The port's single-process pipelined IMPALA update under
    ``FSDP_PP`` (its 4 entries this process's CPU): flax params, metrics
    and the squared norms its clip read."""
    from relayrl_tpu_torch.algorithms import impala
    from relayrl_tpu_torch.algorithms.impala import (
        ImpalaState,
        make_impala_optimizer,
        make_impala_update,
    )

    hp = IMPALA_HP
    policy = build_policy(_arch(KIND), device="cpu")
    params = policy.load_params(_tree(KIND))
    state = ImpalaState(params, make_impala_optimizer(params, hp["lr"]))
    norms, read = [], impala.grad_sq_norm

    def recorded(grads, ps):
        sq = read(grads, ps)
        norms.append(float(sq))
        return sq

    impala.grad_sq_norm = recorded
    try:
        update = make_impala_update(policy, hp["gamma"], hp["vf_coef"], hp["ent_coef"],
                                    hp["rho_bar"], hp["c_bar"], max_grad_norm)
        mesh = make_mesh(FSDP_PP, [torch.device("cpu")] * local)
        new, metrics = make_sharded_update(update, mesh, state)(place_state(state, mesh),
                                                                batch)
    finally:
        impala.grad_sq_norm = read
    return params_to_jax(new.params), read_metrics(metrics), norms


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
        assert f"TORCH_MULTIHOST_PP_SPLIT_OK rank={rank}" in out, out[-4000:]
    results = []
    for rank in range(len(procs)):
        with open(workdir / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank and 2-rank spawns side by side, the references computed
    while they run."""
    root = tmp_path_factory.mktemp("pp_split")
    batch = _batch()
    rng = np.random.default_rng(25)

    def update(mesh, local, shard_time=False):
        return {"kind": "update", "arch": _arch(KIND), "tree": _tree(KIND), "hp": HP,
                "mesh": mesh, "local_devices": local, "shard_time": shard_time,
                "batch": batch}

    impala_batch = _episode_batch(rng, 8, 8, 6, 3, [8, 6, 8, 3, 5, 8, 2, 7])

    def impala(local):
        return {"kind": "impala", "arch": _arch(KIND), "tree": _tree(KIND),
                "hp": IMPALA_HP, "mesh": FSDP_PP, "local_devices": local,
                "batch": impala_batch}

    ckpt = {"kind": "checkpoint", "kwargs": CKPT_KW, "mesh": FSDP_PP, "local_devices": 1,
            "dir": str(root / "four" / "checkpoints"),
            "batches": [_episode_batch(rng, 8, 8, 6, 3, [8, 5, 8, 2, 7, 8, 1, 4])
                        for _ in range(2)]}
    four = {"fsdp_pp": update(FSDP_PP, 1),
            **{name: update(mesh, local, st) for name, (mesh, local, st, _) in REPLICA.items()},
            "impala": impala(1), "checkpoint": ckpt}
    two = {"fsdp_pp": update(FSDP_PP, 2), "impala": impala(2)}
    procs = {4: _start(root / "four", four, 4), 2: _start(root / "two", two, 2)}
    deadline = time.monotonic() + 300
    try:
        wants = {"fsdp_pp": _jax_update(FSDP_PP, batch), "impala": _jax_impala(impala_batch)}
        for name, (mesh, _, shard_time, alone) in REPLICA.items():
            wants[name] = _jax_update(mesh, batch, shard_time)
            if f"pp{alone['pp']}" not in wants:
                wants[f"pp{alone['pp']}"] = _jax_update(alone, batch)
        singles = {"pp2": _single_process({"dp": 1, "pp": 2}, batch),
                   "pp4": _single_process({"dp": 1, "pp": 4}, batch),
                   "impala": _single_impala(impala_batch, IMPALA_HP["max_grad_norm"], 4),
                   "impala_unclipped": _single_impala(impala_batch, 1e6, 4)}
    except BaseException:
        for ps in procs.values():
            for p in ps:
                p.kill()
        raise
    ranks = {4: _wait(root / "four", procs[4], deadline),
             2: _wait(root / "two", procs[2], deadline)}
    return {"ckpt": ckpt, "ranks": ranks, "wants": wants, "singles": singles,
            "batch": batch}


def _fsdp_pp(runs, world=4):
    return [r["fsdp_pp"] for r in runs["ranks"][world]]


def test_fsdp_pp_update_bit_equal_to_two_processes_of_two(runs):
    """Over 4 ranks (pp and fsdp both cross) each update, its metrics and
    the gathered params are those of the same mesh over 2 ranks of 2
    devices (fsdp alone crosses: the stages hand off inside a rank), bit
    for bit, after each of two updates: the hops copy bytes, and each
    gradient takes the same sums of two ranks."""
    two = _fsdp_pp(runs, 2)
    assert [r["cross"] for r in two] == [("fsdp",)] * 2
    for got in _fsdp_pp(runs):
        assert got["cross"] == ("fsdp", "pp") and got["gathers"]
        for i in range(2):
            _equal_trees(got["params"][i], two[0]["params"][i])
            assert got["metrics"][i] == two[0]["metrics"][i]


def test_fsdp_pp_update_matches_jax(runs):
    """The first update over 4 ranks against the JAX package's sharded
    update on the same mesh (the conftest's virtual CPU devices), at
    ``check_update``'s bars."""
    want_params, want = runs["wants"]["fsdp_pp"]
    for got in _fsdp_pp(runs):
        assert set(got["metrics"][0]) == set(want)
        check_update(got["params"][0], want_params, _tree(KIND), got["metrics"][0], want)


def test_fsdp_pp_ranks_agree_after_each_update(runs):
    """After each of two updates: every rank gathers the same whole params
    and reads the same metrics; the leaves that no rule splits (the heads'
    short biases) are bit-equal on all four; each rank's shards of the
    split ends are bit-equal to those of the other rank at its fsdp
    coordinate (0 with 1, 2 with 3) and differ from the other
    coordinate's; the second update moved them."""
    ranks = _fsdp_pp(runs)
    for i in range(2):
        for other in ranks[1:]:
            _equal_trees(other["params"][i], ranks[0]["params"][i])
            assert other["metrics"][i] == ranks[0]["metrics"][i]
        for name, value in ranks[0]["ends"][i].items():
            split = ".parametrizations." in f".{name}"
            same = [torch.equal(r["ends"][i][name], value) for r in ranks]
            assert same == ([True, True, False, False] if split else [True] * 4), name
            assert torch.equal(ranks[3]["ends"][i][name], ranks[2]["ends"][i][name]), name
    first, second = ranks[0]["ends"]
    assert all(not torch.equal(first[k], second[k]) for k in first)


def test_fsdp_pp_rank_holds_its_stage_and_half_the_ends(runs):
    """Rank r holds stage r % 2's two layers (CPU leaves with Adam moments,
    their squares summed over pp) and none of the other stage's (``meta``,
    no moments); every split end as its half (CPU, moments of the half,
    squares summed over fsdp), the unsplit ones whole; so a rank holds
    its stage's bytes and half of the split ends' of the whole."""
    whole = {name: np.asarray(v).nbytes for name, v in jax.tree_util.tree_flatten_with_path(
        _tree(KIND))[0]}
    total = sum(whole.values())
    ends = sum(n for path, n in whole.items() if "blocks" not in str(path))
    for rank, got in enumerate(_fsdp_pp(runs)):
        assert got["stages"] == [rank % 2]
        held = 0
        for name, h in got["holdings"].items():
            if name.startswith("blocks."):
                mine = int(name.split(".")[1]) // 2 == rank % 2
                assert h["device"] == ("cpu" if mine else "meta"), name
                assert h["moments"] == (h["shape"] if mine else None), name
                assert h["split_comms"] == (["pp"] if mine else []), name
            else:
                split = ".parametrizations." in f".{name}"
                assert h["device"] == "cpu" and h["moments"] == h["shape"], name
                assert h["split_comms"] == (["fsdp"] if split else []), name
            if h["device"] == "cpu":
                held += int(np.prod(h["shape"])) * 4
        splits = [n for n, h in got["holdings"].items() if h["split_comms"] == ["fsdp"]]
        assert len(splits) == 9
        unsplit = ends - sum(int(np.prod(got["holdings"][n]["shape"])) * 4 * 2 for n in splits)
        assert held == (total - ends) // 2 + (ends - unsplit) // 2 + unsplit


def test_fsdp_pp_hops_gathers_and_scatters(runs):
    """Per update (``4 + vf_iters`` forwards, one backward through the
    trunk): the hop across each pp group carries both microbatches of a
    data group's 4 rows down each forward and their gradients back once,
    the output is broadcast each forward and the feed's gradient once;
    each forward gathers the split ends in one all-gather over the fsdp
    group, and the backwards reduce-scatter each split end they train
    once (the policy step its 6, each value step its 3), each after the
    autograd engine is done with its backward."""
    forwards = 4 + HP["vf_iters"]
    act = 2 * 8 * 16 * 4
    for got in _fsdp_pp(runs):
        comm, first = got["comm"], got["stages"] == [0]
        assert comm["sends"] == (2 * forwards if first else 2)
        assert comm["recvs"] == (2 if first else 2 * forwards)
        assert (comm["send_bytes"], comm["recv_bytes"]) == (comm["sends"] * act,
                                                             comm["recvs"] * act)
        assert comm["broadcasts"] == forwards + 1
        splits = [n for n, h in got["holdings"].items() if h["split_comms"] == ["fsdp"]]
        vf = [n for n in splits if n.startswith("vf")]
        assert comm["gathers"] == forwards
        assert comm["scatters"] == len(splits) - len(vf) + HP["vf_iters"] * len(vf) == 9
        # Every one held until the engine was done (dp_gradients).
        assert comm["deferred"] == comm["scatters"]
        assert comm["reduces"] == 0


@pytest.mark.parametrize("name", list(REPLICA))
def test_replica_axis_beside_the_pipeline(runs, name):
    """tp, ep or sp beside a crossing pp splits no leaf of the pipeline
    family: the JAX package's update equals its own pp-only update bit
    for bit (with ``shard_time`` sp moves its last bits, within
    ``check_update``'s bars); the port's, on every one of the 4 ranks,
    equals the port's single-process pp-only update bit for bit, and is
    within ``check_update``'s bars of the JAX package's on the mesh."""
    mesh, _, shard_time, alone = REPLICA[name]
    want_params, want = runs["wants"][name]
    alone_params, alone_metrics = runs["wants"][f"pp{alone['pp']}"]
    if shard_time:
        check_update(want_params, alone_params, _tree(KIND), want, alone_metrics)
        assert max(float(np.abs(a - b).max()) for a, b in zip(
            jax.tree.leaves(want_params), jax.tree.leaves(alone_params))) > 0
    else:
        _equal_trees(want_params, alone_params)
        assert want == alone_metrics
    single_params, single = runs["singles"][f"pp{alone['pp']}"]
    axis = next(ax for ax in ("tp", "ep", "sp") if ax in mesh)
    for got in (r[name] for r in runs["ranks"][4]):
        assert got["cross"] == (axis, "pp") and got["gathers"]
        assert all(h["split_comms"] in ([], ["pp"]) for h in got["holdings"].values())
        for i in range(2):
            _equal_trees(got["params"][i], runs["ranks"][4][0][name]["params"][i])
        _equal_trees(got["params"][0], single_params)
        assert got["metrics"][0] == single
        check_update(got["params"][0], want_params, _tree(KIND), got["metrics"][0], want)


def test_checkpoint_round_trip_restores_each_rank(runs):
    """A collective checkpoint under ``FSDP_PP``, a further update, then a
    restore on every rank: each rank's tensors (its stage's layers and
    its shards of the ends, with their moments) are the saved ones, bit
    for bit; each holds one stage."""
    held = []
    for r in runs["ranks"][4]:
        got = r["checkpoint"]
        assert got["version"] == 1
        saved, moved, restored = got["saved"]["tensors"], got["moved"], got["restored"]
        assert saved.keys() == restored.keys() == moved.keys()
        assert any(not torch.equal(saved[k], moved[k]) for k in saved)
        for key, value in saved.items():
            assert restored[key].dtype == value.dtype and torch.equal(restored[key], value), key
        held.append({k.split(".")[1] for k in saved if k.startswith("blocks.")})
    assert held == [{"0", "1"}, {"2", "3"}] * 2


def _single_algo(runs, tmp_path):
    """A single-process REINFORCE of the same build holding the saved
    state (``apply_state``), and the saved dict."""
    from relayrl_tpu_torch.algorithms import build_algorithm
    from relayrl_tpu_torch.checkpoint.manager import CheckpointManager, apply_state

    saved = CheckpointManager(runs["ckpt"]["dir"]).restore(1)[0]
    algo = build_algorithm("REINFORCE", env_dir=str(tmp_path), device="cpu", **CKPT_KW)
    algo.state = apply_state(algo.state, saved["train"])
    return algo, saved


def test_checkpoint_equals_single_process_save(runs, tmp_path):
    """The saved train state is the unplaced layout: a single-process
    learner that loads it captures it back equal, tensor for tensor
    (keys, dtypes, shapes, values, the optimizers' groups and steps)."""
    from relayrl_tpu_torch.checkpoint.manager import capture_state

    algo, saved = _single_algo(runs, tmp_path)
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


def test_bundle_equals_single_process_bundle(runs, tmp_path):
    """Every rank's bundle of the checkpointed state is byte-equal to the
    single-process bundle of the same state."""
    algo, _ = _single_algo(runs, tmp_path)
    want = algo.bundle().to_bytes()
    for r in runs["ranks"][4]:
        assert r["checkpoint"]["saved"]["bundle"] == want


def test_impala_clip_reads_the_whole_norm(runs):
    """IMPALA under ``FSDP_PP`` with the clip engaged (the clipped step
    differs from the unclipped one): each rank holds one stage's leaves
    and half of the split ends, and every rank's clip reads the whole
    model's squared norm once (each stage leaf once per pp line, each
    split end once per fsdp group): the single-process norm within 1e-5
    (a norm counted twice anywhere is off by far more); the update within
    1e-5 of the single process's and of the same mesh's over 2 ranks of 2
    devices (each sums the norm's parts in its own order, so the clipped
    step moves in its last bits), and within ``check_update``'s bars of
    the JAX package's IMPALA under its ``make_sharded_update`` on the same
    mesh; the four ranks bit-equal after each of two updates."""
    want_params, _, want_norms = runs["singles"]["impala"]
    free_params, _, _ = runs["singles"]["impala_unclipped"]
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(want_params), jax.tree.leaves(free_params)))
    assert moved > 1e-4, moved
    four = [r["impala"] for r in runs["ranks"][4]]
    two = [r["impala"] for r in runs["ranks"][2]]
    assert two[0]["norms"][0] == pytest.approx(want_norms[0], rel=1e-5)
    for got in four:
        assert got["cross"] == ("fsdp", "pp")
        assert len(got["norms"]) == 2
        assert got["norms"][0] == pytest.approx(want_norms[0], rel=1e-5)
        for i in range(2):
            _equal_trees(got["params"][i], four[0]["params"][i])
            assert got["metrics"][i] == four[0]["metrics"][i]
        for ref in (want_params, two[0]["params"][0]):
            for a, b in zip(jax.tree.leaves(got["params"][0]), jax.tree.leaves(ref)):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        jax_params, jax_metrics = runs["wants"]["impala"]
        assert set(got["metrics"][0]) == set(jax_metrics)
        check_update(got["params"][0], jax_params, _tree(KIND), got["metrics"][0], jax_metrics)
