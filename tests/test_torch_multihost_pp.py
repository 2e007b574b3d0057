"""The GPipe pipeline across processes on the CPU: ``gloo`` ranks that each
hold and step only their own pp stages.

OS processes run ``tests/_torch_multihost_pp_worker.py`` against a real
``torch.distributed`` group (the pattern of
``tests/test_torch_multihost_fsdp.py``), and this process holds what they
computed. The model is ``tests/test_torch_sharding.py``'s
``transformer_pp_discrete`` (4 layers, d_model 16, 2 heads, T 8, the
flash kernels' plain versions), one REINFORCE update from its shared
params on its batch, over three meshes:

* ``{"dp": 1, "pp": 2}`` over 2 ranks of 1 CPU device (a stage a rank);
* ``{"dp": 1, "pp": 4}`` over 2 ranks of 2 (two stages a rank: one local
  hand-off and one hop across ranks);
* ``{"dp": 2, "pp": 2}`` over 4 ranks (pp groups (0, 1) and (2, 3), dp
  groups (0, 2) and (1, 3)).

Each case gives: the update against the JAX package's ``make_sharded_update``
on the same pp mesh (the conftest's virtual CPU devices) at
``check_update``'s bars; the update bit-equal to the port's single-process
pipelined update on the same mesh where dp stays in a process, and within
``check_update``'s bars where it crosses (each rank reduces its own rows,
gradients and batch statistics alike, and an all-reduce sums the ranks'
partial sums, where the single process reduces every row at once:
another order of the same f32 sums); every rank's replicated leaves (the parameters outside a
stage) bit-equal after each of two updates; each rank holding only its
stages' layers, with their Adam moments, and the hops' counts and bytes
exactly the schedule's. Then a collective checkpoint under ``{"dp": 1,
"pp": 2}``: each rank's tensors restore bit for bit, the saved train
state equals a single-process save of the same state tensor for tensor,
and the bundle equals the single-process bundle byte for byte. And
IMPALA on the same model under ``{"dp": 1, "pp": 2}`` with a
``max_grad_norm`` whose clip engages: each rank's gradient holds only its
stages' leaves, so the clip must read the whole model's norm (the pp
group's squares summed); the update is bit-equal to the single-process
pipelined one, the ranks bit-equal.
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
from test_torch_multihost import _batch as _episode_batch
from test_torch_multihost import _equal_trees
from test_torch_sharding import _arch, _batch, _tree, check_update
from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
from relayrl_tpu_torch.algorithms.reinforce import (
    ReinforceState,
    make_optimizers,
    make_reinforce_update,
)
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.parallel import make_mesh, make_sharded_update, place_state
from relayrl_tpu_torch.weights import params_to_jax

_WORKER = os.path.join(os.path.dirname(__file__), "_torch_multihost_pp_worker.py")
KIND = "transformer_pp_discrete"
HP = {"pi_lr": 3e-4, "vf_lr": 1e-3, "vf_iters": 1, "gamma": 0.99, "lam": 0.95}
# name: (mesh, devices a rank, processes)
CASES = {
    "pp2": ({"dp": 1, "pp": 2}, 1, 2),
    "pp4": ({"dp": 1, "pp": 4}, 2, 2),
    "dp2_pp2": ({"dp": 2, "pp": 2}, 1, 4),
}
CROSS = {"pp2": ("pp",), "pp4": ("pp",), "dp2_pp2": ("dp", "pp")}
CKPT_KW = {"obs_dim": 6, "act_dim": 3, "model_kind": KIND, "d_model": 16, "n_layers": 4,
           "n_heads": 2, "max_seq_len": 8, "attention": "flash", "traj_per_epoch": 8,
           "train_vf_iters": 2, "with_vf_baseline": True, "seed": 5, "seed_salt": 0}
CKPT_MESH = {"dp": 1, "pp": 2}
# The clip scales the gradients to a norm at which each element is near
# Adam's eps (1e-8), so the step depends on the norm the clip read.
IMPALA_HP = {"lr": 1e-3, "gamma": 0.99, "vf_coef": 0.5, "ent_coef": 0.01,
             "rho_bar": 1.0, "c_bar": 0.9, "max_grad_norm": 1e-7}
IMPALA_MESH = {"dp": 1, "pp": 2}
# The embedding frozen: nothing before stage 0 trains.
FROZEN = {"mesh": {"dp": 1, "pp": 2}, "hp": {**HP, "freeze": ("^params/(obs_embed|pos_embed)",)}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the workers run: a CPU reduction's order
    depends on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _single_process(spec, batch, hp=HP):
    """The port's single-process pipelined update on the same mesh (its
    devices all this process's CPU): flax params and metrics."""
    n = int(np.prod(list(spec.values())))
    policy = build_policy(_arch(KIND), device="cpu")
    params = policy.load_params(_tree(KIND))
    state = ReinforceState(params, *make_optimizers(params, hp["pi_lr"], hp["vf_lr"],
                                                    hp.get("freeze", ())))
    update = make_reinforce_update(policy, HP["vf_iters"], HP["gamma"], HP["lam"], True)
    mesh = make_mesh(spec, [torch.device("cpu")] * n)
    new, metrics = make_sharded_update(update, mesh, state)(place_state(state, mesh), batch)
    return params_to_jax(new.params), read_metrics(metrics)


def _single_impala(batch, max_grad_norm):
    """The port's single-process pipelined IMPALA update under
    ``IMPALA_MESH`` (its entries this process's CPU): flax params and
    metrics."""
    from relayrl_tpu_torch.algorithms.impala import (
        ImpalaState,
        make_impala_optimizer,
        make_impala_update,
    )

    hp = IMPALA_HP
    policy = build_policy(_arch(KIND), device="cpu")
    params = policy.load_params(_tree(KIND))
    state = ImpalaState(params, make_impala_optimizer(params, hp["lr"]))
    update = make_impala_update(policy, hp["gamma"], hp["vf_coef"], hp["ent_coef"],
                                hp["rho_bar"], hp["c_bar"], max_grad_norm)
    mesh = make_mesh(IMPALA_MESH, [torch.device("cpu")] * 2)
    new, metrics = make_sharded_update(update, mesh, state)(place_state(state, mesh), batch)
    return params_to_jax(new.params), read_metrics(metrics)


def _jax_update(spec, batch, hp=HP):
    """The JAX package's sharded update on a pp mesh of the conftest's
    virtual CPU devices (as many as the spec names)."""
    from relayrl_tpu.algorithms.reinforce import ReinforceState as JaxState
    from relayrl_tpu.algorithms.reinforce import make_optimizers as jax_make_optimizers
    from relayrl_tpu.algorithms.reinforce import make_reinforce_update as jax_make_update
    from relayrl_tpu.models import build_policy as jax_build_policy
    from relayrl_tpu.parallel import make_mesh as jax_make_mesh
    from relayrl_tpu.parallel import make_sharded_update as jax_make_sharded_update
    from relayrl_tpu.parallel import place_batch as jax_place_batch
    from relayrl_tpu.parallel import place_state as jax_place_state

    tree = _tree(KIND)
    tx_pi, tx_vf = jax_make_optimizers(tree, hp["pi_lr"], hp["vf_lr"],
                                       freeze=hp.get("freeze", ()))
    state = JaxState(params=tree, pi_opt_state=tx_pi.init(tree), vf_opt_state=tx_vf.init(tree),
                     rng=jax.random.PRNGKey(1), step=jnp.int32(0))
    update = jax_make_update(jax_build_policy(_arch(KIND)), hp["pi_lr"], hp["vf_lr"],
                             hp["vf_iters"], hp["gamma"], hp["lam"], with_baseline=True,
                             freeze=hp.get("freeze", ()))
    n = int(np.prod(list(spec.values())))
    mesh = jax_make_mesh(spec, jax.devices()[:n])
    sharded = jax_make_sharded_update(update, mesh, state, donate_state=False)
    new, metrics = sharded(jax_place_state(state, mesh), jax_place_batch(batch, mesh))
    return jax.tree.map(np.asarray, new.params), {k: float(v) for k, v in metrics.items()}


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
        assert f"TORCH_MULTIHOST_PP_OK rank={rank}" in out, out[-4000:]
    results = []
    for rank in range(len(procs)):
        with open(workdir / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's ranks (the 2-process and 4-process runs side by side),
    the references computed while they run."""
    root = tmp_path_factory.mktemp("pp")
    batch = _batch()
    cases = {name: {"kind": "update", "arch": _arch(KIND), "tree": _tree(KIND), "hp": HP,
                    "mesh": mesh, "local_devices": local, "world": world, "batch": batch}
             for name, (mesh, local, world) in CASES.items()}
    rng = np.random.default_rng(12)
    ckpt = {"kind": "checkpoint", "kwargs": CKPT_KW, "mesh": CKPT_MESH, "local_devices": 1,
            "dir": str(root / "two" / "checkpoints"),
            "batches": [_episode_batch(rng, 8, 8, 6, 3, [8, 5, 8, 2, 7, 8, 1, 4])
                        for _ in range(2)]}
    two = {n: c for n, c in cases.items() if c["world"] == 2}
    two["checkpoint"] = ckpt
    two["frozen"] = {**cases["pp2"], "hp": FROZEN["hp"]}
    two["impala"] = {"kind": "impala", "arch": _arch(KIND), "tree": _tree(KIND),
                     "hp": IMPALA_HP, "mesh": IMPALA_MESH, "local_devices": 1,
                     "batch": _episode_batch(rng, 8, 8, 6, 3, [8, 6, 8, 3, 5, 8, 2, 7])}
    four = {n: c for n, c in cases.items() if c["world"] == 4}
    procs = {2: _start(root / "two", two, 2), 4: _start(root / "four", four, 4)}
    deadline = time.monotonic() + 300
    try:
        wants = {n: _jax_update(CASES[n][0], batch) for n in cases}
        singles = {n: _single_process(CASES[n][0], batch) for n in cases}
        wants["frozen"] = _jax_update(FROZEN["mesh"], batch, FROZEN["hp"])
        singles["frozen"] = _single_process(FROZEN["mesh"], batch, FROZEN["hp"])
        singles["impala"] = _single_impala(two["impala"]["batch"],
                                           IMPALA_HP["max_grad_norm"])
        singles["impala_unclipped"] = _single_impala(two["impala"]["batch"], 1e6)
    except BaseException:
        for ps in procs.values():
            for p in ps:
                p.kill()
        raise
    ranks = {2: _wait(root / "two", procs[2], deadline),
             4: _wait(root / "four", procs[4], deadline)}
    return {"cases": cases, "ckpt": ckpt, "ranks": ranks, "wants": wants,
            "singles": singles, "batch": batch}


def _ranks_of(runs, name):
    return [r[name] for r in runs["ranks"][CASES[name][2]]]


@pytest.mark.parametrize("name", list(CASES))
def test_update_matches_jax(runs, name):
    """The first update across ranks against the JAX package's sharded
    update on the same pp mesh, at ``check_update``'s bars."""
    want_params, want = runs["wants"][name]
    for got in _ranks_of(runs, name):
        assert got["cross"] == CROSS[name] and got["gathers"]
        assert set(got["metrics"][0]) == set(want)
        check_update(got["params"][0], want_params, _tree(KIND), got["metrics"][0], want)


@pytest.mark.parametrize("name", list(CASES))
def test_update_equals_single_process_pipeline(runs, name):
    """Where dp stays in a process the hops copy bytes and nothing is
    summed in another order: the update is the single-process pipelined
    update's bit for bit (one intra-op thread on both sides). Where dp
    crosses, the gradients and batch statistics are summed in another
    order (the module docstring): within ``check_update``'s bars."""
    want_params, want = runs["singles"][name]
    for got in _ranks_of(runs, name):
        if "dp" in CROSS[name]:
            check_update(got["params"][0], want_params, _tree(KIND), got["metrics"][0], want)
        else:
            _equal_trees(got["params"][0], want_params)
            assert got["metrics"][0] == want


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_bit_equal_across_ranks(runs, name):
    """After each of two updates every rank holds the same replicated
    leaves (the embedding, the final norm, the heads), bit for bit, and
    gathers the same whole params; the second update moved them."""
    ranks = _ranks_of(runs, name)
    for i in range(2):
        for other in ranks[1:]:
            for key, value in ranks[0]["replicated"][i].items():
                assert torch.equal(other["replicated"][i][key], value), key
            _equal_trees(other["params"][i], ranks[0]["params"][i])
            assert other["metrics"][i] == ranks[0]["metrics"][i]
    first, second = ranks[0]["replicated"]
    assert any(not torch.equal(first[k], second[k]) for k in first)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_only_its_stages(runs, name):
    """A rank holds its stages' layers (CPU tensors with Adam moments of
    their shape, marked as a part of the model split over pp) and none of
    the others' (a ``meta`` tensor of the layer's shape, no moments); the
    ranks of a pp group cover the stages once; every replicated leaf sits
    on every rank with its moments."""
    mesh, _, world = CASES[name]
    per = 4 // mesh["pp"]
    held = {}
    for rank, got in enumerate(_ranks_of(runs, name)):
        stages = got["stages"]
        held.setdefault(rank // (world // mesh["dp"]), []).extend(stages)
        for pname, h in got["holdings"].items():
            if pname.startswith("blocks."):
                mine = int(pname.split(".")[1]) // per in stages
                assert h["device"] == ("cpu" if mine else "meta"), pname
                assert h["moments"] == (h["shape"] if mine else None), pname
                assert h["split_comms"] == (["pp"] if mine else []), pname
            else:
                assert h["device"] == "cpu" and h["moments"] == h["shape"], pname
                assert h["split_comms"] == [], pname
    for stages in held.values():
        assert sorted(stages) == list(range(mesh["pp"]))


@pytest.mark.parametrize("name", list(CASES))
def test_hops_move_the_schedule_s_activations(runs, name):
    """Per update (``4 + vf_iters`` forwards through the trunk and one
    backward, ``tests/test_torch_reinforce.py``'s count), the hop across
    ranks carries each microbatch's activation down once a forward and
    its gradient back once in the backward; the output is broadcast once
    a forward and the feed's gradient once in the backward. Counts and
    bytes from the activation's shape: a microbatch of a rank's rows / M
    x T 8 x d_model 16 in f32."""
    mesh, _, _ = CASES[name]
    rows = 8 // mesh["dp"]
    n_micro = {2: 2, 4: 4}[mesh["pp"]]
    act = rows // n_micro * 8 * 16 * 4
    forwards = 4 + HP["vf_iters"]
    for got in _ranks_of(runs, name):
        comm, stages = got["comm"], got["stages"]
        sends_down = forwards * n_micro if stages[-1] < mesh["pp"] - 1 else 0
        sends_up = n_micro if stages[0] > 0 else 0
        recvs_down = forwards * n_micro if stages[0] > 0 else 0
        recvs_up = n_micro if stages[-1] < mesh["pp"] - 1 else 0
        assert comm["sends"] == sends_down + sends_up, comm
        assert comm["recvs"] == recvs_down + recvs_up, comm
        assert comm["send_bytes"] == comm["sends"] * act
        assert comm["recv_bytes"] == comm["recvs"] * act
        assert comm["broadcasts"] == forwards + 1
        assert comm["broadcast_bytes"] == (forwards + 1) * rows * 8 * 16 * 4


def test_checkpoint_round_trip_restores_each_rank_s_stages(runs):
    """A collective checkpoint, a further update, then a restore on every
    rank: each rank's tensors (its stages and the replicated ends, with
    their moments) are the saved ones, bit for bit."""
    for r in runs["ranks"][2]:
        got = r["checkpoint"]
        assert got["version"] == 1
        saved, moved, restored = got["saved"]["tensors"], got["moved"], got["restored"]
        assert saved.keys() == restored.keys() == moved.keys()
        assert any(not torch.equal(saved[k], moved[k]) for k in saved)
        for key, value in saved.items():
            assert restored[key].dtype == value.dtype and torch.equal(restored[key], value), key
    held = [{k.split(".")[1] for k in r["checkpoint"]["saved"]["tensors"]
             if k.startswith("blocks.")} for r in runs["ranks"][2]]
    assert held == [{"0", "1"}, {"2", "3"}]


def _single_algo(runs, tmp_path):
    """A single-process REINFORCE of the same build holding the saved
    state (``apply_state``), the saved dict and the single-process
    update's params."""
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
    params are the single-process (unpipelined) update's within 1e-5."""
    from relayrl_tpu_torch.checkpoint.manager import capture_state

    algo, saved, trained = _single_algo(runs, tmp_path)
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
        torch.testing.assert_close(saved["train"]["params"][key], value, rtol=0, atol=1e-5)


def test_bundle_equals_single_process_bundle(runs, tmp_path):
    """Both ranks' bundles of the checkpointed state are byte-equal to the
    single-process bundle of the same state."""
    algo, _, _ = _single_algo(runs, tmp_path)
    want = algo.bundle().to_bytes()
    for r in runs["ranks"][2]:
        assert r["checkpoint"]["saved"]["bundle"] == want


def test_impala_clip_reads_the_whole_norm(runs):
    """IMPALA under ``{"dp": 1, "pp": 2}`` with the clip engaged (the
    clipped step differs from the unclipped one): the update is the
    single-process pipelined update's bit for bit, and both ranks'
    gathered params and metrics are bit-equal after each of two
    updates."""
    want_params, want = runs["singles"]["impala"]
    free_params, _ = runs["singles"]["impala_unclipped"]
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(want_params), jax.tree.leaves(free_params)))
    assert moved > 1e-4, moved
    ranks = [r["impala"] for r in runs["ranks"][2]]
    _equal_trees(ranks[0]["params"][0], want_params)
    assert ranks[0]["metrics"][0] == want
    for i in range(2):
        _equal_trees(ranks[1]["params"][i], ranks[0]["params"][i])
        assert ranks[1]["metrics"][i] == ranks[0]["metrics"][i]


def test_frozen_embedding_trains_across_ranks(runs):
    """With the embedding frozen (``learner.freeze``), the last stage's
    rank trains no parameter before the pipeline, yet it runs its hops'
    backwards, so stage 0's rank gets its gradients and no rank waits:
    the update is within ``check_update``'s bars of the JAX package's
    frozen update and the single-process pipelined update's bit for bit,
    the embedding is as it was, and the ranks are bit-equal after each
    of two updates."""
    want_params, want = runs["wants"]["frozen"]
    single_params, single = runs["singles"]["frozen"]
    ranks = [r["frozen"] for r in runs["ranks"][2]]
    for got in ranks:
        check_update(got["params"][0], want_params, _tree(KIND), got["metrics"][0], want)
        _equal_trees(got["params"][0], single_params)
        assert got["metrics"][0] == single
        for i in range(2):
            for key in ("obs_embed", "pos_embed"):
                for a, b in zip(jax.tree.leaves(got["params"][i]["params"][key]),
                                jax.tree.leaves(_tree(KIND)["params"][key])):
                    assert np.array_equal(a, b), key
            _equal_trees(got["params"][i], ranks[0]["params"][i])
    # Every layer trained, stage 0's from the gradients that hopped back.
    blocks = ranks[0]["params"][0]["params"]["blocks"]["qkv"]["kernel"]
    init = _tree(KIND)["params"]["blocks"]["qkv"]["kernel"]
    assert all(not np.array_equal(blocks[i], init[i]) for i in range(len(init)))
