"""The port's multi-process bring-up in one process: the counterparts of
``tests/test_distributed_init.py``'s ``initialize_distributed`` cases, the
backend rule, meshes that span processes and the data-parallel helpers.

Every case runs with the topology cache reset and starts no process group
(each multi-process resolution here raises before the rendezvous); the
two-process runs are ``tests/test_torch_multihost.py`` and
``tests/test_torch_multihost_server.py``.
"""

import numpy as np
import pytest
import torch

from relayrl_tpu_torch.parallel import (
    CrossProcessAxisError,
    broadcast_from_coordinator,
    initialize_distributed,
    is_coordinator,
    make_mesh,
    process_index,
)
from relayrl_tpu_torch.parallel import context, distributed


@pytest.fixture(autouse=True)
def _reset_topology_cache():
    """initialize_distributed caches its first resolution per process;
    tests need a fresh slate, and none may leave a group behind."""
    distributed.shutdown_distributed()
    yield
    distributed.shutdown_distributed()
    assert not torch.distributed.is_initialized()


class TestInitializeDistributed:
    def test_single_process_noop(self):
        info = initialize_distributed()
        assert info == {"multi_host": False, "process_id": 0,
                        "num_processes": 1}

    def test_config_without_coordinator_noop(self):
        info = initialize_distributed(
            config={"distributed": {"num_processes": 4}})
        assert info["multi_host"] is False

    def test_env_resolution_requires_both(self, monkeypatch):
        monkeypatch.setenv("RELAYRL_NUM_PROCESSES", "4")
        # No coordinator anywhere: still a no-op, no rendezvous to hang on.
        info = initialize_distributed()
        assert info["multi_host"] is False

    def test_repeat_call_returns_cached_topology(self):
        first = initialize_distributed()
        assert initialize_distributed(coordinator_address="127.0.0.1:1",
                                      num_processes=2, process_id=0) == first

    def test_multi_host_without_process_id_raises(self):
        with pytest.raises(ValueError, match="per-host process id"):
            initialize_distributed(
                coordinator_address="127.0.0.1:1", num_processes=2)

    def test_config_process_id_rejected(self):
        with pytest.raises(ValueError, match="same rank"):
            initialize_distributed(
                coordinator_address="127.0.0.1:1",
                config={"distributed": {"num_processes": 2,
                                        "process_id": 0}})

    def test_is_coordinator_single_process(self):
        assert is_coordinator() is True
        assert process_index() == 0


@pytest.mark.parametrize("names", [
    ("RELAYRL_COORDINATOR", "RELAYRL_NUM_PROCESSES"),
    ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES"),
])
def test_env_names_resolve_a_multi_process_topology(monkeypatch, names):
    """Both families of env names (the port's and the JAX package's
    fallbacks) reach the per-host process id check."""
    monkeypatch.setenv(names[0], "127.0.0.1:1")
    monkeypatch.setenv(names[1], "2")
    with pytest.raises(ValueError, match="per-host process id"):
        initialize_distributed()
    assert distributed._info is None


def test_single_process_broadcast_is_the_identity():
    tree = {"a": np.arange(3), "b": [torch.ones(2)]}
    assert broadcast_from_coordinator(tree) is tree


@pytest.mark.parametrize("identities,backend", [
    (["cpu", "cpu"], "gloo"),
    (["cuda:h:GPU-a", "cuda:h:GPU-a"], "gloo"),   # two ranks share one card
    (["cuda:h:GPU-a", "cuda:h:GPU-b"], "nccl"),   # a card each
    (["cuda:h:GPU-a", "cpu"], "gloo"),
    (["cuda:h1:GPU-a", "cuda:h2:GPU-b", "cuda:h2:GPU-c", "cuda:h1:GPU-d"], "nccl"),
])
def test_backend_rule(identities, backend):
    assert distributed.choose_backend(identities) == backend


def _two_process_topology(monkeypatch, rank):
    monkeypatch.setattr(distributed, "_info", {
        "multi_host": True, "process_id": rank, "num_processes": 2})


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_spans_processes_along_dp(monkeypatch, rank):
    """``{"dp": -1, "fsdp": 2}`` over 2 processes of 4 devices (the JAX
    package's test layout): dp 4, each process 2 dp coordinates x fsdp 2,
    in contiguous blocks."""
    _two_process_topology(monkeypatch, rank)
    local = [torch.device("cpu")] * 4
    mesh = make_mesh({"dp": -1, "fsdp": 2}, local)
    assert mesh.shape["dp"] == 4 and mesh.shape["fsdp"] == 2
    assert (mesh.process_count, mesh.process_index) == (2, rank)
    assert mesh.local.shape["dp"] == 2 and mesh.local.shape["fsdp"] == 2
    assert mesh.local.process_count == 1
    assert all(d == torch.device("cpu") for d in mesh.local.devices.flat)
    mine = slice(2 * rank, 2 * rank + 2)
    theirs = slice(2 - 2 * rank, 4 - 2 * rank)
    assert all(d is not None for d in mesh.devices[mine].flat)
    assert all(d is None for d in mesh.devices[theirs].flat)
    assert mesh.first_device == torch.device("cpu")


# (spec, devices a process, processes, crossing axes, the owners along pp
# through the first rank and through the last, the pp groups).
_PP_CROSSING = [
    ({"dp": 1, "pp": 2}, 1, 2, ("pp",), [0, 1], [0, 1], [(0, 1)]),
    ({"dp": 1, "pp": 4}, 2, 2, ("pp",), [0, 0, 1, 1], [0, 0, 1, 1], [(0, 1)]),
    ({"dp": 1, "pp": 8}, 4, 2, ("pp",), [0] * 4 + [1] * 4, [0] * 4 + [1] * 4, [(0, 1)]),
    ({"dp": 2, "pp": 2}, 1, 4, ("dp", "pp"), [0, 1], [2, 3], [(0, 1), (2, 3)]),
    ({"dp": 1, "pp": 4}, 1, 4, ("pp",), [0, 1, 2, 3], [0, 1, 2, 3], [(0, 1, 2, 3)]),
    ({"dp": 2, "pp": 4}, 2, 4, ("dp", "pp"), [0, 0, 1, 1], [2, 2, 3, 3], [(0, 1), (2, 3)]),
    ({"dp": -1, "pp": 2}, 1, 8, ("dp", "pp"), [0, 1], [6, 7],
     [(0, 1), (2, 3), (4, 5), (6, 7)]),
]


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("spec,n,world,cross,first_owners,last_owners,groups", _PP_CROSSING)
def test_pp_across_processes_builds(monkeypatch, spec, n, world, cross, first_owners,
                                    last_owners, groups, last):
    """pp may cross processes: the mesh builds with each stage's owner,
    the crossing axes and the pp groups every rank forms (its own among
    them); a rank's stages are its contiguous block of the line; the
    local sub-mesh keeps the whole pp axis, the other ranks' stages None
    with their owners; the ranks of a pp group share their dp coordinate,
    so they keep the same batch rows."""
    rank = world - 1 if last else 0
    _topology(monkeypatch, rank, world)
    mesh = make_mesh(spec, [torch.device("cpu")] * n)
    assert mesh.cross_axes == cross
    owners = last_owners if last else first_owners
    assert list(mesh.axis_owners("pp")) == owners
    assert mesh.shard_indices("pp") == [i for i, r in enumerate(owners) if r == rank]
    assert mesh.axis_groups("pp") == groups
    assert mesh.axis_ranks("pp") in groups and rank in mesh.axis_ranks("pp")
    local = mesh.local
    assert local.shape["pp"] == mesh.shape["pp"] and local.process_count == world
    assert [d is not None for d in local.axis_devices("pp")] == [r == rank for r in owners]
    assert list(local.axis_owners("pp")) == owners
    assert mesh.first_device == torch.device("cpu")
    rows = mesh.owners.reshape(mesh.shape["dp"], -1)
    start, stop = mesh.dp_block
    assert stop - start == 1
    for r in mesh.axis_ranks("pp"):
        assert np.flatnonzero((rows == r).any(axis=1)).tolist() == [start]


@pytest.mark.parametrize("spec,n,world,beside", [({"dp": 1, "sp": 2, "pp": 4}, 2, 4, "sp"),
                                                 ({"dp": 1, "fsdp": 2, "pp": 2}, 1, 4, "fsdp"),
                                                 ({"dp": 1, "ep": 2, "pp": 4}, 2, 4, "ep"),
                                                 ({"dp": 1, "tp": 2, "pp": 2}, 1, 4, "tp")])
def test_pp_beside_a_crossing_split_builds(monkeypatch, spec, n, world, beside):
    """A crossing pp axis beside a crossing fsdp, ep, tp or sp axis: 4
    ranks, the split axis's coordinate the rank's half (ranks 0-1 at 0,
    2-3 at 1), its pp coordinates the rank's block of the line. On every
    rank: the crossing axes; each axis's owners through the rank; a pp
    group per split coordinate, (0, 1) and (2, 3), and a split group per
    pp coordinate, (0, 2) and (1, 3); the rank's stages and their devices
    (its own line's, the other rank's None); the data group (the fsdp
    group where fsdp crosses, with no dp group under it; none where the
    split axis is a replica axis, its ranks holding the same rows); and
    the groups every rank forms, in one order: the split axis's, then
    pp's (the data plane's are the fsdp groups already formed)."""
    import torch.distributed as dist

    per = spec["pp"] // 2  # stages a rank
    for rank in range(world):
        _topology(monkeypatch, rank, world)
        monkeypatch.setattr(distributed, "_runtime",
                            distributed._Runtime(rank, world, [], "gloo", None))
        formed = []
        monkeypatch.setattr(dist, "new_group",
                            lambda ranks, timeout=None: formed.append(tuple(ranks)) or object())
        mesh = make_mesh(spec, [torch.device("cpu")] * n)
        assert mesh.cross_axes == (beside, "pp")
        split, line = rank // 2, 2 * (rank // 2)
        assert list(mesh.axis_owners(beside)) == [rank % 2, rank % 2 + 2]
        assert list(mesh.axis_owners("pp")) == [line + s // per for s in range(spec["pp"])]
        assert mesh.axis_ranks(beside) == (rank % 2, rank % 2 + 2)
        assert mesh.axis_ranks("pp") == (line, line + 1)
        assert mesh.axis_groups(beside) == [(0, 2), (1, 3)]
        assert mesh.axis_groups("pp") == [(0, 1), (2, 3)]
        stages = list(range((rank % 2) * per, (rank % 2 + 1) * per))
        assert mesh.shard_indices("pp") == stages
        assert mesh.shard_indices(beside) == [split]
        assert [d is not None for d in mesh.axis_devices("pp")] == [
            s in stages for s in range(spec["pp"])]
        assert formed == [(0, 2), (1, 3), (0, 1), (2, 3)]
        assert set(distributed._runtime.groups) == set(formed)
        group = distributed.data_parallel_group(mesh)
        if beside == "fsdp":
            assert (group.rank, group.size, group.ranks) == (split, 2, (rank % 2, rank % 2 + 2))
            assert group.dp is None and mesh.data_block == (split, split + 1)
        else:
            assert group is None and mesh.data_block == (0, 1)
        distributed.shutdown_distributed()


# (spec, devices a process, processes, crossing axes, each crossing
# axis's owners along it, and its groups; the data plane's groups).
_CROSSING = [
    ({"dp": 1, "fsdp": -1}, 4, 2, ("fsdp",), {"fsdp": [0] * 4 + [1] * 4},
     {"fsdp": [(0, 1)]}, [(0, 1)]),
    ({"dp": 1, "sp": 4, "tp": 2}, 4, 2, ("tp",), {"tp": [0, 1]}, {"tp": [(0, 1)]},
     [(0,), (1,)]),
    ({"dp": 1, "ep": 8}, 4, 2, ("ep",), {"ep": [0] * 4 + [1] * 4}, {"ep": [(0, 1)]},
     [(0,), (1,)]),
    ({"dp": 1, "sp": 2, "fsdp": 4}, 4, 2, ("fsdp",), {"fsdp": [0, 0, 1, 1]},
     {"fsdp": [(0, 1)]}, [(0, 1)]),
    ({"dp": 1, "ep": 2, "sp": 4}, 4, 2, ("ep",), {"ep": [0, 1]}, {"ep": [(0, 1)]},
     [(0,), (1,)]),
    ({"dp": 1, "ep": 2}, 1, 2, ("ep",), {"ep": [0, 1]}, {"ep": [(0, 1)]}, [(0,), (1,)]),
    ({"dp": 1, "tp": 2}, 1, 2, ("tp",), {"tp": [0, 1]}, {"tp": [(0, 1)]}, [(0,), (1,)]),
    ({"dp": 2, "fsdp": 2}, 1, 4, ("dp", "fsdp"), {"dp": None, "fsdp": None},
     {"dp": [(0, 2), (1, 3)], "fsdp": [(0, 1), (2, 3)]}, [(0, 1, 2, 3)]),
]


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("spec,n,world,cross,owners,groups,data", _CROSSING)
def test_split_axis_across_processes_builds(monkeypatch, spec, n, world, cross, owners,
                                            groups, data, last):
    """fsdp, ep and tp may cross processes: the mesh builds with each
    coordinate's owner, the crossing axes, the groups every rank forms and
    the data plane's (dp x fsdp) groups; the local sub-mesh keeps a
    crossing axis other than dp whole, the other ranks' entries None; a
    rank keeps the batch rows of its dp x fsdp cells."""
    from relayrl_tpu_torch.parallel import place_batch

    rank = world - 1 if last else 0
    _topology(monkeypatch, rank, world)
    mesh = make_mesh(spec, [torch.device("cpu")] * n)
    assert mesh.cross_axes == cross
    for axis, want in owners.items():
        if want is not None:
            assert list(mesh.axis_owners(axis)) == want
    for axis, want in groups.items():
        assert mesh.axis_groups(axis) == want
        assert mesh.axis_ranks(axis) in want and rank in mesh.axis_ranks(axis)
    assert mesh.axis_groups(("dp", "fsdp")) == data
    local = mesh.local
    for axis in set(cross) - {"dp"}:
        assert local.shape[axis] == mesh.shape[axis]
        mine = [d is not None for d in local.axis_devices(axis)]
        assert mine == [r == rank for r in local.axis_owners(axis)] and not all(mine)
    assert mesh.first_device == torch.device("cpu")
    blocks = mesh.shape["dp"] * mesh.shape["fsdp"]
    rows = np.arange(2 * blocks, dtype=np.float32)
    start, stop = mesh.data_block
    assert np.array_equal(place_batch({"x": rows}, mesh)["x"].numpy(),
                          rows[2 * start:2 * stop])
    assert (stop - start) * len(mesh.axis_ranks(("dp", "fsdp"))) == blocks


class _SumGroup:
    """A stand-in data-parallel group: this process is ``rank`` of
    ``size``, and every other process holds the same values."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def all_reduce(self, flat):
        flat.mul_(self.size)
        return flat


def test_dp_helpers_are_the_identity_without_a_group():
    x = torch.arange(8.0)
    assert context.dp_sum(x)[0] is x
    assert context.dp_mean(x) == x.mean()
    assert context.dp_rows(x) is not None and torch.equal(context.dp_rows(x), x)
    assert context.dp_global_rows(8) == 8 and context.dp_size() == 1
    loss = (x.requires_grad_() * 2).sum()
    grads = context.dp_gradients(loss, [x, torch.zeros(2, requires_grad=True)])
    assert torch.equal(grads[0], torch.full((8,), 2.0))
    assert torch.equal(grads[1], torch.zeros(2))


@pytest.mark.parametrize("rank", [0, 1])
def test_dp_helpers_under_a_group(rank):
    x = torch.arange(8.0)
    with context.use_dp_group(_SumGroup(rank, 2)):
        assert context.dp_size() == 2 and context.dp_global_rows(4) == 8
        assert context.dp_row_range(8) == (4 * rank, 4 * rank + 4)
        assert torch.equal(context.dp_rows(x), x[4 * rank:4 * rank + 4])
        total, count = context.dp_sum(x.sum(), torch.tensor(3))
        assert total == 56.0 and count == 6 and count.dtype == torch.int64
        assert context.dp_mean(x) == x.mean() / 2
        w = torch.ones(3, requires_grad=True)
        unused = torch.ones(2, requires_grad=True)
        grads = context.dp_gradients((w * 3).sum(), [w, unused])
        assert torch.equal(grads[0], torch.full((3,), 6.0))
        assert torch.equal(grads[1], torch.zeros(2))
        # A process with no row of a minibatch still joins the sum.
        assert torch.equal(context.dp_gradients(None, [w])[0], torch.zeros(3))
    assert context.current_dp_group() is None


def _topology(monkeypatch, rank, world):
    monkeypatch.setattr(distributed, "_info", {
        "multi_host": True, "process_id": rank, "num_processes": world})


@pytest.mark.parametrize("rank", [0, 1])
def test_sp_across_two_processes_builds(monkeypatch, rank):
    """``{"dp": 1, "sp": 8}`` over 2 processes of 4 devices (the reference
    worker's ring): one ring, shards 0-3 on rank 0 and 4-7 on rank 1. The
    local sub-mesh keeps the whole sp axis, the other rank's entries None;
    dp does not cross, so there is no data-parallel group and a rank keeps
    every row of the batch."""
    from relayrl_tpu_torch.parallel import place_batch

    _topology(monkeypatch, rank, 2)
    mesh = make_mesh({"dp": 1, "sp": 8}, [torch.device("cpu")] * 4)
    assert mesh.cross_axes == ("sp",)
    assert [mesh.owner(sp=i) for i in range(8)] == [0] * 4 + [1] * 4
    assert mesh.shard_indices("sp") == list(range(4 * rank, 4 * rank + 4))
    assert mesh.axis_ranks("sp") == (0, 1) and mesh.axis_ranks("dp") == (rank,)
    assert mesh.dp_block == (0, 1)
    local = mesh.local
    assert local.shape == mesh.shape and local.process_count == 2
    mine = [d is not None for d in local.axis_devices("sp")]
    assert mine == [i // 4 == rank for i in range(8)]
    assert mesh.first_device == torch.device("cpu")
    monkeypatch.setattr(distributed, "_runtime",
                        distributed._Runtime(rank, 2, [], "gloo", None))
    assert distributed.data_parallel_group(mesh) is None
    rng = np.random.default_rng(0)
    batch = {"obs": rng.standard_normal((2, 64, 3)).astype(np.float32),
             "last_val": np.arange(2, dtype=np.float32)}
    placed = place_batch(batch, mesh, shard_time=True)
    for key, value in batch.items():
        assert np.array_equal(placed[key].numpy(), value), key


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_dp_and_sp_across_four_processes(monkeypatch, rank):
    """``{"dp": 2, "sp": 4}`` over 4 processes of 2 devices: rank r holds
    dp coordinate r // 2 and sp shards 2 (r % 2) and 2 (r % 2) + 1; its dp
    group is the ranks of its sp half in both dp rows, its sp group the
    two ranks of its dp row, and every rank forms every group."""
    from relayrl_tpu_torch.parallel import place_batch

    _topology(monkeypatch, rank, 4)
    mesh = make_mesh({"dp": 2, "sp": 4}, [torch.device("cpu")] * 2)
    assert set(mesh.cross_axes) == {"dp", "sp"}
    assert mesh.dp_block == (rank // 2, rank // 2 + 1)
    assert mesh.shard_indices("sp") == [2 * (rank % 2), 2 * (rank % 2) + 1]
    assert mesh.axis_ranks("dp") == (rank % 2, rank % 2 + 2)
    assert mesh.axis_ranks("sp") == (2 * (rank // 2), 2 * (rank // 2) + 1)
    assert mesh.axis_groups("dp") == [(0, 2), (1, 3)]
    assert mesh.axis_groups("sp") == [(0, 1), (2, 3)]
    assert mesh.local.shape["dp"] == 1 and mesh.local.shape["sp"] == 4
    rows = np.arange(8, dtype=np.float32)[:, None].repeat(4, axis=1)
    placed = place_batch({"valid": rows}, mesh, shard_time=True)["valid"]
    assert np.array_equal(placed.numpy(), rows[4 * (rank // 2):4 * (rank // 2) + 4])


def test_blocks_that_split_a_line_unevenly_refused(monkeypatch):
    """Blocks of 2 devices over ``{"fsdp": 2, "tp": 3}`` are no sub-grid
    (rank 1 holds the end of fsdp 0's tp line and the start of fsdp 1's):
    the mesh builds, rank 1 holding tp 2 on its first line and tp 0 on
    its second, in the tp groups (0, 1) and (1, 2) and the fsdp groups
    (1, 2) and (0, 1). Only such blocks across a pipeline axis stay
    refused."""
    _topology(monkeypatch, 1, 3)
    mesh = make_mesh({"dp": 1, "fsdp": 2, "tp": 3}, [torch.device("cpu")] * 2)
    assert mesh.straddles and mesh.cross_axes == ("fsdp", "tp")
    lines = mesh.lines("tp")
    assert [mesh.shard_indices("tp", line) for line in lines] == [[2], [0]]
    assert [mesh.axis_ranks("tp", line) for line in lines] == [(0, 1), (1, 2)]
    assert [mesh.axis_ranks("fsdp", line) for line in mesh.lines("fsdp")] == [(0, 1), (1, 2)]
    assert mesh.cells == [0, 1] and mesh.accountable_cells == [1]
    with pytest.raises(CrossProcessAxisError, match="pipeline.*queue 1"):
        make_mesh({"dp": 1, "fsdp": 2, "pp": 3}, [torch.device("cpu")] * 2)


@pytest.mark.parametrize("spec,n,world,size,dp", [({"dp": 1, "fsdp": 2}, 1, 2, 2, False),
                                                   ({"dp": 2, "fsdp": 2}, 1, 4, 4, True),
                                                   ({"dp": 1, "ep": 2}, 1, 2, 0, False)])
def test_data_group_spans_dp_and_fsdp(monkeypatch, spec, n, world, size, dp):
    """The data-parallel group holds the processes that differ in their
    dp or fsdp coordinate (none where neither crosses: ep ranks hold the
    same rows); where both cross, its ``dp`` group sums the gradients
    that the fsdp gather summed already."""
    rank = world - 1
    _topology(monkeypatch, rank, world)
    mesh = make_mesh(spec, [torch.device("cpu")] * n)
    monkeypatch.setattr(distributed, "_runtime",
                        distributed._Runtime(rank, world, [], "gloo", None))
    mesh_groups = {ranks: object() for ranks in mesh.axis_groups("dp")}
    distributed._runtime.groups.update(mesh_groups)
    group = distributed.data_parallel_group(mesh)
    if not size:
        assert group is None
        return
    assert (group.rank, group.size) == (world - 1, size)
    assert (group.dp is not None) == dp
    if dp:
        assert (group.dp.rank, group.dp.size) == (1, 2)
        assert group.dp.group is mesh_groups[mesh.axis_ranks("dp")]


def test_local_device_ids_name_a_rank_s_mesh_entries():
    """A card named twice gives a rank two mesh entries on it; a device
    name (``"cpu"``) names that device."""
    assert distributed._local_devices([0, 0]) == [torch.device("cuda", 0)] * 2
    assert distributed._local_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2


def test_uneven_process_blocks_refused(monkeypatch):
    """Blocks of 3 devices over a ``{"dp": 3, "sp": 2}`` mesh split dp 1's
    ring between processes: the mesh builds, rank 0 holding dp 0's ring
    whole and shard 0 of dp 1's, keeping both cells' rows and accounting
    for both; its local mesh keeps rank 1's entry of dp 1 as None. The
    same blocks across a pipeline axis (``{"dp": 3, "pp": 2}``) stay
    refused."""
    _two_process_topology(monkeypatch, 0)
    mesh = make_mesh({"dp": 3, "sp": 2}, [torch.device("cpu")] * 3)
    assert mesh.straddles and mesh.cross_axes == ("dp", "sp")
    lines = mesh.lines("sp")
    assert [mesh.shard_indices("sp", line) for line in lines] == [[0, 1], [0]]
    assert [mesh.axis_ranks("sp", line) for line in lines] == [(0,), (0, 1)]
    assert mesh.cells == mesh.accountable_cells == [0, 1]
    local = mesh.local
    assert local.shape["dp"] == 2 and local.devices[1, 0, 0, 0, 1, 0] is None
    assert sum(d is not None for d in local.devices.flat) == 3
    with pytest.raises(CrossProcessAxisError, match="pipeline.*queue 1"):
        make_mesh({"dp": 3, "pp": 2}, [torch.device("cpu")] * 3)


class _QueueHop:
    """A two-rank hop inside one process: each rank's sends land in the
    other rank's inbox (one for each direction)."""

    def __init__(self, inboxes, rank):
        self.inboxes, self.rank = inboxes, rank

    def exchange(self, tensors, device, reverse=False):
        self.inboxes[1 - self.rank][reverse].put([t.detach().clone() for t in tensors])
        return tuple(t.to(device) for t in self.inboxes[self.rank][reverse].get(timeout=60))


@pytest.mark.parametrize("kind", ["flash", "scan"])
def test_run_ring_over_a_two_rank_hop(kind):
    """Two threads, each a rank driving shards 0-3 or 4-7 of an 8-shard
    causal ring (at their global indices) through ``run_ring`` with a
    hop between them: their output chunks and their shards' gradients
    equal the single-process ring's bit for bit, for the flash ring (the
    kernels' plain versions; a manual backward ring) and the scan ring
    (autograd through the hop)."""
    import queue
    import threading

    from relayrl_tpu_torch.parallel import ring, ring_flash

    B, T, H, D, n = 2, 64, 2, 16, 8
    gen = torch.Generator().manual_seed(0)
    qkv = [torch.randn(B, T, H, D, generator=gen) for _ in range(3)]
    g_out = torch.randn(B, T, H, D, generator=gen)
    cpu = torch.device("cpu")

    def attend(chunks, devices, span=None):
        if kind == "flash":
            return ring_flash._ring_flash(*chunks, devices, True, ring_flash.CHUNK_CALLS,
                                          span)
        return ring.ring_attention_sharded(*chunks, devices, True, span)

    def run(indices, span=None):
        leaves = [x.clone().requires_grad_() for x in qkv]
        C = T // n
        chunks = [[x[:, i * C:(i + 1) * C] for i in indices] for x in leaves]
        outs = attend(chunks, [cpu] * len(indices), span)
        torch.autograd.backward(outs, [g_out[:, i * C:(i + 1) * C] for i in indices])
        return torch.cat(outs, dim=1), [x.grad for x in leaves]

    want_out, want_grads = run(range(n))
    inboxes = [[queue.Queue(), queue.Queue()] for _ in range(2)]
    got, errors = {}, []

    def rank_main(r):
        try:
            span = ring.RingSpan((cpu,) * 4, tuple(range(4 * r, 4 * r + 4)), n,
                                 _QueueHop(inboxes, r))
            got[r] = run(span.indices, span)
        except Exception as e:  # reported by the assert below
            errors.append(e)
            for inbox in inboxes[1 - r]:
                inbox.put([])  # unblocks the other rank's wait

    threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert torch.equal(torch.cat([got[0][0], got[1][0]], dim=1), want_out)
    for j in range(3):
        # Each rank holds its shards' gradients (zeros at the other's).
        assert torch.equal(got[0][1][j] + got[1][1][j], want_grads[j])


class _QueuePipeHop:
    """Pipeline ranks inside one process, each holding an equal block of
    the stages in order (``boxes``: one rank's inboxes each): each rank's
    hand-offs land in its neighbour's inbox for their direction, its
    broadcasts in every other rank's inbox for their source, and ``log``
    records each hand-off as ``(reverse, sent, received)``."""

    def __init__(self, boxes, rank):
        n = len(boxes)
        self.boxes, self.rank = boxes, rank
        self.up = rank - 1 if rank > 0 else None
        self.down = rank + 1 if rank < n - 1 else None
        self.first, self.last = 0, n - 1
        self.log = []

    def _send(self, tensors, reverse):
        to = self.up if reverse else self.down
        self.boxes[to][reverse].put([t.detach().clone() for t in tensors])

    def exchange(self, tensors, device, reverse=False, like=None):
        self.log.append((reverse, bool(tensors), bool(like)))
        if tensors:
            self._send(tensors, reverse)
        if not like:
            return ()
        got = self.boxes[self.rank][reverse].get(timeout=60)
        assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in like]
        return tuple(t.to(device) for t in got)

    def broadcast(self, t, src, like, device):
        if self.rank == src:
            for r, box in enumerate(self.boxes):
                if r != src:
                    box["bcast", src].put(t.detach().clone())
            return t.detach().clone().to(device)
        return self.boxes[self.rank]["bcast", src].get(timeout=60).to(device)


class _SwappingHop(_QueuePipeHop):
    """A hop that hands the first two gradients it sends back upstream
    over in swapped order (microbatch m's gradient lands on m - 1's)."""

    held = None
    swapped = False

    def exchange(self, tensors, device, reverse=False, like=None):
        if reverse and tensors and not self.swapped:
            if self.held is None:
                self.held, tensors = tensors, ()
            else:
                self._send(tensors, reverse)
                tensors, self.swapped = self.held, True
        return super().exchange(tensors, device, reverse, like)


def _pipe_mesh(n_stages, rank=None, n_ranks=2):
    """A pp line of ``n_stages`` CPU devices: every stage this process's
    (``rank`` None), or ``n_ranks`` ranks each holding an equal block of
    the stages in order, the others' entries None."""
    from relayrl_tpu_torch.parallel.mesh import AXES, Mesh

    dims = (1,) * (len(AXES) - 1) + (n_stages,)
    devices = np.empty(n_stages, dtype=object)
    if rank is None:
        devices[:] = [torch.device("cpu")] * n_stages
        return Mesh(devices.reshape(dims))
    owners = np.arange(n_stages) // (n_stages // n_ranks)
    for s in np.flatnonzero(owners == rank):
        devices[s] = torch.device("cpu")
    return Mesh(devices.reshape(dims), n_ranks, rank, owners.reshape(dims))


def _pipeline_ranks(n_stages, n_ranks=2, swap_rank=None, train_input=True):
    """A 4-layer tanh MLP pipelined over ``n_stages`` stages, 4
    microbatches of 2 rows, its gradients taken by ``dp_gradients``: the
    single-process pipeline's output and gradients (x's and every
    layer's), and each of ``n_ranks`` thread-ranks' (rank r's layer
    gradients only at its stages) and hop (a :class:`_SwappingHop` at
    ``swap_rank``). ``train_input`` False asks no gradient before the
    pipeline (a frozen embedding): x's gradient is None."""
    import queue
    import threading

    from relayrl_tpu_torch.parallel import context, pipeline_apply

    gen = torch.Generator().manual_seed(0)
    ws = [torch.randn(8, 8, generator=gen) * 0.4 for _ in range(4)]
    x0 = torch.randn(8, 8, generator=gen)
    g_out = torch.randn(8, 8, generator=gen)
    per = 4 // n_stages

    def stage(layers, h):
        for w in layers:
            h = torch.tanh(h @ w)
        return h

    def run(mesh, hop=None):
        layers = [w.clone().requires_grad_() for w in ws]
        x = x0.clone().requires_grad_(train_input)
        y = pipeline_apply(stage, layers, x * 1.5, mesh, n_microbatches=4, hop=hop)
        mine = [w for i, w in enumerate(layers) if mesh.devices.flat[i // per] is not None]
        for w in mine:
            w.split_comms = (("pp", hop),)  # as the placement marks a stage's leaves
        k = int(train_input)
        grads = context.dp_gradients((y * g_out).sum(), [x][:k] + mine)
        return y.detach(), grads[0] if k else None, grads[k:]

    want = run(_pipe_mesh(n_stages))
    boxes = [{key: queue.Queue() for key in [False, True] + [("bcast", r) for r in
                                                               range(n_ranks)]}
             for _ in range(n_ranks)]
    hops = [(_SwappingHop if r == swap_rank else _QueuePipeHop)(boxes, r)
            for r in range(n_ranks)]
    got, errors = {}, []

    def rank_main(r):
        try:
            got[r] = run(_pipe_mesh(n_stages, r, n_ranks), hops[r])
        except Exception as e:  # reported by the caller's assert
            errors.append(e)

    threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(n_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return want, got, hops


@pytest.mark.parametrize("n_stages,n_ranks,train_input", [(2, 2, True), (4, 2, True),
                                                          (4, 4, True), (2, 2, False),
                                                          (4, 4, False)])
def test_pipeline_over_thread_rank_hops(n_stages, n_ranks, train_input):
    """``pipeline_apply`` over a pp line split between thread-ranks (one
    stage a rank, two with a local hand-off beside the hop, or four ranks
    whose middle ones send and receive in one hand-off) equals the
    single-process pipeline bit for bit: every rank holds the output,
    every rank gets the input's gradient (stage 0's rank's, broadcast),
    and each rank's stages' layer gradients are the single-process ones.
    With no gradient asked before the pipeline (a frozen embedding) the
    last stage's rank still runs its hops' backwards, so stage 0's rank
    gets its gradients (a rank that pruned them would leave the others
    waiting)."""
    (want_y, want_dx, want_dw), got, _ = _pipeline_ranks(n_stages, n_ranks,
                                                         train_input=train_input)
    per = len(want_dw) // n_ranks
    for r in range(n_ranks):
        y, dx, dw = got[r]
        assert torch.equal(y, want_y)
        assert dx is None if not train_input else torch.equal(dx, want_dx)
        assert len(dw) == per
        for g, w in zip(dw, want_dw[r * per:(r + 1) * per]):
            assert torch.equal(g, w)


@pytest.mark.parametrize("n_ranks,swap_rank", [(2, 1), (4, 2)])
def test_swapped_backward_hops_are_caught(n_ranks, swap_rank):
    """A hop that swaps two microbatches' gradients on their way back
    (same shape, nothing raises; at the last rank, or at a middle one)
    moves the layer gradients of every rank upstream of it and the
    input's on every rank: the comparison above fails on it. The layer
    gradients of the swapping rank and those downstream do not depend on
    the hop."""
    (_, want_dx, want_dw), got, _ = _pipeline_ranks(n_ranks, n_ranks, swap_rank)
    per = len(want_dw) // n_ranks
    for r in range(n_ranks):
        assert not torch.equal(got[r][1], want_dx)
        assert torch.equal(got[r][2][0], want_dw[r * per]) == (r >= swap_rank), r


_F, _T = False, True


@pytest.mark.parametrize("n_ranks,logs", [
    (2, [[(_F, _T, _F)] * 4 + [(_T, _F, _T)] * 4,
         [(_F, _F, _T)] * 4 + [(_T, _T, _F)] * 4]),
    (4, [[(_F, _T, _F)] * 4 + [(_T, _F, _T)] * 4]
     + [[(_F, _F, _T)] + [(_F, _T, _T)] * 3 + [(_F, _T, _F)]
        + [(_T, _F, _T)] + [(_T, _T, _T)] * 3 + [(_T, _T, _F)]] * 2
     + [[(_F, _F, _T)] * 4 + [(_T, _T, _F)] * 4]),
])
def test_last_stage_sends_nothing(n_ranks, logs):
    """Each hand-off as ``(reverse, sent, received)``, one stage a rank:
    the last stage's rank receives every microbatch's activation and
    sends none (nor receives a gradient); stage 0's rank sends each one
    and receives nothing (and each gradient back); a middle rank
    receives the next microbatch while it sends the last one on, in one
    hand-off. Each rank's backward runs its hand-offs in reverse."""
    _, _, hops = _pipeline_ranks(n_ranks, n_ranks)
    assert [hop.log for hop in hops] == logs


class CollectiveOrderError(AssertionError):
    """Two members of a group met one collective at different places of
    their own sequences of cross-process pieces."""


class _Ranks:
    """What the four thread-ranks of :func:`_split_pipeline_ranks` share:
    each rank's count of the cross-process pieces it met (pipeline hops
    and broadcasts, the fsdp group's collectives, in one sequence), and
    the event that a failed rank sets, so its partners stop waiting."""

    def __init__(self, n, timeout):
        import threading

        self.seq = [0] * n
        self.abort = threading.Event()
        self.timeout = timeout
        self.log = [[] for _ in range(n)]

    def piece(self, rank, what):
        self.seq[rank] += 1
        self.log[rank].append(what)
        return self.seq[rank]

    def get(self, box, what):
        """``box``'s next item, waiting until a partner fails or the
        timeout passes (a named error, not a hang)."""
        import queue
        import time

        deadline = time.monotonic() + self.timeout
        while True:
            try:
                return box.get(timeout=0.02)
            except queue.Empty:
                if self.abort.is_set():
                    raise RuntimeError(f"{what}: a partner failed") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{what}: nothing after {self.timeout} s") from None


class _OrderedPipeHop:
    """A pp group's hop between two thread-ranks (``members``, global
    ranks in stage order) whose every hand-off carries the sender's place
    in its sequence; the receiver raises :class:`CollectiveOrderError`
    when it meets the hand-off at another place of its own."""

    def __init__(self, shared, boxes, members, rank):
        self.shared, self.boxes, self.members = shared, boxes, members
        self.me = rank
        self.rank = members.index(rank)
        self.up = members[self.rank - 1] if self.rank > 0 else None
        self.down = members[self.rank + 1] if self.rank < len(members) - 1 else None
        self.first, self.last = 0, len(members) - 1

    def _check(self, got, mine, what):
        theirs, tensors = got
        if theirs != mine:
            raise CollectiveOrderError(f"rank {self.me} met {what} as its piece {mine}, "
                                       f"its partner as piece {theirs}")
        return tensors

    def exchange(self, tensors, device, reverse=False, like=None):
        mine = self.shared.piece(self.me, ("hop", reverse))
        to = self.up if reverse else self.down
        if tensors:
            self.boxes[to][reverse].put((mine, [t.detach().clone() for t in tensors]))
        if not like:
            return ()
        got = self._check(self.shared.get(self.boxes[self.me][reverse], "a hop"), mine,
                          "a hop")
        return tuple(t.to(device) for t in got)

    def broadcast(self, t, src, like, device):
        mine = self.shared.piece(self.me, ("broadcast", src))
        if self.rank == src:
            for r in self.members:
                if r != self.me:
                    self.boxes[r]["bcast"].put((mine, t.detach().clone()))
            return t.detach().clone().to(device)
        got = self.shared.get(self.boxes[self.me]["bcast"], "a broadcast")
        return self._check(got, mine, "a broadcast").to(device)


class _OrderedGroup:
    """An fsdp group of two thread-ranks (also their data group): each
    collective is a barrier at which the members compare their places in
    their sequences (:class:`CollectiveOrderError` when they differ)."""

    dp = None

    def __init__(self, shared, members, rank, slots, barrier):
        self.shared, self.members, self.me = shared, members, rank
        self.rank, self.size = members.index(rank), len(members)
        self.slots, self.barrier = slots, barrier

    def _exchange(self, t, what):
        import threading

        mine = self.shared.piece(self.me, what)
        self.slots[self.rank] = (mine, what, t.detach().clone())
        try:
            self.barrier.wait(timeout=self.shared.timeout)
        except threading.BrokenBarrierError:
            raise RuntimeError(f"{what}: a partner failed") from None
        seen = [(s[0], s[1]) for s in self.slots]
        got = [s[2].clone() for s in self.slots]
        try:
            self.barrier.wait(timeout=self.shared.timeout)
        except threading.BrokenBarrierError:
            raise RuntimeError(f"{what}: a partner failed") from None
        if len(set(seen)) != 1:
            raise CollectiveOrderError(f"ranks {self.members} met a collective as "
                                       f"{seen} (place, kind)")
        return got

    def all_gather(self, t):
        return self._exchange(t, "all_gather")

    def all_reduce(self, flat):
        flat.copy_(sum(self._exchange(flat, "all_reduce")))
        return flat

    def reduce_scatter(self, chunks):
        flat = torch.cat([c.reshape(-1) for c in chunks])
        n = chunks[self.rank].numel()
        total = sum(self._exchange(flat, "reduce_scatter"))
        return total[self.rank * n:(self.rank + 1) * n].reshape(chunks[self.rank].shape)


def _split_pipeline_ranks(eager_rank=None, timeout=20.0):
    """A tanh MLP of 4 layers pipelined over 2 stages, its input embedded
    by ``E`` and its output read by a head ``H``, both split in half over
    fsdp 2: four thread-ranks, rank ``r`` at stage ``r % 2`` and fsdp
    coordinate ``r // 2`` (pp groups (0, 1), (2, 3); fsdp groups, also
    the data groups, (0, 2), (1, 3)), fsdp coordinate ``f`` feeding its
    own 4 rows in 2 microbatches. Each rank gathers its halves of ``E``
    and ``H`` in one all-gather, pipelines, and takes its gradients by
    ``dp_gradients`` (its stage's layers summed over the data group, its
    halves of ``E`` and ``H`` reduce-scattered). ``eager_rank`` instead
    reduce-scatters ``H``'s gradient as soon as the engine has it (an
    overlapping fsdp's habit: the head's backward, before its hops). Returns the
    single-process gradients (``E``, ``H``, every layer's), each rank's
    gradients (or None where it failed), the errors, each rank's sequence
    and the seconds the ranks took."""
    import queue
    import threading
    import time
    from types import SimpleNamespace

    from relayrl_tpu_torch.parallel import context, pipeline_apply
    from relayrl_tpu_torch.parallel.sharding import _gather_bucket

    gen = torch.Generator().manual_seed(1)
    E0, H0 = torch.randn(8, 8, generator=gen) * 0.5, torch.randn(8, 8, generator=gen) * 0.5
    ws = [torch.randn(8, 8, generator=gen) * 0.4 for _ in range(4)]
    rows = [torch.randn(4, 8, generator=gen) for _ in range(2)]
    g_out = [torch.randn(4, 8, generator=gen) for _ in range(2)]
    spec = SimpleNamespace(spec=("fsdp", None))

    def stage(layers, h):
        for w in layers:
            h = torch.tanh(h @ w)
        return h

    E, H = E0.clone().requires_grad_(), H0.clone().requires_grad_()
    layers = [w.clone().requires_grad_() for w in ws]
    loss = sum(((stage(layers, x @ E) @ H) * g).sum() for x, g in zip(rows, g_out))
    want = torch.autograd.grad(loss, [E, H] + layers)

    shared = _Ranks(4, timeout)
    boxes = [{False: queue.Queue(), True: queue.Queue(), "bcast": queue.Queue()}
             for _ in range(4)]
    slots = [[None, None], [None, None]]
    barriers = [threading.Barrier(2), threading.Barrier(2)]
    got, errors = [None] * 4, []

    def rank_main(r):
        s, f = r % 2, r // 2
        try:
            group = _OrderedGroup(shared, (s, s + 2), r, slots[s], barriers[s])
            hop = _OrderedPipeHop(shared, boxes, (2 * f, 2 * f + 1), r)
            halves = [E0.chunk(2)[f].clone().requires_grad_(),
                      H0.chunk(2)[f].clone().requires_grad_()]
            for h in halves:
                h.summed_over_fsdp = True
            mine = [w.clone().requires_grad_() for w in ws[2 * s:2 * s + 2]]
            for w in mine:
                w.split_comms = (("pp", hop),)
            whole_e, whole_h = _gather_bucket(group, [(spec, 0, h) for h in halves])
            y = pipeline_apply(stage, [None] * 2 * s + mine + [None] * (2 - 2 * s),
                               rows[f] @ whole_e, _pipe_mesh(2, s), n_microbatches=2, hop=hop)
            out = y @ whole_h
            if r == eager_rank:
                # H's gradient reduce-scattered where the head's backward
                # computes it, the first node the engine runs.
                def eager(grads, _):
                    group.reduce_scatter(list(grads[1].chunk(2)))

                out.grad_fn.register_hook(eager)
            with context.use_dp_group(group):
                got[r] = context.dp_gradients((out * g_out[f]).sum(), halves + mine)
        except Exception as e:  # reported by the caller's assert
            errors.append(e)
            shared.abort.set()
            for b in barriers:
                b.abort()

    t0 = time.monotonic()
    threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=3 * timeout)
    assert not any(t.is_alive() for t in threads), "a thread-rank hung"
    return want, got, errors, shared.log, time.monotonic() - t0


def test_pipeline_beside_a_split_over_thread_ranks():
    """Four thread-ranks, a pp line per fsdp coordinate and an fsdp group
    per pp coordinate: every rank meets each collective at the same place
    of its sequence as its partners (the harness raises otherwise), its
    backward meets its hops, then its reduce-scatters, then the data
    group's sum; its halves of ``E`` and ``H`` take the single-process
    gradients' halves and its stage's layers theirs (within 1e-6: each
    data group's rows summed apart, then added)."""
    want, got, errors, log, _ = _split_pipeline_ranks()
    assert not errors, errors
    for r in range(4):
        s, f = r % 2, r // 2
        for g, w in zip(got[r][:2], want[:2]):
            torch.testing.assert_close(g, w.chunk(2)[f], rtol=0, atol=1e-6)
        for g, w in zip(got[r][2:], want[2 + 2 * s:4 + 2 * s]):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
        kinds = [k if isinstance(k, str) else k[0] for k in log[r]]
        backward = kinds[kinds.index("broadcast") + 1:]
        assert backward[-3:] == ["reduce_scatter", "reduce_scatter", "all_reduce"], log[r]
        assert "reduce_scatter" not in backward[:-3], log[r]


@pytest.mark.parametrize("eager_rank", [0, 3])
def test_split_collective_swapped_with_a_hop_is_caught(eager_rank):
    """A rank that reduce-scatters ``H``'s gradient as soon as the engine
    has it meets that collective before its backward hops, where its fsdp
    partner meets it after them: the group's check raises
    :class:`CollectiveOrderError` within the harness's timeout, and every
    thread-rank ends (no hang)."""
    _, _, errors, _, seconds = _split_pipeline_ranks(eager_rank, timeout=10.0)
    assert any(isinstance(e, CollectiveOrderError) for e in errors), errors
    assert seconds < 10.0, seconds


class _LineOrder:
    """What the thread-ranks of :func:`_straddled_ring_ranks` share: each
    rank's pass (forward: lines ascending; backward: descending) and the
    last line it met in it; a rank that meets an earlier line after a
    later one in its forward (a later one after an earlier one in its
    backward) is caught by every partner it meets there."""

    def __init__(self, n, timeout):
        import threading

        self.passes = [None] * n
        self.last = [None] * n
        self.abort = threading.Event()
        self.timeout = timeout
        self.log = [[] for _ in range(n)]

    def begin(self, rank, direction):
        self.passes[rank], self.last[rank] = direction, None

    def meet(self, rank, line, what):
        prev = self.last[rank]
        self.last[rank] = line
        self.log[rank].append((what, line))
        return (self.passes[rank], prev)

    @staticmethod
    def check(stamps, line, ranks):
        for (direction, prev), r in zip(stamps, ranks):
            late = prev is not None and (prev > line if direction == "forward"
                                         else prev < line)
            if late:
                raise CollectiveOrderError(
                    f"rank {r} met line {line} after line {prev} in its {direction}")


class _LineGroup:
    """One line's ring across thread-ranks (``members``, global ranks in
    ring order): the hop between them, the all-gather and the broadcast,
    each checking every member's line order (:class:`_LineOrder`)."""

    def __init__(self, shared, line, members):
        import queue
        import threading

        self.shared, self.line, self.members = shared, line, tuple(members)
        self.boxes = {r: {False: queue.Queue(), True: queue.Queue()} for r in members}
        self.slots = [None] * len(members)
        self.barrier = threading.Barrier(len(members))

    def _get(self, box, what):
        import queue
        import time

        deadline = time.monotonic() + self.shared.timeout
        while True:
            try:
                return box.get(timeout=0.02)
            except queue.Empty:
                if self.shared.abort.is_set():
                    raise RuntimeError(f"{what}: a partner failed") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{what}: nothing after {self.shared.timeout} s") \
                        from None

    def exchange(self, me, tensors, device, reverse):
        i = self.members.index(me)
        n = len(self.members)
        to = self.members[(i - 1) % n if reverse else (i + 1) % n]
        stamp = self.shared.meet(me, self.line, "hop")
        self.boxes[to][reverse].put((me, stamp, [t.detach().clone() for t in tensors]))
        sender, theirs, got = self._get(self.boxes[me][reverse], "a hop")
        _LineOrder.check([stamp, theirs], self.line, [me, sender])
        return tuple(t.to(device) for t in got)

    def collective(self, me, value, what):
        import threading

        stamp = self.shared.meet(me, self.line, what)
        self.slots[self.members.index(me)] = (me, stamp, value)
        for _ in range(2):
            try:
                self.barrier.wait(timeout=self.shared.timeout)
            except threading.BrokenBarrierError:
                raise RuntimeError(f"{what}: a partner failed") from None
            if _ == 0:
                slots = list(self.slots)
        _LineOrder.check([s[1] for s in slots], self.line, [s[0] for s in slots])
        return [s[2] for s in slots]


class _LineHop:
    """A ring span's hop for one thread-rank (``RingSpan.hop``): its
    exchanges go through the line's :class:`_LineGroup`; ``group`` is the
    line group itself, which the patched all-gather and broadcast take."""

    def __init__(self, group, me):
        self.group, self.me = group, me

    def exchange(self, tensors, device, reverse=False, like=None):
        return self.group.exchange(self.me, tensors, device, reverse)


def _straddled_ring_ranks(monkeypatch, swap_rank=None, timeout=20.0):
    """``{"dp": 3, "sp": 4}`` over 4 thread-ranks of 3 entries (the owners
    ``[[0, 0, 0, 1], [1, 1, 2, 2], [2, 3, 3, 3]]``): every ring crosses,
    ranks 1 and 2 sit in two rings each. Each rank drives its lines'
    rings through ``ring.over_spans`` (the flash ring's plain versions, one
    row a data cell, T 32 in chunks of 8) and backpropagates its output
    gradient on the rows it leads (zeros on the others: their losses
    count on the lead). ``swap_rank`` drives its two lines in the other
    order. Returns the single-process output and q, k, v gradients, each
    rank's (or None where it failed), the errors, each rank's log and the
    seconds the ranks took."""
    import threading
    import time

    from relayrl_tpu_torch.parallel import ring, ring_flash

    owners = np.arange(12).reshape(3, 4) // 3
    T, H, D, n = 32, 2, 8, 4
    gen = torch.Generator().manual_seed(3)
    qkv = [torch.randn(3, T, H, D, generator=gen) for _ in range(3)]
    g_out = torch.randn(3, T, H, D, generator=gen)
    cpu = torch.device("cpu")

    def sharded(qs, ks, vs, devices, span):
        return ring_flash._ring_flash(qs, ks, vs, devices, True, ring_flash.CHUNK_CALLS, span)

    def run(spans, rows):
        leaves = [x[rows].clone().requires_grad_() for x in qkv]
        return ring.over_spans(spans, sharded)(*leaves), leaves

    out, leaves = run([ring.whole_ring([cpu] * n)] * 3, slice(0, 3))
    torch.autograd.backward(out, g_out)
    want = (out.detach(), [x.grad for x in leaves])

    shared = _LineOrder(4, timeout)
    groups = {line: _LineGroup(shared, line, tuple(dict.fromkeys(int(r) for r in owners[line])))
              for line in range(3)}
    local = threading.local()
    monkeypatch.setattr(distributed, "process_index", lambda: local.rank)

    def all_gather(out_list, t, group=None):
        for o, v in zip(out_list, group.collective(local.rank, t.detach().clone(),
                                                   "all_gather")):
            o.copy_(v)

    def broadcast(t, src, group=None):
        got = group.collective(local.rank, t.detach().clone(), "broadcast")
        t.copy_(got[group.members.index(src)])

    monkeypatch.setattr(torch.distributed, "all_gather", all_gather)
    monkeypatch.setattr(torch.distributed, "broadcast", broadcast)
    got, errors = [None] * 4, []

    def rank_main(r):
        local.rank = r
        try:
            lines = [line for line in range(3) if r in owners[line]]
            spans = []
            for line in lines:
                row = [int(o) for o in owners[line]]
                if set(row) == {r}:
                    spans.append(ring.whole_ring([cpu] * n))
                    continue
                idx = [i for i, o in enumerate(row) if o == r]
                spans.append(ring.RingSpan((cpu,) * len(idx), tuple(idx), n,
                                           _LineHop(groups[line], r), min(row),
                                           tuple(row.count(o) for o in dict.fromkeys(row))))
            shared.begin(r, "forward")
            if r == swap_rank:
                # Each line a call, the later one first.
                runs = [run([span], slice(line, line + 1))
                        for line, span in zip(lines[::-1], spans[::-1])][::-1]
            else:
                # Every line in one call: over_spans drives them in turn.
                runs = [run(spans, slice(lines[0], lines[-1] + 1))]
            shared.begin(r, "backward")
            grads = [g_out[line:line + 1] if int(owners[line].min()) == r
                     else torch.zeros_like(g_out[line:line + 1]) for line in lines]
            if r != swap_rank:
                grads = [torch.cat(grads)]
            torch.autograd.backward([out for out, _ in runs], grads)
            got[r] = (torch.cat([out for out, _ in runs]).detach(),
                      [torch.cat([lv[j].grad for _, lv in runs]) for j in range(3)], lines)
        except Exception as e:  # reported by the caller's assert
            errors.append(e)
            shared.abort.set()
            for g in groups.values():
                g.barrier.abort()

    t0 = time.monotonic()
    threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=3 * timeout)
    assert not any(t.is_alive() for t in threads), "a thread-rank hung"
    return want, got, errors, shared.log, time.monotonic() - t0


def test_ranks_in_two_rings_keep_line_order(monkeypatch):
    """``{"dp": 3, "sp": 4}`` over 4 thread-ranks: ranks 1 and 2 each sit
    in two crossing rings. Every rank meets its rings' hops, gathers and
    broadcasts in ascending line order in the forward and descending in
    the backward (the harness raises otherwise); each rank's output rows
    equal the single-process ring's bit for bit, and each line's q, k, v
    gradients are on its lead (the others zero), equal to the single
    process's."""
    want, got, errors, log, _ = _straddled_ring_ranks(monkeypatch)
    assert not errors, errors
    owners = np.arange(12).reshape(3, 4) // 3
    for r in range(4):
        out, grads, lines = got[r]
        assert torch.equal(out, want[0][lines[0]:lines[-1] + 1])
        for i, line in enumerate(lines):
            for g, w in zip(grads, want[1]):
                lead = int(owners[line].min()) == r
                assert torch.equal(g[i], w[line] if lead else torch.zeros_like(w[line]))
    assert {line for _, line in log[1]} == {0, 1} and {line for _, line in log[2]} == {1, 2}


@pytest.mark.parametrize("swap_rank", [1, 2])
def test_a_rank_that_swaps_its_two_rings_is_caught(monkeypatch, swap_rank):
    """A rank in two crossing rings that drives the later line first
    meets the earlier line's ring after it: a partner there raises
    :class:`CollectiveOrderError` within the harness's timeout, and every
    thread-rank ends (no hang)."""
    _, _, errors, _, seconds = _straddled_ring_ranks(monkeypatch, swap_rank, timeout=10.0)
    assert any(isinstance(e, CollectiveOrderError) for e in errors), errors
    assert seconds < 10.0, seconds
