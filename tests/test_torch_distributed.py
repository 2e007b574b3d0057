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
def test_pp_beside_a_crossing_split_refused(monkeypatch, spec, n, world, beside):
    """A crossing pp axis runs beside dp alone: beside a crossing fsdp,
    ep, tp or sp the mesh raises the named error, naming that axis."""
    _topology(monkeypatch, 0, world)
    with pytest.raises(CrossProcessAxisError,
                       match=rf"pp crosses processes beside \['{beside}'\].*queue 1 item 11"):
        make_mesh(spec, [torch.device("cpu")] * n)


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
    (a block would hold the end of one fsdp line and the start of the
    next), now that fsdp and tp may cross."""
    _topology(monkeypatch, 0, 3)
    with pytest.raises(CrossProcessAxisError, match="sub-grid.*queue 1 item 11"):
        make_mesh({"dp": 1, "fsdp": 2, "tp": 3}, [torch.device("cpu")] * 2)


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
    """Blocks of 3 devices over a ``{"dp": 3, "sp": 2}`` mesh split a dp
    row between processes unevenly (only dp and sp cross, but a ring would
    hold 1 shard on one rank and 1 on the other of a row the first rank
    also holds)."""
    _two_process_topology(monkeypatch, 0)
    with pytest.raises(CrossProcessAxisError, match="queue 1 item 11"):
        make_mesh({"dp": 3, "sp": 2}, [torch.device("cpu")] * 3)


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
