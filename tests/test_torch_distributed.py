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


@pytest.mark.parametrize("spec", [{"dp": 1, "fsdp": -1}, {"dp": 1, "sp": 4, "tp": 2},
                                  {"dp": 1, "pp": 8}])
def test_axis_across_processes_refused(monkeypatch, spec):
    _two_process_topology(monkeypatch, 0)
    with pytest.raises(CrossProcessAxisError, match="queue 1 item 11"):
        make_mesh(spec, [torch.device("cpu")] * 4)


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
