"""Multi-process bring-up: ``torch.distributed`` process groups.

Counterpart of :mod:`relayrl_tpu.parallel.distributed`. The JAX package
scales its learner across hosts with ``jax.distributed``; the port starts
a ``torch.distributed`` process group over a TCP store at the coordinator
address, and the learner's ``dp`` axis spans the processes
(:func:`relayrl_tpu_torch.parallel.mesh.make_mesh`).

Resolution order for each knob: explicit argument > environment variable
(``RELAYRL_COORDINATOR`` / ``RELAYRL_NUM_PROCESSES`` /
``RELAYRL_PROCESS_ID``, falling back to ``JAX_COORDINATOR_ADDRESS`` etc.,
the JAX package's names) > config ``learner.distributed`` section >
single-process no-op.

The backend rule: ``nccl`` when every rank computes on a card of its own,
``gloo`` on the CPU or when ranks share a card (NCCL refuses two ranks on
one device). A rank's compute device is its first local device:
``local_device_ids`` names this rank's cards, else every visible card is
local, as in the JAX package. The ranks tell each other their device (the
card's UUID, which ``CUDA_VISIBLE_DEVICES`` does not rename) through the
store before the group forms, so every rank picks the same backend.
Under ``nccl`` the host-side traffic (the server's control descriptor and
its batches) rides a second, ``gloo`` group; under ``gloo`` one group
carries both. Gloo carries CUDA tensors for ``broadcast`` and
``all_reduce``, the only collectives the learner runs on the device.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Any, Mapping

import numpy as np
import torch

_info: dict | None = None  # cached result of the first successful resolution
_runtime: "_Runtime | None" = None  # the live process groups (multi-process)

# How long a collective (and the rendezvous) may wait for a peer before the
# group raises: long enough for a rank's first update and checkpoint.
TIMEOUT_S = 600.0


def _env(*names: str) -> str | None:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


class _Runtime:
    """This process's rank, its local devices and its process groups."""

    def __init__(self, rank: int, world: int, devices: list[torch.device],
                 backend: str, host_group):
        self.rank, self.world = rank, world
        self.devices, self.backend = devices, backend
        self.host_group = host_group


def _device_identity(device: torch.device | None) -> str:
    """What makes a compute device unique across hosts: the card's UUID,
    or ``cpu`` on the host."""
    if device is None or device.type != "cuda":
        return "cpu"
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return f"cuda:{socket.gethostname()}:{uuid if uuid is not None else device.index}"


def choose_backend(identities: list[str]) -> str:
    """``nccl`` when every rank names a card and no two name the same one,
    else ``gloo``."""
    if all(i.startswith("cuda:") for i in identities) \
            and len(set(identities)) == len(identities):
        return "nccl"
    return "gloo"


def _local_devices(local_device_ids) -> list[torch.device]:
    if local_device_ids is not None:
        return [torch.device("cuda", int(i)) for i in local_device_ids]
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return []


def _start(coordinator_address: str, num_processes: int, process_id: int,
           local_device_ids) -> _Runtime:
    import torch.distributed as dist

    host, _, port = coordinator_address.removeprefix("tcp://").rpartition(":")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store = dist.TCPStore(host or "127.0.0.1", int(port), num_processes,
                          is_master=process_id == 0, timeout=timeout)
    devices = _local_devices(local_device_ids)
    compute = devices[0] if devices else None
    store.set(f"relayrl/device/{process_id}", _device_identity(compute))
    identities = [store.get(f"relayrl/device/{r}").decode()
                  for r in range(num_processes)]
    backend = choose_backend(identities)
    if backend == "nccl":
        torch.cuda.set_device(compute)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    host_group = (dist.new_group(backend="gloo", timeout=timeout)
                  if backend == "nccl" else dist.group.WORLD)
    return _Runtime(process_id, num_processes, devices, backend, host_group)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    config: Mapping[str, Any] | None = None,
) -> dict:
    """Start the process group when a multi-process topology is
    configured; no-op for a single process. Repeat calls return the cached
    topology from the first call (regardless of later args). Call it
    before building a mesh or an algorithm.

    Returns ``{"multi_host": bool, "process_id": int, "num_processes": int}``.
    """
    global _info, _runtime
    if _info is not None:
        return dict(_info)

    dist_cfg = dict((config or {}).get("distributed", {})) if config else {}
    coordinator_address = (
        coordinator_address
        or _env("RELAYRL_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
        or dist_cfg.get("coordinator"))
    if num_processes is None:
        raw = _env("RELAYRL_NUM_PROCESSES", "JAX_NUM_PROCESSES")
        num_processes = int(raw) if raw else int(dist_cfg.get("num_processes", 1))

    if num_processes <= 1 or coordinator_address is None:
        _info = {"multi_host": False, "process_id": 0, "num_processes": 1}
        return dict(_info)

    if process_id is None:
        raw = _env("RELAYRL_PROCESS_ID", "JAX_PROCESS_ID")
        if raw:
            process_id = int(raw)
        elif "process_id" in dist_cfg:
            # A config file is shared between hosts, so a config process_id
            # would make every host claim the same rank and the rendezvous
            # would hang waiting for the others.
            raise ValueError(
                "multi-host setup (num_processes="
                f"{num_processes}) needs a per-host process id: pass "
                "process_id= or set RELAYRL_PROCESS_ID on each host — a "
                "process_id in the shared config would give every host the "
                "same rank")
        else:
            raise ValueError(
                "multi-host setup (num_processes="
                f"{num_processes}) needs a per-host process id: pass "
                "process_id= or set RELAYRL_PROCESS_ID on each host")

    _runtime = _start(coordinator_address, num_processes, int(process_id),
                      local_device_ids)
    _info = {"multi_host": True, "process_id": _runtime.rank,
             "num_processes": _runtime.world}
    return dict(_info)


def shutdown_distributed() -> None:
    """Tear the process group down and forget the cached topology, so a
    later :func:`initialize_distributed` resolves afresh."""
    global _info, _runtime
    if _runtime is not None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    _info, _runtime = None, None


def process_index() -> int:
    """Rank of this process (0 before :func:`initialize_distributed`)."""
    if _info is not None:
        return int(_info["process_id"])
    return 0


def process_count() -> int:
    """Number of processes (1 before :func:`initialize_distributed`)."""
    if _info is not None:
        return int(_info["num_processes"])
    return 1


def is_coordinator() -> bool:
    """True on the process that runs ingest and logging (process 0): the
    actor plane binds on the coordinator; learner steps run on every
    process. Call :func:`initialize_distributed` first on multi-process
    setups."""
    return process_index() == 0


def backend() -> str | None:
    """The process group's backend (``nccl`` or ``gloo``), None for a
    single process."""
    return None if _runtime is None else _runtime.backend


def local_devices() -> list[torch.device]:
    """This rank's devices as the process group resolved them (empty on
    the CPU or for a single process)."""
    return [] if _runtime is None else list(_runtime.devices)


def barrier() -> None:
    """Wait for every process (host group); no-op for a single process."""
    if _runtime is not None:
        import torch.distributed as dist

        dist.barrier(group=_runtime.host_group)


def _leaves(tree, out: list) -> Any:
    """Flatten dicts, lists and tuples; returns the tree with leaf
    indices in place of the leaves."""
    if isinstance(tree, dict):
        return {k: _leaves(v, out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaves(v, out) for v in tree)
    if not isinstance(tree, (np.ndarray, np.generic, torch.Tensor)):
        raise TypeError(f"cannot broadcast a {type(tree).__name__} leaf")
    out.append(tree)
    return len(out) - 1


def _rebuild(skeleton, leaves: list):
    if isinstance(skeleton, dict):
        return {k: _rebuild(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_rebuild(v, leaves) for v in skeleton)
    return leaves[skeleton]


def _raw(leaf) -> np.ndarray:
    """A leaf's bytes as a flat uint8 array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)


def _from_raw(chunk: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        flat = torch.from_numpy(chunk.copy()).view(like.dtype)
        return flat.reshape(like.shape).to(like.device)
    arr = np.asarray(like)
    return chunk.copy().view(arr.dtype).reshape(arr.shape)


def broadcast_from_coordinator(tree):
    """Ship a tree of arrays (dicts, lists and tuples of numpy arrays or
    tensors) from the coordinator to every process, bit for bit.

    The actor plane is asymmetric (trajectory sockets bind on the
    coordinator only) while the learner step runs on every process: every
    process must hold the same batch. Single-process: the tree is returned
    unchanged. Multi-process: rank 0's values win; the others pass
    placeholders of the same shapes and dtypes (``mh_zero_batch``). The
    leaves travel as one byte buffer over the host group; a tensor comes
    back on its device, a numpy leaf as a new array."""
    if _info is None or not _info["multi_host"]:
        return tree
    import torch.distributed as dist

    leaves: list = []
    skeleton = _leaves(tree, leaves)
    raws = [_raw(leaf) for leaf in leaves]
    sizes = [r.size for r in raws]
    payload = torch.from_numpy(np.concatenate(raws) if raws
                               else np.zeros(0, np.uint8))
    dist.broadcast(payload, src=0, group=_runtime.host_group)
    data = payload.numpy()
    out, offset = [], 0
    for leaf, size in zip(leaves, sizes):
        out.append(_from_raw(data[offset:offset + size], leaf))
        offset += size
    return _rebuild(skeleton, out)


class DataParallelGroup:
    """The processes a ``dp`` axis spans and the sums the learner takes
    over them (:mod:`relayrl_tpu_torch.parallel.context`): ``rank`` is
    this process's block of the dp coordinates, ``size`` the number of
    blocks."""

    def __init__(self, rank: int, size: int, group=None):
        self.rank, self.size, self.group = rank, size, group

    def all_reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum ``flat`` over the group, in place; returns it."""
        import torch.distributed as dist

        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        return flat


def data_parallel_group() -> DataParallelGroup:
    """The group the learner's gradients and batch statistics are summed
    over: every process (dp is the only mesh axis that crosses them)."""
    if _runtime is None:
        raise RuntimeError("initialize_distributed has not started a "
                           "multi-process group")
    import torch.distributed as dist

    return DataParallelGroup(_runtime.rank, _runtime.world, dist.group.WORLD)
