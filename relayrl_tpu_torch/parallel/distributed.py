"""Multi-process bring-up: ``torch.distributed`` process groups.

Counterpart of :mod:`relayrl_tpu.parallel.distributed`. The JAX package
scales its learner across hosts with ``jax.distributed``; the port starts
a ``torch.distributed`` process group over a TCP store at the coordinator
address, and the learner's ``dp``, ``fsdp``, ``ep``, ``tp``, ``sp`` and
``pp`` axes may span the processes (:func:`relayrl_tpu_torch.parallel.mesh.
make_mesh`). A mesh that spans them forms one group per line of each
crossing axis (:func:`form_axis_groups`): the dp groups (processes that
differ only in their dp coordinate); the data groups (those that differ
in their dp or fsdp coordinate: both axes consume batch), over which the
learner sums gradients and batch statistics (:func:`data_parallel_group`);
the fsdp, ep and tp groups, over which a split parameter gathers and its
gradient reduce-scatters and a layer split over ep or tp sums its partial
results (:func:`axis_comm`, :class:`AxisGroup`); the sp groups (the
processes of one ring), over which K/V chunks hop and the ring's chunks
gather (:func:`axis_group`); and the pp groups (the processes of one
pipeline), over which activations and their gradients hop between stages,
the pipeline's output and the feed's gradient are broadcast, and a
stage's parameters and moments are read from their owner
(:mod:`relayrl_tpu_torch.parallel.pipeline`, :meth:`AxisGroup.broadcast`).

Resolution order for each knob: explicit argument > environment variable
(``RELAYRL_COORDINATOR`` / ``RELAYRL_NUM_PROCESSES`` /
``RELAYRL_PROCESS_ID``, falling back to ``JAX_COORDINATOR_ADDRESS`` etc.,
the JAX package's names) > config ``learner.distributed`` section >
single-process no-op.

The backend rule: ``nccl`` when every rank computes on a card of its own,
``gloo`` on the CPU or when ranks share a card (NCCL refuses two ranks on
one device). A rank's compute device is its first local device:
``local_device_ids`` names this rank's cards, else every visible card is
local, as in the JAX package; a card named twice gives the rank two mesh
entries on it (``[0, 0]``: two shards of an sp ring on one card). The
ranks tell each other their device (the card's UUID, which
``CUDA_VISIBLE_DEVICES`` does not rename) through the store before the
group forms, so every rank picks the same backend.
Under ``nccl`` the host-side traffic (the server's control descriptor and
its batches) rides a second, ``gloo`` group; under ``gloo`` one group
carries both. Gloo carries CUDA tensors for ``broadcast`` and
``all_reduce`` only: the ring's send/receive pairs and gathers, and the
split parameters' gathers and reduce-scatters, stage CUDA tensors through
host memory under gloo and go card to card under nccl
(:func:`stages_through_host`).
"""

from __future__ import annotations

import datetime
import os
import socket
import time
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
        # The groups meshes formed, by their ranks (form_axis_groups).
        self.groups: dict[tuple[int, ...], Any] = {}


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
    """This rank's devices: ``local_device_ids`` names cards by index (a
    card named twice holds two of the rank's mesh entries) or devices by
    name (``"cpu"``), else every visible card."""
    if local_device_ids is not None:
        return [torch.device(i) if isinstance(i, str) else torch.device("cuda", int(i))
                for i in local_device_ids]
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


# The axes whose lines form process groups when they cross, then the
# data plane (dp x fsdp), in the order every rank forms them.
GROUP_AXES = ("dp", "fsdp", "ep", "tp", "sp", "pp", ("dp", "fsdp"))


def form_axis_groups(mesh) -> None:
    """Form the process groups of ``mesh``'s crossing axes in
    :data:`GROUP_AXES` order, each axis's groups in sorted order: every
    rank calls ``new_group`` for every group, its own or not, in the same
    order (the collective contract of ``new_group``), so every rank must
    build the same meshes in the same order. A group of every rank is the
    world group, a group of one rank needs none, and a group formed
    before (by this mesh's other axes or an earlier mesh) is kept. No-op
    without a process group (a topology stubbed in tests)."""
    if _runtime is None:
        return
    import torch.distributed as dist

    for axis in GROUP_AXES:
        for ranks in mesh.axis_groups(axis):
            if ranks in _runtime.groups or len(ranks) == 1:
                continue
            _runtime.groups[ranks] = (
                dist.group.WORLD if len(ranks) == _runtime.world
                else dist.new_group(list(ranks),
                                    timeout=datetime.timedelta(seconds=TIMEOUT_S)))


def axis_group(mesh, axis):
    """This process's group over ``axis`` of ``mesh`` (a name, or a tuple
    of names for their plane; formed by :func:`form_axis_groups`), None
    when the axis stays in this process."""
    ranks = mesh.axis_ranks(axis)
    if len(ranks) == 1:
        return None
    if _runtime is not None and len(ranks) == _runtime.world:
        import torch.distributed as dist

        return dist.group.WORLD
    if _runtime is None or ranks not in _runtime.groups:
        raise RuntimeError(f"no process group for ranks {ranks} over {axis}: "
                           "make_mesh forms them once the process group exists")
    return _runtime.groups[ranks]


def stages_through_host(device: torch.device) -> bool:
    """Whether a send/receive, gather or reduce-scatter of tensors on
    ``device`` goes through host memory: CUDA tensors under gloo (which
    carries them for ``broadcast`` and ``all_reduce`` only); never under
    nccl, nor for CPU tensors."""
    return device.type == "cuda" and backend() == "gloo"


class SplitComm:
    """What the split parameters' collectives moved in this process:
    gathers (a parameter's shards joined whole, or a pipeline stage's
    parameters broadcast from their owner), reduce-scatters
    (the gradient of the whole summed back onto the shards) and the
    all-reduces of the regions split over ep or tp (:mod:`relayrl_tpu_torch.
    parallel.context`); counts, bytes this process received or summed,
    and seconds on the host clock (a gloo stage's copy to the host waits
    for the device)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.gathers = self.gather_bytes = 0
        self.scatters = self.scatter_bytes = 0
        self.reduces = self.reduce_bytes = 0
        self.gather_seconds = self.scatter_seconds = self.reduce_seconds = 0.0

    def as_dict(self) -> dict:
        return dict(vars(self))


COMM = SplitComm()


class AxisGroup:
    """The processes along a mesh axis (or a plane of axes) and the
    collectives over them: ``rank`` is this process's index among them in
    coordinate order, ``size`` their count, ``group`` their process group.
    Every collective raises on failure (a timeout after
    :data:`TIMEOUT_S`); none falls back to a local result."""

    def __init__(self, rank: int, size: int, group, ranks):
        self.rank, self.size, self.group = rank, size, group
        # The members' global ranks in group order.
        self.ranks = tuple(ranks)

    def __deepcopy__(self, memo):
        # A process group is the process's own: a copied module shares it.
        return self

    def all_reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum ``flat`` over the group, in place; returns it."""
        import torch.distributed as dist

        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        return flat

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every member's ``t`` (same shape and dtype), in group order, on
        ``t``'s device; through host memory where the backend cannot carry
        ``t``'s device."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        device = t.device
        buf = t.detach().contiguous()
        if stages_through_host(device):
            buf = buf.cpu()
        out = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(out, buf, group=self.group)
        out = [o.to(device) for o in out]
        COMM.gathers += 1
        COMM.gather_bytes += buf.numel() * buf.element_size() * self.size
        COMM.gather_seconds += time.perf_counter() - t0
        return out

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Member ``src``'s ``t`` on every member (the others pass a
        tensor of its shape and dtype), a new tensor on ``t``'s device;
        staged through host memory where gloo cannot carry ``t``'s device
        and through this process's card where nccl cannot."""
        import torch.distributed as dist

        device = t.device
        buf = t.detach().contiguous().clone()
        if stages_through_host(device):
            buf = buf.cpu()
        elif backend() == "nccl" and device.type != "cuda":
            buf = buf.to(torch.device("cuda", torch.cuda.current_device()))
        dist.broadcast(buf, src=self.ranks[src], group=self.group)
        return buf.to(device)

    def broadcast_object(self, obj, src: int):
        """Member ``src``'s ``obj`` (anything ``torch.save`` writes,
        tensors on the CPU) on every member; the others pass None. Two
        broadcasts: the length, then the bytes."""
        import io

        if self.rank == src:
            stream = io.BytesIO()
            torch.save(obj, stream)
            data = torch.frombuffer(bytearray(stream.getvalue()), dtype=torch.uint8)
        else:
            data = torch.zeros(0, dtype=torch.uint8)
        n = self.broadcast(torch.tensor([data.numel()], dtype=torch.int64), src)
        if self.rank != src:
            data = torch.empty(int(n[0]), dtype=torch.uint8)
        data = self.broadcast(data, src)
        return torch.load(io.BytesIO(data.numpy().tobytes()), weights_only=False)

    def reduce_scatter(self, chunks) -> torch.Tensor:
        """``chunks[i]`` summed over the members, to member ``i``: this
        member's sum, on the chunks' device, in their dtype (summed in
        f32 when narrower). Under gloo, an all-reduce of the whole
        followed by this member's slice (gloo has no reduce-scatter to
        rely on); under nccl, ``reduce_scatter_tensor``."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        device, dtype = chunks[0].device, chunks[0].dtype
        wide = torch.float32 if dtype.itemsize < 4 else dtype
        flat = torch.cat([c.reshape(-1).to(wide) for c in chunks])
        n = chunks[self.rank].numel()
        if backend() == "nccl":
            out = torch.empty(n, dtype=wide, device=device)
            dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM, group=self.group)
        else:
            if stages_through_host(device):
                flat = flat.cpu()
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            out = flat[self.rank * n:(self.rank + 1) * n].to(device)
        COMM.scatters += 1
        COMM.scatter_bytes += flat.numel() * flat.element_size()
        COMM.scatter_seconds += time.perf_counter() - t0
        return out.reshape(chunks[self.rank].shape).to(dtype)


class DataParallelGroup(AxisGroup):
    """The processes a batch splits over (its ``dp`` and ``fsdp``
    coordinates) and the sums the learner takes over them
    (:mod:`relayrl_tpu_torch.parallel.context`): ``rank`` is this
    process's block of the batch, ``size`` the number of blocks. ``dp``
    is the group over the dp axis alone (None when dp does not cross):
    the sum of a gradient whose fsdp gather summed it over fsdp already."""

    dp: "DataParallelGroup | None" = None


def axis_comm(mesh, axis, cls=AxisGroup) -> AxisGroup | None:
    """This process's :class:`AxisGroup` (or ``cls``) over ``axis`` of
    ``mesh`` (a name or a tuple of names), None when the axis stays in
    this process."""
    ranks = mesh.axis_ranks(axis)
    if len(ranks) == 1:
        return None
    if _runtime is None:
        raise RuntimeError("initialize_distributed has not started a "
                           "multi-process group")
    return cls(ranks.index(_runtime.rank), len(ranks), axis_group(mesh, axis), ranks)


def data_parallel_group(mesh) -> DataParallelGroup | None:
    """The group the learner's gradients and batch statistics are summed
    over: the processes that differ from this one only in their dp or
    fsdp coordinate of ``mesh`` (both consume batch). None when neither
    crosses processes (e.g. ``{"dp": 1, "sp": 8}`` or ``{"dp": 1, "ep":
    2}``: every rank holds every row and the same gradients, with no
    sum)."""
    if _runtime is None:
        raise RuntimeError("initialize_distributed has not started a "
                           "multi-process group")
    group = axis_comm(mesh, ("dp", "fsdp"), DataParallelGroup)
    if group is not None and "fsdp" in mesh.cross_axes:
        group.dp = axis_comm(mesh, "dp", DataParallelGroup)
    return group
