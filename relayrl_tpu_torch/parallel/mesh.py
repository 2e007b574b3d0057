"""Device-mesh construction.

Counterpart of :mod:`relayrl_tpu.parallel.mesh`, with the same axis
convention (order matters: it is the order of the device array's axes):

* ``dp``   — data parallel (batch split)
* ``fsdp`` — fully-sharded data parallel (params sharded, batch also split)
* ``ep``   — expert parallel
* ``tp``   — tensor parallel
* ``sp``   — sequence/context parallel (trajectory time axis, ring
             attention — :mod:`relayrl_tpu_torch.parallel.ring_flash`)
* ``pp``   — pipeline parallel

Inside one process the port is single-controller, as the JAX package
is: the process holds the whole :class:`Mesh` and drives every shard.
``devices`` may name one device more than once, the counterpart of
``--xla_force_host_platform_device_count``: ``[torch.device("cpu")] * 8``
gives the CPU tests an 8-device mesh, ``[cuda:0] * 4`` puts a 4-shard
``sp`` ring on one card.

Once :func:`~relayrl_tpu_torch.parallel.distributed.initialize_distributed`
has started several processes, a mesh spans them, as a JAX mesh over
``jax.devices()`` spans every host: ``devices`` (default: this rank's
local devices) are this process's, and the mesh holds ``num_processes``
times as many. Process ``p`` owns the flat indices ``[p·L, (p+1)·L)`` of
the device array (L devices a process), the layout of the reference's
reshape of ``jax.devices()``; :attr:`Mesh.owners` holds each coordinate's
rank. ``dp`` and ``sp`` may cross processes: ``{"dp": -1, "fsdp": 2}``
over 2 processes of 4 devices gives dp 4, each process 2 dp coordinates x
fsdp 2; ``{"dp": 1, "sp": 8}`` over 2 processes of 4 gives one ring whose
shards 0-3 sit on rank 0 and 4-7 on rank 1. :attr:`Mesh.local` is this
process's sub-mesh, its block of dp coordinates, which the learner drives
single-controller; when ``sp`` crosses it keeps the whole ``sp`` axis with
the other ranks' entries None (their owners still known), so the ring
sees every shard and hops to the ranks that hold the others
(:mod:`relayrl_tpu_torch.parallel.ring`). A spec in which fsdp, ep, tp or
pp would cross processes raises :class:`CrossProcessAxisError`: they are
ROADMAP.md queue 1 item 11's next slices.

Config form (``learner.mesh``): ``{"dp": -1, "fsdp": 1, "ep": 1, "tp": 1,
"sp": 1, "pp": 1}`` where -1 means "fill with the remaining devices".
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

AXES = ("dp", "fsdp", "ep", "tp", "sp", "pp")


# The axes whose coordinates may go to different processes.
CROSS_PROCESS_AXES = ("dp", "sp")


class CrossProcessAxisError(ValueError):
    """A mesh axis other than ``dp`` and ``sp`` would cross processes:
    fsdp, ep, tp and pp across processes are not ported (ROADMAP.md queue
    1 item 11)."""


class Mesh:
    """Torch devices on a grid named by :data:`AXES`.

    ``shape`` maps each axis to its size, in axis order, as a JAX mesh's
    ``shape`` does; ``devices`` is the object array of ``torch.device``
    with one dimension per axis. A mesh over ``process_count`` processes
    holds this process's (``process_index``) devices where ``owners``, the
    int array of each coordinate's rank, says it owns them, and None
    elsewhere."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray, process_count: int = 1,
                 process_index: int = 0, owners: np.ndarray | None = None):
        if devices.ndim != len(AXES):
            raise ValueError(f"device array of rank {devices.ndim} for axes {AXES}")
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))
        self.process_count, self.process_index = process_count, process_index
        self.owners = (np.full(devices.shape, process_index) if owners is None
                       else owners)

    def owner(self, **coords: int) -> int:
        """The rank that owns the coordinate (an axis not given at 0)."""
        return int(self.owners[tuple(coords.get(ax, 0) for ax in AXES)])

    @property
    def cross_axes(self) -> tuple[str, ...]:
        """The axes along which the owning rank changes."""
        return tuple(ax for i, ax in enumerate(AXES)
                     if (np.diff(self.owners, axis=i) != 0).any())

    @property
    def home(self) -> tuple[int, ...]:
        """This process's first coordinate (row-major)."""
        return tuple(int(i) for i in np.unravel_index(
            int(np.argmax(self.owners == self.process_index)), self.owners.shape))

    def axis_owners(self, axis: str) -> np.ndarray:
        """The owning rank of each coordinate along ``axis`` through
        :attr:`home`."""
        index = list(self.home)
        index[AXES.index(axis)] = slice(None)
        return self.owners[tuple(index)]

    def axis_ranks(self, axis: str) -> tuple[int, ...]:
        """The ranks along ``axis`` through this process's coordinates, in
        coordinate order: the processes of its group over that axis (its
        dp group differs only in the dp coordinate; its sp group holds one
        ring)."""
        return tuple(dict.fromkeys(int(r) for r in self.axis_owners(axis)))

    def axis_groups(self, axis: str) -> list[tuple[int, ...]]:
        """Every group of ranks along ``axis`` (one per line of the other
        axes' coordinates), sorted: what every rank forms, in this order,
        whatever its own group."""
        lines = np.moveaxis(self.owners, AXES.index(axis), -1)
        lines = lines.reshape(-1, self.shape[axis])
        return sorted({tuple(dict.fromkeys(int(r) for r in line)) for line in lines})

    def shard_indices(self, axis: str) -> list[int]:
        """This process's coordinates along ``axis`` through :attr:`home`
        (its global shard indices of the ``sp`` ring)."""
        return [i for i, r in enumerate(self.axis_owners(axis)) if r == self.process_index]

    @property
    def dp_block(self) -> tuple[int, int]:
        """This process's dp coordinates, ``[start, stop)``."""
        rows = self.owners.reshape(self.shape["dp"], -1)
        mine = np.flatnonzero((rows == self.process_index).any(axis=1))
        return int(mine[0]), int(mine[-1]) + 1

    @property
    def local(self) -> "Mesh":
        """This process's sub-mesh: its block of dp coordinates, every
        other axis whole (the mesh itself for one process). Where only dp
        crosses, a single-process mesh of this process's devices; where
        sp crosses too, the other ranks' sp entries stay, None, with their
        owners."""
        if self.process_count == 1:
            return self
        start, stop = self.dp_block
        owners = self.owners[start:stop]
        if (owners == self.process_index).all():
            return Mesh(self.devices[start:stop])
        return Mesh(self.devices[start:stop], self.process_count,
                    self.process_index, owners)

    @property
    def first_device(self) -> torch.device:
        """Where single-controller state lives (:mod:`.learner`): this
        process's first device."""
        local = self.local
        return local.devices[local.home]

    def axis_devices(self, axis: str, **coords: int) -> list[torch.device]:
        """The devices along ``axis`` for one group of the other axes: each
        other axis at its coordinate in ``coords``, 0 where none is given
        (an axis the caller does not split over holds replicas). Another
        rank's entry is None."""
        unknown = set(coords) - set(self.axis_names) | ({axis} & set(coords))
        if unknown:
            raise ValueError(f"bad coordinates {sorted(unknown)} for axis {axis!r}")
        index = tuple(slice(None) if ax == axis else coords.get(ax, 0)
                      for ax in self.axis_names)
        return list(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def resolve_mesh_shape(spec: Mapping[str, int], n_devices: int) -> dict[str, int]:
    """Resolve a mesh spec against a device count (one -1 axis fills)."""
    shape = {ax: int(spec.get(ax, 1)) for ax in AXES}
    fill_axes = [ax for ax, v in shape.items() if v == -1]
    if len(fill_axes) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {fill_axes}")
    fixed = 1
    for ax, v in shape.items():
        if v != -1:
            if v <= 0:
                raise ValueError(f"mesh axis {ax} must be positive or -1, got {v}")
            fixed *= v
    if fill_axes:
        if n_devices % fixed != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes product {fixed}")
        shape[fill_axes[0]] = n_devices // fixed
    else:
        if fixed != n_devices:
            raise ValueError(
                f"mesh {shape} needs {fixed} devices but {n_devices} available")
    return shape


def _all_devices() -> list[torch.device]:
    """Every CUDA device; without one the caller must name devices (the
    port never carries on quietly on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass devices, e.g. "
            "[torch.device('cpu')] * n for a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(spec: Mapping[str, int] | None = None,
              devices: Sequence | None = None) -> Mesh:
    """Build a Mesh over the given (default: every CUDA) devices. A device
    may appear more than once: its shards then share it. In a
    multi-process run ``devices`` are this process's (default: its local
    devices), the mesh spans every process and the process groups of its
    dp and sp axes are formed (every rank calls this with the same spec)."""
    from relayrl_tpu_torch.parallel import distributed

    if devices is None:
        devices = distributed.local_devices() or _all_devices()
    devices = [torch.device(d) for d in devices]
    world, rank = distributed.process_count(), distributed.process_index()
    n = len(devices)
    shape = resolve_mesh_shape(spec or {"dp": -1}, world * n)
    dims = [shape[ax] for ax in AXES]
    owners = (np.arange(world * n) // n).reshape(dims)
    arr = np.empty(world * n, dtype=object)
    arr[rank * n:(rank + 1) * n] = devices
    mesh = Mesh(arr.reshape(dims), world, rank, owners)
    crossing = [ax for ax in mesh.cross_axes if ax not in CROSS_PROCESS_AXES]
    if crossing:
        raise CrossProcessAxisError(
            f"mesh {shape} over {world} processes of {n} devices: axes "
            f"{crossing} would cross processes; only dp and sp span processes "
            "(fsdp, ep, tp and pp across processes are ROADMAP.md queue 1 "
            "item 11)")
    inner = world * n // shape["dp"]
    if inner % n and n % inner:
        raise CrossProcessAxisError(
            f"mesh {shape} over {world} processes of {n} devices: a process's "
            f"block of {n} devices neither holds whole dp rows of {inner} nor "
            "an equal part of one (ROADMAP.md queue 1 item 11)")
    if world > 1:
        distributed.form_axis_groups(mesh)
    return mesh


def single_device_mesh(device=None) -> Mesh:
    """A mesh of one device of this process: ``device``, else the first
    CUDA device."""
    arr = np.empty(1, dtype=object)
    arr[0] = torch.device(device) if device is not None else _all_devices()[0]
    return Mesh(arr.reshape((1,) * len(AXES)))


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes the batch dimension shards over (dp and fsdp both consume batch)."""
    return tuple(ax for ax in ("dp", "fsdp") if mesh.shape[ax] > 1)
