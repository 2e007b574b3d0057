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
rank. Every axis may cross processes: ``{"dp": -1, "fsdp": 2}`` over 2
processes of 4 devices gives dp 4, each process 2 dp coordinates x fsdp
2; ``{"dp": 1, "sp": 8}`` over 2 processes of 4 gives one ring whose
shards 0-3 sit on rank 0 and 4-7 on rank 1; ``{"dp": 1, "fsdp": 2}`` over
2 processes of 1 puts fsdp 0 on rank 0 and fsdp 1 on rank 1, so each rank
holds half of every split parameter; ``{"dp": 1, "pp": 4}`` over 2
processes of 2 puts pipeline stages 0-1 on rank 0 and 2-3 on rank 1.
:attr:`Mesh.local` is this process's sub-mesh, its block of dp
coordinates, which the learner drives single-controller; an axis other
than dp that crosses stays whole there, the other ranks' entries None
(their owners still known): the ring sees every shard and hops to the
ranks that hold the others (:mod:`relayrl_tpu_torch.parallel.ring`), a
split parameter keeps the shards at this rank's coordinates and gathers
the others' (:mod:`relayrl_tpu_torch.parallel.sharding`), and the
pipeline runs this rank's stages and hops to the ranks of the others
(:mod:`relayrl_tpu_torch.parallel.pipeline`). A crossing pp axis does not
compose with a crossing fsdp, ep, tp or sp axis (their collectives would
interleave with the pipeline's hops): such a spec raises
:class:`CrossProcessAxisError`, ROADMAP.md queue 1 item 11. Every
process's block must be a sub-grid of the mesh (:func:`make_mesh`).

Config form (``learner.mesh``): ``{"dp": -1, "fsdp": 1, "ep": 1, "tp": 1,
"sp": 1, "pp": 1}`` where -1 means "fill with the remaining devices".
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

AXES = ("dp", "fsdp", "ep", "tp", "sp", "pp")


# The axes whose coordinates may go to different processes.
CROSS_PROCESS_AXES = ("dp", "fsdp", "ep", "tp", "sp", "pp")

# The axes a crossing pp axis does not compose with when they cross too.
_NOT_BESIDE_PP = ("fsdp", "ep", "tp", "sp")


class CrossProcessAxisError(ValueError):
    """A process's block of devices is not a sub-grid of the mesh, or
    ``pp`` crosses processes beside a crossing fsdp, ep, tp or sp axis
    (ROADMAP.md queue 1 item 11)."""


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

    def _plane(self, axes) -> np.ndarray:
        """Owners with ``axes`` (a name or a tuple of names) last,
        flattened there in their order: one row per line of the other
        axes' coordinates."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        moved = np.moveaxis(self.owners, [AXES.index(a) for a in axes],
                            range(-len(axes), 0))
        return moved.reshape(-1, int(np.prod([self.shape[a] for a in axes])))

    def axis_ranks(self, axis) -> tuple[int, ...]:
        """The ranks along ``axis`` (a name, or a tuple of names for their
        plane) through this process's coordinates, in coordinate order:
        the processes of its group over that axis (its dp group differs
        only in the dp coordinate; its sp group holds one ring; its
        ``("dp", "fsdp")`` group shares every coordinate but those two)."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        index = tuple(slice(None) if ax in axes else h
                      for ax, h in zip(AXES, self.home))
        return tuple(dict.fromkeys(int(r) for r in self.owners[index].reshape(-1)))

    def axis_groups(self, axis) -> list[tuple[int, ...]]:
        """Every group of ranks along ``axis`` (a name or a tuple of
        names; one group per line of the other axes' coordinates), sorted:
        what every rank forms, in this order, whatever its own group."""
        return sorted({tuple(dict.fromkeys(int(r) for r in line))
                       for line in self._plane(axis)})

    def shard_indices(self, axis: str) -> list[int]:
        """This process's coordinates along ``axis`` through :attr:`home`
        (its global shard indices of the ``sp`` ring; all of them where
        the axis stays in the process)."""
        return [i for i, r in enumerate(self.axis_owners(axis)) if r == self.process_index]

    @property
    def dp_block(self) -> tuple[int, int]:
        """This process's dp coordinates, ``[start, stop)``."""
        rows = self.owners.reshape(self.shape["dp"], -1)
        mine = np.flatnonzero((rows == self.process_index).any(axis=1))
        return int(mine[0]), int(mine[-1]) + 1

    @property
    def data_block(self) -> tuple[int, int]:
        """This process's cells of the ``(dp, fsdp)`` plane, the batch's
        blocks (dp outermost), ``[start, stop)``: what it keeps of a
        batch split over dp x fsdp."""
        cells = self.owners.reshape(self.shape["dp"] * self.shape["fsdp"], -1)
        mine = np.flatnonzero((cells == self.process_index).any(axis=1))
        return int(mine[0]), int(mine[-1]) + 1

    @property
    def local(self) -> "Mesh":
        """This process's sub-mesh: its block of dp coordinates, every
        other axis whole (the mesh itself for one process). Where only dp
        crosses, a single-process mesh of this process's devices; where
        another axis crosses too, the other ranks' entries along it stay,
        None, with their owners."""
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
    crossing axes are formed (every rank calls this with the same spec,
    in the same order as its other meshes: forming a group is
    collective)."""
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
    if not _is_sub_grid(dims, n):
        raise CrossProcessAxisError(
            f"mesh {shape} over {world} processes of {n} devices: a process's "
            f"block of {n} devices is not a sub-grid of the mesh (it must hold "
            "whole trailing axes and an equal part of the next; ROADMAP.md "
            "queue 1 item 11)")
    beside = [ax for ax in mesh.cross_axes if ax in _NOT_BESIDE_PP]
    if "pp" in mesh.cross_axes and beside:
        raise CrossProcessAxisError(
            f"mesh {shape} over {world} processes of {n} devices: pp crosses "
            f"processes beside {beside}; the pipeline across processes runs "
            "beside dp alone (pp with a crossing fsdp, ep, tp or sp is "
            "ROADMAP.md queue 1 item 11)")
    if world > 1:
        distributed.form_axis_groups(mesh)
    return mesh


def _is_sub_grid(dims: Sequence[int], n: int) -> bool:
    """Whether ``n`` consecutive row-major entries of a ``dims`` grid,
    starting at a multiple of ``n``, always form a sub-grid: ``n`` takes
    whole axes from the last one up, then a divisor of the next."""
    for d in reversed(dims):
        if n == 1:
            return True
        if n % d == 0:
            n //= d
        elif d % n == 0:
            return True
        else:
            return False
    return n == 1


def single_device_mesh(device=None) -> Mesh:
    """A mesh of one device of this process: ``device``, else the first
    CUDA device."""
    arr = np.empty(1, dtype=object)
    arr[0] = torch.device(device) if device is not None else _all_devices()[0]
    return Mesh(arr.reshape((1,) * len(AXES)))


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes the batch dimension shards over (dp and fsdp both consume batch)."""
    return tuple(ax for ax in ("dp", "fsdp") if mesh.shape[ax] > 1)


def local_data_groups(mesh: Mesh) -> int:
    """How many batch blocks of ``mesh``'s dp x fsdp split this process
    computes: every one on a single-process mesh, its own where dp or
    fsdp crosses processes (a layer that splits its rows by data group
    splits this process's rows into these)."""
    return int(np.prod([len(mesh.shard_indices(ax)) for ax in data_axes(mesh)]))
