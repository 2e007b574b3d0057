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
(:mod:`relayrl_tpu_torch.parallel.pipeline`). A crossing pp axis composes
with a crossing fsdp, ep, tp or sp axis: ``{"dp": 1, "fsdp": 2, "pp": 2}``
over 4 processes of 1 gives the pp groups (0, 1) and (2, 3), one per fsdp
coordinate, and the fsdp groups (0, 2) and (1, 3), one per pp coordinate;
each rank holds one stage and half of every split parameter outside the
stack, its pipeline hops within its pp group and its gathers within its
fsdp group.

A process's block need not be a sub-grid of the mesh: ``{"dp": 3, "sp":
2}`` over 2 processes of 3 gives rank 0 dp 0 whole and sp 0 of dp 1, rank
1 sp 1 of dp 1 and dp 2 whole, so the two ranks hold different lines of
the sp axis (:attr:`Mesh.straddles`). A rank then holds exactly the cells
that :attr:`Mesh.owners` gives it, line by line (:meth:`Mesh.lines`, a
per-line :meth:`Mesh.shard_indices` and :meth:`Mesh.axis_ranks`), and
keeps the rows of every data cell it touches (:attr:`Mesh.cells`), which
can be another rank's too. Its data group is then every rank
(:attr:`Mesh.data_ranks`): each data cell's rows count once, for its
lowest holder (:attr:`Mesh.accountable_cells`), and every other holder
computes them with their ``valid`` mask zeroed (:func:`~relayrl_tpu_torch.
parallel.learner.place_batch`). A ring runs one span per data cell,
hopping on the lines that cross, and a minibatch's rows go to their
cells' spans (:func:`~relayrl_tpu_torch.parallel.ring.over_spans`). Two
layouts stay refused (:class:`CrossProcessAxisError`, ROADMAP.md queue
1): a straddled pipeline axis, and a split parameter that a rank would
hold only in part while its entries straddle the split axis's lines
(``{"dp": 1, "fsdp": 2, "tp": 3}`` over 3 processes of 2 builds, and
placing a model with a leaf split over fsdp or tp raises on every rank;
:mod:`~relayrl_tpu_torch.parallel.sharding`).

Config form (``learner.mesh``): ``{"dp": -1, "fsdp": 1, "ep": 1, "tp": 1,
"sp": 1, "pp": 1}`` where -1 means "fill with the remaining devices".
"""

from __future__ import annotations

import itertools
from typing import Mapping, Sequence

import numpy as np
import torch

AXES = ("dp", "fsdp", "ep", "tp", "sp", "pp")


# The axes whose coordinates may go to different processes.
CROSS_PROCESS_AXES = ("dp", "fsdp", "ep", "tp", "sp", "pp")


class CrossProcessAxisError(ValueError):
    """A process's block of devices straddles the lines of a pipeline
    axis that crosses processes, or would hold a split parameter in part
    across such lines (ROADMAP.md queue 1)."""


class Mesh:
    """Torch devices on a grid named by :data:`AXES`.

    ``shape`` maps each axis to its size, in axis order, as a JAX mesh's
    ``shape`` does; ``devices`` is the object array of ``torch.device``
    with one dimension per axis. A mesh over ``process_count`` processes
    holds this process's (``process_index``) devices where ``owners``, the
    int array of each coordinate's rank, says it owns them, and None
    elsewhere; ``straddles`` says that some process's block is not a
    sub-grid (the module docstring)."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray, process_count: int = 1,
                 process_index: int = 0, owners: np.ndarray | None = None,
                 straddles: bool = False):
        if devices.ndim != len(AXES):
            raise ValueError(f"device array of rank {devices.ndim} for axes {AXES}")
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))
        self.process_count, self.process_index = process_count, process_index
        self.owners = (np.full(devices.shape, process_index) if owners is None
                       else owners)
        self.straddles = straddles
        # The mesh this one is a process's sub-mesh of (:attr:`local`).
        self.parent = self

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

    def _line_index(self, axis, line: tuple | None = None) -> tuple:
        """The index of one line along ``axis`` (a name or a tuple of
        names): ``line`` (a :meth:`lines` entry), else the line through
        :attr:`home`."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        base = self.home if line is None else line
        return tuple(slice(None) if ax in axes else int(c) for ax, c in zip(AXES, base))

    def lines(self, axis) -> list[tuple]:
        """The lines along ``axis`` (a name or a tuple of names) on which
        this process holds an entry, in row-major order: each a tuple over
        :data:`AXES`, None at ``axis`` and the other axes' coordinates
        elsewhere. One line for a process whose block is a sub-grid that
        ``axis`` does not leave; several where its block straddles the
        axis's lines."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        others = [ax for ax in AXES if ax not in axes]
        out = []
        for coord in itertools.product(*(range(self.shape[ax]) for ax in others)):
            at = dict(zip(others, coord))
            line = tuple(None if ax in axes else at[ax] for ax in AXES)
            if (self.owners[self._line_index(axes, line)] == self.process_index).any():
                out.append(line)
        return out

    def axis_owners(self, axis: str, line: tuple | None = None) -> np.ndarray:
        """The owning rank of each coordinate along ``axis`` on ``line``
        (a :meth:`lines` entry; default: through :attr:`home`)."""
        return self.owners[self._line_index(axis, line)]

    def _plane(self, axes) -> np.ndarray:
        """Owners with ``axes`` (a name or a tuple of names) last,
        flattened there in their order: one row per line of the other
        axes' coordinates."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        moved = np.moveaxis(self.owners, [AXES.index(a) for a in axes],
                            range(-len(axes), 0))
        return moved.reshape(-1, int(np.prod([self.shape[a] for a in axes])))

    def axis_ranks(self, axis, line: tuple | None = None) -> tuple[int, ...]:
        """The ranks along ``axis`` (a name, or a tuple of names for their
        plane) on ``line`` (a :meth:`lines` entry; default: through this
        process's home coordinates), in coordinate order: the processes
        of its group over that axis (its dp group differs only in the dp
        coordinate; its sp group holds one ring; its ``("dp", "fsdp")``
        group shares every coordinate but those two)."""
        index = self._line_index(axis, line)
        return tuple(dict.fromkeys(int(r) for r in self.owners[index].reshape(-1)))

    def axis_groups(self, axis) -> list[tuple[int, ...]]:
        """Every group of ranks along ``axis`` (a name or a tuple of
        names; one group per line of the other axes' coordinates), sorted:
        what every rank forms, in this order, whatever its own group."""
        return sorted({tuple(dict.fromkeys(int(r) for r in line))
                       for line in self._plane(axis)})

    def shard_indices(self, axis: str, line: tuple | None = None) -> list[int]:
        """This process's coordinates along ``axis`` on ``line`` (a
        :meth:`lines` entry; default: through :attr:`home`): its global
        shard indices of that ``sp`` ring; all of them where the line
        stays in the process."""
        return [i for i, r in enumerate(self.axis_owners(axis, line))
                if r == self.process_index]

    @property
    def dp_block(self) -> tuple[int, int]:
        """This process's dp coordinates, ``[start, stop)``."""
        rows = self.owners.reshape(self.shape["dp"], -1)
        mine = np.flatnonzero((rows == self.process_index).any(axis=1))
        return int(mine[0]), int(mine[-1]) + 1

    def _cells(self) -> np.ndarray:
        return self.owners.reshape(self.shape["dp"] * self.shape["fsdp"], -1)

    @property
    def cells(self) -> list[int]:
        """The cells of the ``(dp, fsdp)`` plane (flat, dp outermost) at
        which this process holds an entry: the batch's blocks whose rows
        it computes, contiguous (a process's entries are)."""
        return [int(c) for c in np.flatnonzero((self._cells() == self.process_index)
                                               .any(axis=1))]

    @property
    def data_ranks(self) -> tuple[int, ...]:
        """The ranks of this process's data group, which sum its gradients
        and statistics: those along the ``(dp, fsdp)`` plane through its
        home coordinates, every rank where process blocks straddle the
        mesh's lines (a rank's cells then lie on several of the plane's
        lines)."""
        if self.straddles:
            return tuple(range(self.process_count))
        return self.axis_ranks(("dp", "fsdp"))

    @property
    def accountable_cells(self) -> list[int]:
        """Of :attr:`cells`, those whose rows count for this process: the
        cells whose lowest holder among :attr:`data_ranks` it is. In a
        sub-grid block that is every cell (each cell of its data group's
        plane has one holder there); where blocks straddle lines, a cell
        two processes share counts on the lower one."""
        ranks = set(self.data_ranks)
        return [c for c in self.cells
                if min(int(r) for r in self._cells()[c] if int(r) in ranks)
                == self.process_index]

    @property
    def data_block(self) -> tuple[int, int]:
        """This process's :attr:`cells`, ``[start, stop)``: what it keeps
        of a batch split over dp x fsdp."""
        cells = self.cells
        return cells[0], cells[-1] + 1

    @property
    def local(self) -> "Mesh":
        """This process's sub-mesh: its block of dp coordinates, every
        other axis whole (the mesh itself for one process). Where only dp
        crosses, a single-process mesh of this process's devices; where
        another axis crosses too, or the block straddles lines, the other
        ranks' entries stay, None, with their owners."""
        if self.process_count == 1:
            return self
        start, stop = self.dp_block
        owners = self.owners[start:stop]
        if (owners == self.process_index).all():
            return Mesh(self.devices[start:stop])
        local = Mesh(self.devices[start:stop], self.process_count,
                     self.process_index, owners, self.straddles)
        local.parent = self
        return local

    @property
    def first_device(self) -> torch.device:
        """Where single-controller state lives (:mod:`.learner`): this
        process's first device."""
        local = self.local
        return local.devices[local.home]

    def device_at(self, **coords: int) -> torch.device | None:
        """This process's device at ``coords``, every other axis at
        :attr:`home`'s coordinate; where that entry is another rank's, the
        first entry (row-major) at ``coords`` that this process holds.
        None when it holds none."""
        index = tuple(coords.get(ax, h) for ax, h in zip(AXES, self.home))
        if self.devices[index] is not None:
            return self.devices[index]
        at = tuple(coords[ax] if ax in coords else slice(None) for ax in AXES)
        held = np.flatnonzero((self.owners[at] == self.process_index).reshape(-1))
        return self.devices[at].reshape(-1)[held[0]] if held.size else None

    def axis_devices(self, axis: str, line: tuple | None = None,
                     **coords: int) -> list[torch.device]:
        """The devices along ``axis`` for one group of the other axes: on
        ``line`` (a :meth:`lines` entry), else each other axis at its
        coordinate in ``coords``, at :attr:`home`'s where none is given (0
        in a single process: an axis the caller does not split over holds
        replicas; across processes this process's own line, whose owners
        :meth:`axis_owners` gives). Another rank's entry is None."""
        unknown = set(coords) - set(self.axis_names) | ({axis} & set(coords))
        if unknown:
            raise ValueError(f"bad coordinates {sorted(unknown)} for axis {axis!r}")
        if line is not None:
            return list(self.devices[self._line_index(axis, line)])
        index = tuple(slice(None) if ax == axis else coords.get(ax, h)
                      for ax, h in zip(self.axis_names, self.home))
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
    straddles = world > 1 and not _is_sub_grid(dims, n)
    mesh = Mesh(arr.reshape(dims), world, rank, owners, straddles)
    if straddles and "pp" in mesh.cross_axes:
        raise CrossProcessAxisError(
            f"mesh {shape} over {world} processes of {n} devices: a process's "
            f"block of {n} devices straddles the lines of the pipeline axis, "
            "which crosses processes (only a sub-grid block may hold part of a "
            "pipeline; ROADMAP.md queue 1)")
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
