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
times as many. ``dp`` is the outermost axis and its coordinates go to the
processes in contiguous blocks; every other axis stays inside one process
(``{"dp": -1, "fsdp": 2}`` over 2 processes of 4 devices: dp 4, each
process 2 dp coordinates x fsdp 2). :attr:`Mesh.local` is this process's
sub-mesh, which the learner drives single-controller; the entries of the
other processes' blocks are None here. A spec whose non-dp axes would
cross processes raises :class:`CrossProcessAxisError`: the multi-process
ring and pipeline are ROADMAP.md queue 1 item 11's next slices.

Config form (``learner.mesh``): ``{"dp": -1, "fsdp": 1, "ep": 1, "tp": 1,
"sp": 1, "pp": 1}`` where -1 means "fill with the remaining devices".
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

AXES = ("dp", "fsdp", "ep", "tp", "sp", "pp")


class CrossProcessAxisError(ValueError):
    """A mesh axis other than ``dp`` would cross processes: the
    multi-process ring and pipeline are not ported (ROADMAP.md queue 1
    item 11)."""


class Mesh:
    """Torch devices on a grid named by :data:`AXES`.

    ``shape`` maps each axis to its size, in axis order, as a JAX mesh's
    ``shape`` does; ``devices`` is the object array of ``torch.device``
    with one dimension per axis. A mesh over ``process_count`` processes
    holds this process's devices in its block of dp coordinates
    (``process_index``) and None elsewhere."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray, process_count: int = 1,
                 process_index: int = 0):
        if devices.ndim != len(AXES):
            raise ValueError(f"device array of rank {devices.ndim} for axes {AXES}")
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))
        self.process_count, self.process_index = process_count, process_index

    @property
    def local(self) -> "Mesh":
        """This process's sub-mesh: its block of dp coordinates, every
        other axis whole (the mesh itself for one process)."""
        if self.process_count == 1:
            return self
        per = self.shape["dp"] // self.process_count
        start = self.process_index * per
        return Mesh(self.devices[start:start + per])

    @property
    def first_device(self) -> torch.device:
        """Where single-controller state lives (:mod:`.learner`): this
        process's first device."""
        return self.local.devices.flat[0]

    def axis_devices(self, axis: str, **coords: int) -> list[torch.device]:
        """The devices along ``axis`` for one group of the other axes: each
        other axis at its coordinate in ``coords``, 0 where none is given
        (an axis the caller does not split over holds replicas)."""
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
    devices) and the mesh spans every process along ``dp``."""
    from relayrl_tpu_torch.parallel import distributed

    if devices is None:
        devices = distributed.local_devices() or _all_devices()
    devices = [torch.device(d) for d in devices]
    world, rank = distributed.process_count(), distributed.process_index()
    shape = resolve_mesh_shape(spec or {"dp": -1}, world * len(devices))
    if shape["dp"] % world:
        inner = {ax: n for ax, n in shape.items() if ax != "dp" and n > 1}
        raise CrossProcessAxisError(
            f"mesh {shape} over {world} processes of {len(devices)} devices: "
            f"dp {shape['dp']} does not split into {world} blocks, so axes "
            f"{sorted(inner)} would cross processes; only dp spans processes "
            "(the multi-process ring and pipeline are ROADMAP.md queue 1 "
            "item 11)")
    arr = np.empty(world * len(devices), dtype=object)
    arr[rank * len(devices):(rank + 1) * len(devices)] = devices
    return Mesh(arr.reshape([shape[ax] for ax in AXES]), world, rank)


def single_device_mesh(device=None) -> Mesh:
    """A mesh of one device of this process: ``device``, else the first
    CUDA device."""
    arr = np.empty(1, dtype=object)
    arr[0] = torch.device(device) if device is not None else _all_devices()[0]
    return Mesh(arr.reshape((1,) * len(AXES)))


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes the batch dimension shards over (dp and fsdp both consume batch)."""
    return tuple(ax for ax in ("dp", "fsdp") if mesh.shape[ax] > 1)
