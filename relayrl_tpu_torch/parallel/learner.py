"""Sharded learner-step compilation.

Counterpart of :mod:`relayrl_tpu.parallel.learner`, single-controller and
sequence-parallel only: :func:`make_sharded_update` takes the ``(state,
batch) -> (state, metrics)`` update an algorithm already defines and runs
it over a mesh. The state and the batch live on the mesh's first device.
The batch splits where the mesh's work is: at attention, where a
transformer with ``attention="ring"`` cuts its batch over dp x fsdp and
its time axis over ``sp`` (what the ``shard_map`` in-specs do in JAX). The
layers outside attention run whole on the first device, where GSPMD would
shard them over the mesh; they compute the same function.

Param sharding rules (``parallel/sharding.py``), and with them meshes with
fsdp, tp, ep or pp above 1, come with the multi-GPU slice (ROADMAP queue 1
item 11).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from relayrl_tpu_torch.parallel.context import use_mesh
from relayrl_tpu_torch.parallel.mesh import Mesh, data_axes

_UNSUPPORTED_AXES = ("fsdp", "tp", "ep", "pp")


def _check_mesh(mesh: Mesh) -> None:
    wide = {ax: mesh.shape[ax] for ax in _UNSUPPORTED_AXES if mesh.shape[ax] > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: only dp and sp are ported; the param "
            f"sharding rules for fsdp, tp, ep and pp come with the multi-GPU "
            f"slice (ROADMAP queue 1 item 11)")


def make_sharded_update(update_fn: Callable, mesh: Mesh, state_template,
                        donate_state: bool = True,
                        shard_time: bool = False) -> Callable:
    """Run ``update_fn`` over ``mesh``.

    The returned callable expects state already placed (use
    :func:`place_state` once) and takes a host or device batch dict, which
    it checks against the mesh (:func:`batch_shardings`) and places. The
    mesh is installed as the ambient mesh
    (:mod:`relayrl_tpu_torch.parallel.context`) around each call, so
    ``attention: "ring"`` models pick it up; ``shard_time=True`` also
    holds the time axis of rank>=2 batch arrays to the ``sp`` split.

    ``state_template`` and ``donate_state`` keep the JAX signature: every
    state lives on the first device, so there is no placement to derive,
    and the torch update moves the params in place, so the state is always
    donated."""
    _check_mesh(mesh)

    def sharded_update(state, batch):
        batch = place_batch(batch, mesh, shard_time)
        with use_mesh(mesh):
            return update_fn(state, batch)

    return sharded_update


def batch_shardings(mesh: Mesh, batch: dict, shard_time: bool = False) -> dict:
    """Per-key split of a batch dict, as tuples of mesh axes per leading
    dim (JAX's PartitionSpecs): batch axis over dp x fsdp, plus
    (``shard_time=True``) the time axis of rank>=2 arrays over ``sp``."""
    axes = data_axes(mesh)
    b = axes if axes else None
    time = shard_time and mesh.shape.get("sp", 1) > 1
    return {k: (b, "sp") if time and v.ndim >= 2 else (b,)
            for k, v in batch.items()}


def _check_splits(mesh: Mesh, batch: dict, specs: dict) -> None:
    for key, spec in specs.items():
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            parts = 1
            for ax in (axes,) if isinstance(axes, str) else axes:
                parts *= mesh.shape[ax]
            if batch[key].shape[dim] % parts:
                raise ValueError(
                    f"batch[{key!r}] dim {dim} of size {batch[key].shape[dim]} "
                    f"does not split over mesh axes {axes} ({parts} parts)")


def place_state(state, mesh: Mesh):
    """Move a state's param modules onto the mesh's first device, in place
    (its optimizers keep their parameters; their moments are made at the
    first step, next to the parameters). Returns the state."""
    _check_mesh(mesh)
    for value in vars(state).values():
        if isinstance(value, nn.Module):
            value.to(mesh.first_device)
    return state


def place_batch(batch: dict, mesh: Mesh, shard_time: bool = False) -> dict:
    """Host batch -> tensors on the mesh's first device, after checking
    that each array splits over the mesh as :func:`batch_shardings` says.
    ``shard_time`` must match the :func:`make_sharded_update` flag."""
    _check_splits(mesh, batch, batch_shardings(mesh, batch, shard_time))
    return {k: torch.as_tensor(v, device=mesh.first_device)
            for k, v in batch.items()}
