"""Ambient mesh and data-parallel process group.

Counterpart of :mod:`relayrl_tpu.parallel.context`. Model arch configs are
JSON-able data (the transportable model ABI — models/base.py), so they
cannot carry a live :class:`~relayrl_tpu_torch.parallel.mesh.Mesh`.
Components that need one when they run (ring attention in the transformer
policy) read it from this context, which the learner sets around each
update::

    with use_mesh(mesh):
        state, metrics = update(state, batch)

Single-device paths (actors) simply never set a mesh and the sequence
models fall back to their local attention implementation.

Beside the mesh, a learner whose ``dp`` axis spans processes installs the
data-parallel group (:func:`use_dp_group`,
:class:`~relayrl_tpu_torch.parallel.distributed.DataParallelGroup`). Each
process then holds only its rows of the batch, and what GSPMD computes
over the global batch in the JAX package the updates compute through the
helpers below: sums of statistics (:func:`dp_sum`, with shares of means
from :func:`dp_mean`), every gradient before its optimizer step
(:func:`dp_gradients`), the global row count (:func:`dp_global_rows`),
this process's rows of a whole-batch draw (:func:`dp_rows`). Without a
group each is the identity, so one update serves one process and many.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from relayrl_tpu_torch.parallel.mesh import Mesh

_state = threading.local()


def current_mesh() -> Mesh | None:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def current_dp_group():
    """The data-parallel process group of the running update, or None."""
    return getattr(_state, "dp_group", None)


@contextlib.contextmanager
def use_dp_group(group):
    prev = current_dp_group()
    _state.dp_group = group
    try:
        yield group
    finally:
        _state.dp_group = prev


def dp_size() -> int:
    group = current_dp_group()
    return 1 if group is None else group.size


def dp_sum(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each tensor summed over the data-parallel group (one collective for
    all of them); the tensors themselves without a group. Use it on
    partial statistics: a process's sum over its rows, or its share of a
    global mean (its sum over the global count)."""
    group = current_dp_group()
    if group is None:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    group.all_reduce(flat)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].reshape(t.shape).to(t.dtype))
        offset += t.numel()
    return tuple(out)


def dp_mean(x: torch.Tensor) -> torch.Tensor:
    """This process's share of the global batch's mean of ``x`` (its rows'
    mean over the group's size; ``x.mean()`` without a group): summed over
    the group (:func:`dp_sum`, or through :func:`dp_gradients`) it is the
    mean over every process's rows."""
    group = current_dp_group()
    return x.mean() if group is None else x.mean() / group.size


def dp_gradients(loss: torch.Tensor | None, params: list) -> list[torch.Tensor]:
    """The gradients of ``loss`` over ``params``, summed over the
    data-parallel group: the one place every optimizer step of every
    family takes its gradients. A parameter the loss does not reach takes
    a zero gradient, as in optax; ``loss=None`` (a process with no rows in
    a minibatch) contributes zeros, so every process joins the sum. Each
    process's loss is its rows' sum over the global count, so the sums are
    the single-process gradients."""
    if loss is None:
        grads = [None] * len(params)
    else:
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    group = current_dp_group()
    if group is None or not grads:
        return grads
    flat = group.all_reduce(torch.cat([g.reshape(-1).float() for g in grads]))
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].reshape(g.shape).to(g.dtype))
        offset += g.numel()
    return out


def dp_global_rows(local_rows: int) -> int:
    """The global batch's rows, from this process's (the batch splits
    evenly over the group)."""
    return local_rows * dp_size()


def dp_row_range(global_rows: int) -> tuple[int, int]:
    """This process's rows of a global batch: ``[start, stop)``, its
    contiguous block (dp coordinates go to processes in blocks)."""
    group = current_dp_group()
    if group is None:
        return 0, global_rows
    per = global_rows // group.size
    return group.rank * per, (group.rank + 1) * per


def dp_rows(x: torch.Tensor) -> torch.Tensor:
    """This process's rows (dim 0) of a tensor drawn for the whole batch:
    every process draws the global batch's noise from the same generator
    state and keeps its rows, so its slice equals the single-process
    draw's."""
    start, stop = dp_row_range(x.shape[0])
    return x[start:stop]
