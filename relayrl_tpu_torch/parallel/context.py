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

Beside the mesh, a learner whose ``dp`` or ``fsdp`` axis spans processes
installs the data-parallel group (:func:`use_dp_group`,
:class:`~relayrl_tpu_torch.parallel.distributed.DataParallelGroup`: the
processes that differ in their dp or fsdp coordinate). Each process then
holds only its rows of the batch, and what GSPMD computes over the global
batch in the JAX package the updates compute through the helpers below:
sums of statistics (:func:`dp_sum`, with shares of means from
:func:`dp_mean`), every gradient before its optimizer step
(:func:`dp_gradients`), the global row count (:func:`dp_global_rows`),
this process's rows of a whole-batch draw (:func:`dp_rows`). Without a
group each is the identity, so one update serves one process and many.
Where a split of the model crosses processes (fsdp, ep or tp shards,
pipeline stages) a process holds only its part of the gradient, and a
global norm is the sum of the parts' squares (:func:`grad_sq_norm`).
A bucketed gather's reduce-scatter waits for the autograd engine and runs
inside :func:`dp_gradients`, in the forward's order
(:func:`defer_scatter`): beside a pipeline across processes each rank
then meets its hops, its reduce-scatters and its data group's sums in
that order, whatever order the engine took. Where process blocks
straddle the mesh's lines the data group is every process and a
process's rows may overlap another's (those it does not account for
carry a zero ``valid`` mask); a minibatch then keeps its rows grouped by
data cell (:func:`dp_minibatch`), and the forward reads each cell's
count (:func:`cell_rows`) to hand a ring its cell's rows, so every
process that holds a cell feeds its ring the same rows in the same
order.

A layer whose work splits over an ``ep`` or ``tp`` axis that crosses
processes (the MoE's expert groups, the tp MLP pair) runs its part of the
work on every process of the axis's group, all of which hold the same
rows: its input enters through :func:`enter_split` (the identity; the
backward sums the partial input gradients over the group) and its partial
result leaves through :func:`leave_split` (summed over the group; the
backward the identity), the f and g of Megatron's tensor parallelism and
the ``psum`` GSPMD inserts in the JAX package.
"""

from __future__ import annotations

import contextlib
import threading
import time

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


def cell_rows() -> tuple[int, ...] | None:
    """How many rows each of this process's data cells has in the running
    forward, in cell order (:func:`use_cell_rows`); None: the rows split
    evenly over them."""
    return getattr(_state, "cell_rows", None)


@contextlib.contextmanager
def use_cell_rows(rows):
    """Run a forward over rows grouped by data cell, ``rows`` of each
    (:func:`dp_minibatch`; None: an even split)."""
    prev = cell_rows()
    _state.cell_rows = None if rows is None else tuple(int(r) for r in rows)
    try:
        yield
    finally:
        _state.cell_rows = prev


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
    mean times its share of the data cells; ``x.mean()`` without a
    group): summed over the group (:func:`dp_sum`, or through
    :func:`dp_gradients`) it is the mean over every process's rows."""
    group = current_dp_group()
    if group is None:
        return x.mean()
    _, count, total = _cells(group)
    return x.mean() / (total / count)


def hold_for_backward(leaf: torch.Tensor) -> None:
    """Have the next :func:`dp_gradients` of this thread ask ``leaf``'s
    gradient too (and drop it) if it asks one of a pipeline stage's
    parameters (``split_comms`` over ``pp``, set by the placement). A
    pipeline across processes threads its hops' backwards on such a leaf
    (:mod:`relayrl_tpu_torch.parallel.pipeline`): stage 0's rank needs
    them for its stage's gradient, and the last stage's rank would prune
    them where nothing before the pipeline trains (a frozen embedding).
    Every rank of the pp group asks its own stages' parameters or none,
    so either all run the hops' backwards or none does; a loss that
    reaches no stage (a value head's) runs none."""
    if not hasattr(_state, "held"):
        _state.held = []
    _state.held.append(leaf)


def _sum_flat(group, grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """``grads`` summed over ``group`` in one collective."""
    if group is None or not grads:
        return grads
    flat = group.all_reduce(torch.cat([g.reshape(-1).float() for g in grads]))
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].reshape(g.shape).to(g.dtype))
        offset += g.numel()
    return out


def defer_scatter(order: int, comm, dim: int, grad: torch.Tensor,
                  leaves: list, parts) -> bool:
    """Hold a bucketed gather's reduce-scatter (:class:`~relayrl_tpu_torch.
    parallel.sharding._Gathered`: ``grad`` is this rank's gradient of the
    whole, ``order`` its gather's place among the forward's, ``leaves``
    the shards its block was joined from over ``parts``, ``(dim, count)``
    pairs outermost first) for the running :func:`dp_gradients` to take
    once the autograd engine is done. False outside ``dp_gradients``: the
    caller reduce-scatters in its own backward."""
    sink = getattr(_state, "scatters", None)
    if sink is None:
        return False
    sink.append((order, comm, dim, grad, leaves, parts))
    return True


def _scatter_deferred(sink: list, params: list, grads: list) -> list:
    """The reduce-scatters :func:`defer_scatter` held, in the order of
    their gathers, each one's block gradient cut back onto the shards in
    ``params`` that the block was joined from; counted on
    :data:`~relayrl_tpu_torch.parallel.distributed.COMM` as ``deferred``."""
    from relayrl_tpu_torch.parallel.distributed import COMM

    grads = list(grads)
    index = {id(p): i for i, p in enumerate(params)}
    for _, comm, dim, grad, leaves, parts in sorted(sink, key=lambda entry: entry[0]):
        pieces = [comm.reduce_scatter(list(grad.chunk(comm.size, dim=dim)))]
        COMM.deferred += 1
        for d, n in parts:
            pieces = [c for p in pieces for c in p.chunk(n, dim=d)]
        for leaf, g in zip(leaves, pieces):
            i = index.get(id(leaf))
            if i is not None:
                g = g.to(leaf.device)
                grads[i] = g if grads[i] is None else grads[i] + g
    return grads


def dp_gradients(loss: torch.Tensor | None, params: list) -> list[torch.Tensor]:
    """The gradients of ``loss`` over ``params``, summed over the
    data-parallel group: the one place every optimizer step of every
    family takes its gradients. A parameter the loss does not reach takes
    a zero gradient, as in optax; ``loss=None`` (a process with no rows in
    a minibatch) contributes zeros, so every process joins the sum. Each
    process's loss is its rows' sum over the global count, so the sums are
    the single-process gradients. A shard whose gather crosses the fsdp
    ranks (``summed_over_fsdp``, set by the placement) took its sum over
    them in the gather's reduce-scatter: it is summed over the dp ranks
    alone. Where ``params`` hold a pipeline stage's, the leaves
    :func:`hold_for_backward` registered since the last call are asked
    too.

    A bucketed gather's reduce-scatter (:func:`defer_scatter`) runs after
    the autograd engine, in the order of the forward's gathers: each rank
    meets first its pipeline hops (ordered by their token chain), then
    these reduce-scatters, then the sums over the data group, whatever
    order the engine ran the rest in; every rank of an fsdp group holds
    the same stages and runs the same sequence. The engine runs every
    node on this thread (``set_multithreading_enabled(False)``): a CUDA
    tensor's backward would otherwise run on the engine's device thread,
    which does not see this thread's held reduce-scatters."""
    held, _state.held = getattr(_state, "held", []), []
    if not any(axis == "pp" for p in params for axis, _ in getattr(p, "split_comms", ())):
        held = []
    if loss is None:
        grads = [None] * len(params)
    else:
        _state.scatters = sink = []
        try:
            with torch.autograd.set_multithreading_enabled(False):
                grads = torch.autograd.grad(loss, list(params) + held,
                                            allow_unused=True)[:len(params)]
        finally:
            _state.scatters = None
        grads = _scatter_deferred(sink, params, grads)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    group = current_dp_group()
    if group is None or not grads:
        return grads
    presummed = [getattr(p, "summed_over_fsdp", False) for p in params]
    out = list(grads)
    for flag, sub in ((False, group), (True, getattr(group, "dp", None))):
        idx = [i for i, f in enumerate(presummed) if f == flag]
        for i, g in zip(idx, _sum_flat(sub, [grads[i] for i in idx])):
            out[i] = g
    return out


def grad_sq_norm(grads: list[torch.Tensor], params: list) -> torch.Tensor:
    """The squared global norm of the model's gradient, from this
    process's gradient leaves ``grads`` of ``params`` (after
    :func:`dp_gradients`): where a split of the model crosses processes
    (fsdp, ep or tp shards, pp stages) a process holds only its part, so
    the squares of such leaves are summed over the ranks of each axis
    they split over (``split_comms``, set by the placement), one
    all-reduce an axis, and every other leaf counts once, as the replica
    it is. Under ``{"fsdp": 2, "pp": 2}`` across 4 ranks a stage leaf's
    squares sum over the rank's pp group (once per pp line: after
    :func:`dp_gradients` the ranks of a stage hold its same gradient) and
    a split end's over its fsdp group (once per fsdp group, not once per
    pp rank). What GSPMD computes for ``optax.clip_by_global_norm`` in the
    JAX package; the plain sum of squares without a crossing split."""
    whole = torch.zeros((), dtype=torch.float32, device=grads[0].device if grads else None)
    parts: dict[tuple, torch.Tensor] = {}
    comms: dict[str, object] = {}
    for g, p in zip(grads, params):
        sq = g.float().square().sum()
        split = getattr(p, "split_comms", ())
        if not split:
            whole = whole + sq
            continue
        key = tuple(axis for axis, _ in split)
        parts[key] = parts.get(key, 0) + sq
        comms.update(split)
    if parts:
        keys = sorted(parts)
        flat = torch.stack([parts[k].reshape(()) for k in keys])
        for axis in sorted(comms):
            rows = [i for i, k in enumerate(keys) if axis in k]
            flat[rows] = comms[axis].all_reduce(flat[rows].clone())
        whole = whole + flat.sum()
    return whole


class _EnterSplit(torch.autograd.Function):
    """f: the identity; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(ctx.group, grad), None


class _LeaveSplit(torch.autograd.Function):
    """g: the sum over the group; the backward the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduce(group, x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _reduce(group, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``group`` (in f32, back in ``x``'s dtype), a new
    tensor; counted on :data:`~relayrl_tpu_torch.parallel.distributed.
    COMM`."""
    from relayrl_tpu_torch.parallel.distributed import COMM

    t0 = time.perf_counter()
    flat = x.detach().float().contiguous().clone()
    group.all_reduce(flat)
    COMM.reduces += 1
    COMM.reduce_bytes += flat.numel() * flat.element_size()
    COMM.reduce_seconds += time.perf_counter() - t0
    return flat.to(x.dtype)


def enter_split(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering a region whose work splits over ``group`` (an ep or
    tp :class:`~relayrl_tpu_torch.parallel.distributed.AxisGroup`): the
    same tensor, whose gradient is summed over the group; ``x`` itself
    without a group."""
    return x if group is None else _EnterSplit.apply(x, group)


def leave_split(x: torch.Tensor, group) -> torch.Tensor:
    """A region's partial result ``x`` summed over ``group``; ``x`` itself
    without a group."""
    return x if group is None else _LeaveSplit.apply(x, group)


def _cells(group) -> tuple[int, int, int]:
    """``group``'s :attr:`~relayrl_tpu_torch.parallel.distributed.
    DataParallelGroup.cells`: ``(first, count, total)``."""
    if group is None:
        return 0, 1, 1
    cells = getattr(group, "cells", None)
    return (group.rank, 1, group.size) if cells is None else cells


def dp_global_rows(local_rows: int) -> int:
    """The global batch's rows, from this process's (the batch splits
    evenly over the data cells)."""
    _, count, total = _cells(current_dp_group())
    return local_rows // count * total


def dp_row_range(global_rows: int) -> tuple[int, int]:
    """This process's rows of a global batch: ``[start, stop)``, the rows
    of its data cells (contiguous: its entries are)."""
    first, count, total = _cells(current_dp_group())
    per = global_rows // total
    return first * per, (first + count) * per


def dp_minibatch(idx: torch.Tensor, global_rows: int) -> tuple[torch.Tensor, list[int]]:
    """This process's part of a minibatch drawn over the global batch's
    ``global_rows`` (``idx``, global row indices in the minibatch's order):
    the local indices of the rows it holds, grouped by data cell in cell
    order and in the minibatch's order within each cell (so every process
    that holds a cell sees its rows alike), and each of its cells' count
    of them (for :func:`use_cell_rows`)."""
    first, count, total = _cells(current_dp_group())
    per = global_rows // total
    idx = idx[(idx >= first * per) & (idx < (first + count) * per)] - first * per
    cell = torch.div(idx, per, rounding_mode="floor")
    order = torch.sort(cell, stable=True).indices
    return idx[order], torch.bincount(cell, minlength=count).tolist()


def dp_rows(x: torch.Tensor) -> torch.Tensor:
    """This process's rows (dim 0) of a tensor drawn for the whole batch:
    every process draws the global batch's noise from the same generator
    state and keeps its rows, so its slice equals the single-process
    draw's."""
    start, stop = dp_row_range(x.shape[0])
    return x[start:stop]
