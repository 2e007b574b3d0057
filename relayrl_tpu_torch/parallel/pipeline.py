"""Pipeline parallelism: a GPipe microbatch schedule over the ``pp`` mesh
axis, on one controller.

Counterpart of :mod:`relayrl_tpu.parallel.pipeline`. Stage ``s`` owns a
contiguous slice of the layers, placed on ``mesh.axis_devices("pp")[s]``
by :func:`relayrl_tpu_torch.parallel.place_state`; each data group (one
coordinate of dp x fsdp) pipelines its own rows through those stages, cut
into microbatches; at tick ``t`` stage ``s`` runs microbatch ``t - s``::

    tick:     0    1    2    3    4        (M=3 microbatches, S=3 stages)
    stage 0:  m0   m1   m2   -    -
    stage 1:  -    m0   m1   m2   -
    stage 2:  -    -    m0   m1   m2   ->  outputs at ticks S-1 .. S+M-2

Each stage is a generator body driven by
:func:`relayrl_tpu_torch.parallel.ring.run_ring`, whose ``yield`` is the
hand-off to the next stage (``ppermute``): ``tensor.to(next stage's
device)``, a no-op where stages share a device. A multi-process pipeline
can answer the same ``yield`` with a send/receive pair. The last stage's
outputs, gathered to the input's device, are the result.

Bubble ticks do no work (the JAX schedule computes on zeros there and
discards the result, so no number changes), and the single controller runs
the data groups one after another on the stages' devices, which hold the
layers once. So each layer runs once per microbatch per data group: a
forward through L layers is ``L x M x groups`` layer calls. Differentiable:
every step is a torch op, so torch autograd runs the backward through the
schedule, each stage's saved tensors on its own device.

When the ``pp`` axis spans processes (:mod:`relayrl_tpu_torch.parallel.
mesh`), each rank holds a contiguous block of the stages
(``mesh.shard_indices("pp")``) and drives only those, on the same ticks
(:func:`_across_processes`). Where a stage's successor lies on another
rank, a :class:`StageHop` (the ring's hop, one way) sends its microbatch
activation downstream and the successor's rank receives it (an
activation of the shape and dtype of the microbatch; the last stage
sends nothing), staged through host memory where gloo carries CUDA
tensors. Every rank of the pp group computes the replicated ends itself:
the embedding feeds the pipeline on every rank but only stage 0's rank
consumes it, and the last stage's rank broadcasts the pipeline's output
to the others, as the JAX package's ``psum`` over ``pp`` replicates it.
The backward runs each piece the other way: each hop sends the gradient
of what it received upstream, the output's gradient is the last stage's
rank's own (every rank computed the same one; nothing is summed over
``pp``), and the feed's gradient is broadcast from stage 0's rank, so
every rank's embedding gets the single-process gradient. So that two
ranks meet their backward hops in one order, every cross-process piece
of a forward takes and returns a token, a scalar threaded through them
in forward order: a piece's backward waits for the next piece's, so each
rank's autograd engine runs them in exactly the reverse of the forward's
order, whatever else it schedules (NCCL ignores tags, and microbatch
activations share a shape: a swapped pair would raise nothing). The
chain starts at a leaf that
:func:`~relayrl_tpu_torch.parallel.context.dp_gradients` asks a gradient
for wherever it asks a stage's, so every rank runs the whole chain's
backward for a loss that trains the stages (with the embedding frozen,
the last stage's rank would otherwise prune its hops and stage 0's rank
wait on them). One pipelined forward per backward: two in one graph
would be ordered by the engine alone. The hops and broadcasts are
counted on :data:`COMM`.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from relayrl_tpu_torch.parallel.context import hold_for_backward
from relayrl_tpu_torch.parallel.mesh import Mesh, local_data_groups
from relayrl_tpu_torch.parallel.ring import RingHop, run_ring


class PipeComm:
    """What the cross-process pipeline moved in this process: activations
    and gradients sent and received by the hops, the output and feed
    broadcasts, their bytes, and seconds on the host clock (a gloo
    stage's copy to the host waits for the device)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.sends = self.send_bytes = self.recvs = self.recv_bytes = 0
        self.broadcasts = self.broadcast_bytes = 0
        self.hop_seconds = self.broadcast_seconds = 0.0

    def as_dict(self) -> dict:
        return dict(vars(self))

    def count_hop(self, sent: int | None, received: int | None, seconds: float) -> None:
        """One hand-off that sent and received the bytes given (None:
        that side moved nothing)."""
        if sent is not None:
            self.sends += 1
            self.send_bytes += sent
        if received is not None:
            self.recvs += 1
            self.recv_bytes += received
        self.hop_seconds += seconds


COMM = PipeComm()


class StageHop(RingHop):
    """This rank's edges of a pipeline whose stages span processes: a
    :class:`~relayrl_tpu_torch.parallel.ring.RingHop` (counted on
    :data:`COMM`) whose ``recv_from`` is the global rank of its first
    stage's predecessor and ``send_to`` that of its last stage's successor
    (None at an end); ``comm`` is the pp group (:class:`~relayrl_tpu_torch.
    parallel.distributed.AxisGroup`), ``first`` and ``last`` its members
    that hold stages 0 and S - 1."""

    def __init__(self, comm, up: int | None, down: int | None, first: int, last: int,
                 through_host: bool):
        super().__init__(down, up, comm.group, through_host, COMM)
        self.comm, self.rank, self.first, self.last = comm, comm.rank, first, last

    def broadcast(self, t: torch.Tensor | None, src: int, like,
                  device: torch.device) -> torch.Tensor:
        """Member ``src``'s ``t`` on every member of the group, on
        ``device`` (the others pass None and the ``(shape, dtype)``
        ``like``)."""
        t0 = time.perf_counter()
        buf = t if self.rank == src else torch.empty(like[0], dtype=like[1], device=device)
        out = self.comm.broadcast(buf.to(device), src)
        COMM.broadcasts += 1
        COMM.broadcast_bytes += out.numel() * out.element_size()
        COMM.broadcast_seconds += time.perf_counter() - t0
        return out


def resolve_microbatches(local_batch: int, n_stages: int,
                         requested: int | None = None) -> int:
    """Pick a microbatch count: the requested value when it divides the
    per-data-shard batch, else the largest divisor of ``local_batch`` not
    exceeding ``max(requested, n_stages)`` (more microbatches shrink the
    pipeline bubble — fraction (S-1)/(M+S-1))."""
    if requested is not None and local_batch % requested == 0:
        return requested
    target = max(requested or 0, n_stages)
    best = 1
    for m in range(1, local_batch + 1):
        if local_batch % m == 0 and m <= target:
            best = m
    return best


def _stage_body(stage: int, n_stages: int, n_micro: int, stage_fn: Callable,
                layers, feed: Sequence[torch.Tensor], device: torch.device):
    """One stage (the generator protocol of :func:`run_ring`): runs
    microbatch ``t - stage`` at tick ``t`` (stage 0 from ``feed``, the
    others from what their predecessor handed on), hands its output to the
    next stage, and returns its outputs (the last stage's are the
    pipeline's)."""
    inbox, outs = (), []
    ticks = n_micro + n_stages - 1
    for t in range(ticks):
        m = t - stage
        out = ()
        if 0 <= m < n_micro:
            h = feed[m].to(device) if stage == 0 else inbox[0]
            out = (stage_fn(layers, h),)
            if stage == n_stages - 1:
                outs.append(out[0])
                out = ()          # no successor: nothing to hand on
        if t < ticks - 1:
            inbox = yield out
    return outs


class _Feed(torch.autograd.Function):
    """The embedding's activations into the pipeline on every rank of the
    pp group (the identity, and the chain's first token); the backward
    broadcasts stage 0's rank's gradient, so every rank's embedding gets
    it."""

    @staticmethod
    def forward(ctx, hop, token, x):
        ctx.hop, ctx.like, ctx.device = hop, (x.shape, x.dtype), x.device
        return token.clone(), x.view_as(x)

    @staticmethod
    def backward(ctx, g_token, g_x):
        hop = ctx.hop
        dx = hop.broadcast(g_x if hop.rank == hop.first else None, hop.first,
                           ctx.like, ctx.device)
        return None, torch.zeros_like(g_token), dx


class _StageHop(torch.autograd.Function):
    """One tick's cross-process hand-off: ``send`` (a microbatch
    activation, or nothing) downstream, an activation shaped as ``like``
    (a meta tensor, or nothing) from upstream; the backward sends the
    received activation's gradient upstream and receives the sent one's
    from downstream."""

    @staticmethod
    def forward(ctx, hop, like, device, token, *send):
        ctx.hop, ctx.device = hop, send[0].device if send else device
        ctx.sent = tuple(t.to("meta") for t in send)
        return (token.clone(), *hop.exchange(send, device, like=like))

    @staticmethod
    def backward(ctx, g_token, *g_got):
        g_send = ctx.hop.exchange(g_got, ctx.device, reverse=True, like=ctx.sent)
        return (None, None, None, torch.zeros_like(g_token), *g_send)


class _Output(torch.autograd.Function):
    """The last stage's outputs (on its rank; nothing elsewhere) -> the
    pipeline's output on every rank of the group, broadcast from the
    last stage's rank; the backward keeps that rank's own gradient, split
    back onto its microbatches (every rank computed the same one)."""

    @staticmethod
    def forward(ctx, hop, like, device, token, *outs):
        ctx.hop, ctx.sizes = hop, [o.shape[0] for o in outs]
        ctx.devices = [o.device for o in outs]
        return hop.broadcast(torch.cat([o.to(device) for o in outs]) if outs else None,
                             hop.last, like, device)

    @staticmethod
    def backward(ctx, grad):
        parts = grad.split(ctx.sizes) if ctx.sizes else ()
        return (None, None, None, None,
                *(g.to(d) for g, d in zip(parts, ctx.devices)))


def stage_hop(mesh: Mesh, axis: str = "pp") -> StageHop:
    """This rank's :class:`StageHop` on ``mesh``, whose ``axis`` crosses
    processes."""
    from relayrl_tpu_torch.parallel import distributed

    owners = [int(r) for r in mesh.axis_owners(axis)]
    mine = mesh.shard_indices(axis)
    lo, hi = mine[0], mine[-1] + 1
    comm = distributed.axis_comm(mesh, axis)
    return StageHop(comm, owners[lo - 1] if lo > 0 else None,
                    owners[hi] if hi < len(owners) else None, comm.ranks.index(owners[0]),
                    comm.ranks.index(owners[-1]),
                    distributed.stages_through_host(mesh.axis_devices(axis)[lo]))


def _across_processes(stage_fn: Callable, layers, x: torch.Tensor, stages: Sequence[int],
                      devices, n_micro: int, hop) -> torch.Tensor:
    """The GPipe schedule on this rank's ``stages`` (a contiguous block of
    ``len(layers)``; ``devices`` by stage, None where another rank holds
    it): local hand-offs move, cross-process ones hop, the output is
    broadcast from the last stage's rank (the module docstring)."""
    n_stages = len(layers)
    lo, hi = stages[0], stages[-1] + 1
    token = torch.zeros((), device=x.device, requires_grad=torch.is_grad_enabled())
    if token.requires_grad:
        hold_for_backward(token)
    token, x_in = _Feed.apply(hop, token, x)
    feed = x_in.split(x.shape[0] // n_micro, dim=0)
    like = (feed[0].to("meta"),)
    inbox, outs = {}, []
    for t in range(n_micro + n_stages - 1):
        handed, nxt = None, {}
        for s in range(lo, hi):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            h = feed[m].to(devices[s]) if s == 0 else inbox.pop(s)
            y = stage_fn(layers[s], h)
            if s == n_stages - 1:
                outs.append(y)
            elif s + 1 < hi:
                nxt[s + 1] = y.to(devices[s + 1])
            else:
                handed = y
        inbox = nxt
        # Stage lo - 1's rank hands on microbatch t + 1 - lo at this tick.
        receive = lo > 0 and 0 <= t + 1 - lo < n_micro
        if handed is not None or receive:
            got = _StageHop.apply(hop, like if receive else (), devices[lo], token,
                                  *(() if handed is None else (handed,)))
            token = got[0]
            if receive:
                inbox[lo] = got[1]
    return _Output.apply(hop, (x.shape, x.dtype), x.device, token, *outs)


def pipeline_apply(stage_fn: Callable, stage_params: Sequence, x: torch.Tensor,
                   mesh: Mesh, n_microbatches: int | None = None,
                   axis: str = "pp", hop=None) -> torch.Tensor:
    """Apply a pipelined layer stack to activations ``x``.

    ``stage_params``: the per-layer params in order (a sequence whose
    length ``pp`` divides); stage ``s`` gets its contiguous slice.
    ``stage_fn(local_params, h) -> h`` applies one stage's layers (a loop
    over its slice; its output has ``h``'s shape and dtype). ``x``: global
    ``[B, ...]`` activations, split over the dp x fsdp groups by rows.
    Where ``axis`` crosses processes, this rank runs its own stages (their
    layers are the only ones it holds) and every rank of the pp group
    returns the output; ``hop`` stands in for :func:`stage_hop`'s (tests
    drive two ranks in one process)."""
    n_stages = mesh.shape[axis]
    if n_stages <= 1:
        return stage_fn(stage_params, x)
    n_layers = len(stage_params)
    if n_layers % n_stages:
        raise ValueError(
            f"layer stack of {n_layers} layers is not divisible by the pp mesh "
            f"axis ({n_stages} stages); pick n_layers as a multiple of pp")
    per = n_layers // n_stages
    layers = [stage_params[s * per:(s + 1) * per] for s in range(n_stages)]
    devices = mesh.axis_devices(axis)
    n_groups = local_data_groups(mesh)
    if x.shape[0] % n_groups:
        raise ValueError(f"batch of {x.shape[0]} rows does not split into "
                         f"{n_groups} data groups")
    local_b = x.shape[0] // n_groups
    n_micro = resolve_microbatches(local_b, n_stages, n_microbatches)
    if hop is not None or axis in mesh.cross_axes:
        # A rank's block of a crossing pp line is one data group (a
        # process's block of the mesh is a sub-grid).
        return _across_processes(stage_fn, layers, x, mesh.shard_indices(axis), devices,
                                 n_micro, hop or stage_hop(mesh, axis))
    out = []
    for rows in x.split(local_b, dim=0):
        feed = rows.split(local_b // n_micro, dim=0)
        bodies = [_stage_body(s, n_stages, n_micro, stage_fn, layers[s], feed,
                              devices[s]) for s in range(n_stages)]
        out += [y.to(x.device) for y in run_ring(bodies, devices)[-1]]
    return torch.cat(out, dim=0)
