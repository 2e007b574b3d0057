"""Ring attention: causal attention with the sequence sharded over ``sp``.

Counterpart of :mod:`relayrl_tpu.parallel.ring`, the portable ring: each
``sp`` shard holds one contiguous chunk of the sequence, queries stay
resident, and K/V chunks rotate around the ring while an online-softmax
accumulator (:func:`relayrl_tpu_torch.ops.attention.attention_block_combine`)
combines each incoming chunk. Shard ``i`` holds queries ``[i·C, (i+1)·C)``
and, at round ``r``, the K/V chunk of shard ``(i - r) mod n``; chunks
strictly in the future are masked to exact zeros by the combine step.

Single-controller inside a process, as the JAX package is: one process
drives every shard it holds. Each shard's body is written once, as a
generator over its global index, the ring size and its chunks; each
``yield`` is the rotation step, where the shard hands over what it sends
to its successor and is sent what its predecessor sent. :func:`run_ring`
drives one process's bodies of a ring in lockstep and rotates by
``tensor.to(successor's device)``: a no-op when the shards share a
device, a peer copy across GPUs.

When the ``sp`` axis spans processes (:mod:`relayrl_tpu_torch.parallel.mesh`),
each rank holds a contiguous block of the ring's shards (a
:class:`RingSpan`) and drives only those bodies. At the edges of its
block a :class:`RingHop` answers the ``yield``: one non-blocking
send/receive pair (``torch.distributed.batch_isend_irecv``) sends the
last shard's tuple to the rank of its successor and receives the tuple
of the first shard's predecessor, staged through host memory when gloo
carries CUDA tensors. Around the ring a pair of autograd functions keeps
the rest of the model replicated on every rank of the ring: the scatter
takes this rank's time chunks of the replicated q, k, v (its backward
gathers their gradients over the ring's ranks, so each rank holds the
whole dq, dk, dv) and the gather joins the ranks' output chunks (its
backward takes this rank's chunks of the gradient); both gather with
:func:`gather_time`. The hops' and the gathers' count, bytes and seconds
(host clock) accumulate on :data:`COMM`, as the kernel wrappers count
their ``launches``.

Differentiable: every step is a torch op (the rotation included; a hop
is an autograd function whose backward hops the gradients the other
way), so the gradient is torch autograd through the ring, as the JAX one
is autograd through ``ppermute``. It launches no kernel; it is the
fallback for chunks that do not tile by 8
(:mod:`relayrl_tpu_torch.parallel.ring_flash` is the kernel tier).
"""

from __future__ import annotations

import itertools
import time
from typing import Generator, NamedTuple, Sequence

import torch

from relayrl_tpu_torch.ops.attention import attention_block_combine, finalize_attention
from relayrl_tpu_torch.parallel.context import cell_rows
from relayrl_tpu_torch.parallel.mesh import Mesh

_NEG_INF = -1e30


class RingComm:
    """What the ring's hops and gathers moved in this process: counts,
    bytes sent by the hops, bytes the gathers returned, and seconds on the
    host clock (a gloo hop's copy to the host waits for the device)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.hops = self.hop_bytes = self.gathers = self.gather_bytes = 0
        self.hop_seconds = self.gather_seconds = 0.0
        # A straddled line's output gradient, broadcast from its lead.
        self.leads = self.lead_bytes = 0
        self.lead_seconds = 0.0

    def as_dict(self) -> dict:
        return dict(vars(self))

    def count_hop(self, sent: int | None, received: int | None, seconds: float) -> None:
        """One :meth:`RingHop.exchange` that sent and received the bytes
        given."""
        self.hops += 1
        self.hop_bytes += sent or 0
        self.hop_seconds += seconds


COMM = RingComm()


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, one after another, as one flat uint8 tensor."""
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


def _nbytes(tensors: Sequence[torch.Tensor]) -> int:
    """The bytes :func:`_pack` makes of tensors shaped as ``tensors``."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> tuple:
    """Inverse of :func:`_pack` for tensors shaped as ``like``."""
    out, offset = [], 0
    for t in like:
        size = t.numel() * t.element_size()
        out.append(buf[offset:offset + size].view(t.dtype).view(t.shape))
        offset += size
    return tuple(out)


class RingHop:
    """This rank's edges of a ring (or a pipeline) whose shards span
    processes: it sends to ``send_to`` (the rank of its last shard's
    successor) and receives from ``recv_from`` (the rank of its first
    shard's predecessor), both global ranks of ``group`` (None at a
    pipeline's end); ``through_host`` stages CUDA tensors through host
    memory (gloo); each exchange is counted on ``counts`` (a
    ``count_hop(sent, received, seconds)``)."""

    def __init__(self, send_to: int | None, recv_from: int | None, group,
                 through_host: bool, counts=COMM):
        self.send_to, self.recv_from = send_to, recv_from
        self.group, self.through_host, self.counts = group, through_host, counts

    def exchange(self, tensors: Sequence[torch.Tensor], device: torch.device,
                 reverse: bool = False, like: Sequence[torch.Tensor] | None = None) -> tuple:
        """Send ``tensors`` to the successor's rank and receive the
        predecessor's tuple, shaped as ``like`` (by default as
        ``tensors``; meta tensors will do), on ``device``; ``reverse``
        swaps the two directions (a gradient going back). Either tuple may
        be empty: a pipeline's stage at an end sends or receives nothing.
        One non-blocking pair, so two ranks that are each other's
        successor and predecessor do not deadlock."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        like = tensors if like is None else like
        dst, src = ((self.recv_from, self.send_to) if reverse
                    else (self.send_to, self.recv_from))
        ops, buf, got = [], None, None
        if tensors:
            buf = _pack(tensors)
            if self.through_host:
                buf = buf.cpu()
            ops.append(dist.P2POp(dist.isend, buf, dst, self.group))
        if like:
            got = torch.empty(_nbytes(like), dtype=torch.uint8,
                              device="cpu" if self.through_host else device)
            ops.append(dist.P2POp(dist.irecv, got, src, self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self.counts.count_hop(None if buf is None else buf.numel(),
                              None if got is None else got.numel(),
                              time.perf_counter() - t0)
        return () if got is None else _unpack(got.to(device), like)


class _Hop(torch.autograd.Function):
    """A hop as an autograd function: the backward sends the received
    tuple's gradients back to the predecessor's rank and receives the
    sent tuple's from the successor's."""

    @staticmethod
    def forward(ctx, hop, device, *tensors):
        ctx.hop, ctx.device = hop, tensors[0].device
        return hop.exchange(tensors, device)

    @staticmethod
    def backward(ctx, *grads):
        # Unused outputs' gradients arrive as zeros (materialized grads).
        return (None, None, *ctx.hop.exchange(grads, ctx.device, reverse=True))


def run_ring(bodies: Sequence[Generator], devices: Sequence[torch.device],
             hop: RingHop | None = None) -> list:
    """Drive one ring's shard bodies in lockstep and return what each
    returns. At every ``yield`` each shard sends a tuple of tensors to its
    successor (shard ``i`` to ``i + 1 mod n``, ``ppermute``'s ring) and
    receives its predecessor's, moved to its own device. Every body must
    yield equally often. With a ``hop`` the bodies are this rank's block
    of a ring that spans processes: the last one's tuple goes to the next
    rank and the first one receives the previous rank's."""
    n = len(bodies)
    results = [None] * n

    def advance(i, received):
        try:
            return bodies[i].send(received)
        except StopIteration as stop:
            results[i] = stop.value
            return None

    sent = [advance(i, None) for i in range(n)]
    while sent[0] is not None:
        if any(s is None for s in sent):
            raise RuntimeError("ring shards yielded unequal numbers of times")
        first = (tuple(t.to(devices[0]) for t in sent[-1]) if hop is None
                 else _Hop.apply(hop, devices[0], *sent[-1]))
        received = [first] + [tuple(t.to(devices[i]) for t in sent[i - 1])
                              for i in range(1, n)]
        sent = [advance(i, received[i]) for i in range(n)]
    if any(s is not None for s in sent):
        raise RuntimeError("ring shards yielded unequal numbers of times")
    return results


class RingSpan(NamedTuple):
    """The shards of one ring that this process drives: their devices
    and global indices in ring order, the ring's size, and (when the
    ring spans processes) the hop to the other ranks and ``counts``, the
    number of shards each rank of the ring holds, in ring order (None:
    equal). ``lead`` is the global rank whose losses count for the ring's
    rows where two ranks of the ring share a data group, as where process
    blocks straddle the mesh's lines (its lowest holder; None: every rank
    of the ring computes the same losses, each in its own data group)."""

    devices: tuple
    indices: tuple
    size: int
    hop: RingHop | None = None
    lead: int | None = None
    counts: tuple | None = None


def whole_ring(devices: Sequence[torch.device]) -> RingSpan:
    """A ring every shard of which this process drives."""
    return RingSpan(tuple(devices), tuple(range(len(devices))), len(devices))


def ring_spans(mesh: Mesh, axis_name: str, batch_axes: Sequence[str]) -> list[RingSpan]:
    """This process's part of each ring of ``mesh``, one a data cell in
    cell order (:func:`ring_groups`); where ``axis_name`` crosses
    processes, one span per line of it that this process holds shards of,
    in line order: the whole ring where the line stays in the process,
    else its shards with the hop over the line's group."""
    if axis_name not in mesh.cross_axes:
        return [whole_ring(devices) for devices in ring_groups(mesh, axis_name, batch_axes)]
    from relayrl_tpu_torch.parallel import distributed

    beside = [ax for ax in mesh.axis_names
              if ax != axis_name and ax not in batch_axes and mesh.shape[ax] > 1]
    if mesh.straddles and beside:
        # A rank would hold rings of several replicas.
        raise ValueError(f"mesh {mesh.shape}: a ring whose process blocks straddle the "
                         f"mesh's lines beside {beside}")
    # Other axes hold replicas, computed once: the lines through home's.
    lines = [line for line in mesh.lines(axis_name)
             if all(c is None or ax in batch_axes or c == h
                    for ax, c, h in zip(mesh.axis_names, line, mesh.home))]
    # A cell that two ranks of one data group hold counts on the lower
    # (Mesh.accountable_cells): on such a line that rank leads.
    data = set(mesh.data_ranks) - {mesh.process_index}
    spans = []
    for line in lines:
        owners = [int(r) for r in mesh.axis_owners(axis_name, line)]
        devices = mesh.axis_devices(axis_name, line)
        if set(owners) == {mesh.process_index}:
            spans.append(whole_ring(devices))
            continue
        indices, n = mesh.shard_indices(axis_name, line), len(owners)
        hop = RingHop(owners[(indices[-1] + 1) % n], owners[(indices[0] - 1) % n],
                      distributed.axis_group(mesh, axis_name, line),
                      distributed.stages_through_host(devices[indices[0]]))
        spans.append(RingSpan(tuple(devices[i] for i in indices), tuple(indices), n, hop,
                              min(owners) if data & set(owners) else None,
                              tuple(owners.count(r) for r in dict.fromkeys(owners))))
    return spans


def from_lead(grad: torch.Tensor, span: RingSpan) -> torch.Tensor:
    """``grad`` as the lead of ``span`` holds it, on every rank of the
    ring: one broadcast of its bytes over the ring's group (the other
    ranks' are zero, their rows' losses counting on the lead)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    buf = grad.detach().contiguous().clone().reshape(-1).view(torch.uint8)
    dist.broadcast(buf, src=span.lead, group=span.hop.group)
    COMM.leads += 1
    COMM.lead_bytes += buf.numel()
    COMM.lead_seconds += time.perf_counter() - t0
    return buf.view(grad.dtype).view(grad.shape)


def _leads(span: RingSpan) -> bool:
    from relayrl_tpu_torch.parallel import distributed

    return span.lead is None or span.lead == distributed.process_index()


def gather_time(parts: Sequence[torch.Tensor], span: RingSpan) -> list[torch.Tensor]:
    """Each of ``parts`` (this rank's contiguous time block ``[B, m·C,
    ...]`` of a tensor) joined with the other ranks' blocks of the ring
    along dim 1, in ring order: one all-gather of the packed parts over
    the ring's group, through host memory where gloo carries CUDA
    tensors. The join is exact: every rank gets the same bytes."""
    import torch.distributed as dist

    from relayrl_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    device = parts[0].device
    buf = _pack(parts)
    if distributed.stages_through_host(device):
        buf = buf.cpu()
    m = len(span.indices)
    counts = span.counts or (m,) * (span.size // m)
    # Ranks of a straddled line hold unequal numbers of shards: each
    # rank's bytes padded to the most any holds.
    size = buf.numel() // m * max(counts)
    if size > buf.numel():
        buf = torch.cat([buf, buf.new_zeros(size - buf.numel())])
    blocks = [torch.empty_like(buf) for _ in counts]
    dist.all_gather(blocks, buf, group=span.hop.group)
    per_rank = [_unpack(b.to(device), [
        torch.empty((p.shape[0], p.shape[1] // m * c, *p.shape[2:]), dtype=p.dtype,
                    device="meta") for p in parts]) for b, c in zip(blocks, counts)]
    out = [torch.cat([rank[j] for rank in per_rank], dim=1) for j in range(len(parts))]
    COMM.gathers += 1
    COMM.gather_bytes += buf.numel() * len(blocks)
    COMM.gather_seconds += time.perf_counter() - t0
    return out


def _chunk(x: torch.Tensor, span: RingSpan, i: int) -> torch.Tensor:
    C = x.shape[1] // span.size
    return x[:, i * C:(i + 1) * C]


class _Scatter(torch.autograd.Function):
    """Replicated q, k, v -> this rank's time chunks of each (q's, then
    k's, then v's); the backward gathers the chunks' gradients over the
    ring's ranks, so every rank holds the whole dq, dk and dv (on a
    straddled line only its lead keeps them: the others' zero)."""

    @staticmethod
    def forward(ctx, span, *qkv):
        ctx.span = span
        return tuple(_chunk(x, span, i) for x in qkv for i in span.indices)

    @staticmethod
    def backward(ctx, *grads):
        span, m = ctx.span, len(ctx.span.indices)
        blocks = [torch.cat(grads[j * m:(j + 1) * m], dim=1) for j in range(3)]
        whole = gather_time(blocks, span)
        if not _leads(span):
            # The lead carries the line's rows into the layers before.
            whole = [torch.zeros_like(g) for g in whole]
        return (None, *whole)


class _Gather(torch.autograd.Function):
    """This rank's output chunks -> the whole output, gathered over the
    ring's ranks; the backward takes this rank's chunks of the
    (replicated) gradient, on a straddled line of the lead's
    (:func:`from_lead`)."""

    @staticmethod
    def forward(ctx, span, *outs):
        ctx.span = span
        return gather_time([torch.cat(outs, dim=1)], span)[0]

    @staticmethod
    def backward(ctx, grad):
        if ctx.span.lead is not None:
            grad = from_lead(grad, ctx.span)
        return (None, *(_chunk(grad, ctx.span, i) for i in ctx.span.indices))


def across_processes(q, k, v, span: RingSpan, attend) -> torch.Tensor:
    """Ring attention over a ring that spans processes: ``attend`` maps
    this rank's chunk lists (q's, k's, v's) to its output chunks."""
    m = len(span.indices)
    chunks = _Scatter.apply(span, q, k, v)
    outs = attend(list(chunks[:m]), list(chunks[m:2 * m]), list(chunks[2 * m:]))
    return _Gather.apply(span, *outs)


def ring_groups(mesh: Mesh, axis_name: str,
                batch_axes: Sequence[str]) -> list[list[torch.device]]:
    """One device list per ring: the batch splits over whichever of
    ``batch_axes`` the mesh has (>1), in mesh order, and each batch group
    runs its own ring over ``axis_name``; other axes hold replicas, which a
    single controller computes once. Where a batch axis crosses
    processes, the rings of this process's coordinates along it."""
    b_axes = tuple(ax for ax in batch_axes if mesh.shape.get(ax, 1) > 1)
    return [mesh.axis_devices(axis_name, **dict(zip(b_axes, coord)))
            for coord in itertools.product(*(mesh.shard_indices(ax) for ax in b_axes))]


def shard_split(x: torch.Tensor,
                groups: Sequence[Sequence[torch.device]]) -> list[list[torch.Tensor]]:
    """``[B, T, ...]`` -> per ring, per shard: the ring's batch rows and the
    shard's contiguous time chunk, on the shard's device (views where the
    device is the tensor's own)."""
    B, T = x.shape[:2]
    n_groups, n = len(groups), len(groups[0])
    if B % n_groups or T % n:
        raise ValueError(f"[{B}, {T}, ...] does not split into {n_groups} batch "
                         f"groups x {n} sequence shards")
    return [[chunk.to(device) for chunk, device in zip(rows.split(T // n, dim=1), devices)]
            for rows, devices in zip(x.split(B // n_groups, dim=0), groups)]


def shard_gather(shards: Sequence[Sequence[torch.Tensor]],
                 device: torch.device) -> torch.Tensor:
    """Inverse of :func:`shard_split`, on ``device``."""
    return torch.cat([torch.cat([s.to(device) for s in row], dim=1)
                      for row in shards], dim=0)


def _ring_body(idx: int, axis_size: int, causal: bool, q, k, v):
    """One shard's ring: local chunks ``[B, C, H, D]`` in, its output chunk
    out (the generator protocol of :func:`run_ring`)."""
    B, C, H, D = q.shape
    local_pos = torch.arange(C, device=q.device)
    q_pos = idx * C + local_pos

    o = torch.zeros((B, H, C, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, C), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, C), dtype=torch.float32, device=q.device)

    def mask_for(kv_idx):
        if not causal:
            return torch.ones((C, C), dtype=torch.bool, device=q.device)
        return q_pos[:, None] >= (kv_idx * C + local_pos)[None, :]

    # Round 0 consumes the local chunk with no communication; rounds
    # 1..n-1 rotate-then-combine, so exactly n-1 neighbor exchanges happen
    # (no dead final rotation).
    o_m_l = attention_block_combine((o, m, l), q, k, v, mask_for(idx))
    for r in range(1, axis_size):
        k, v = yield k, v
        kv_idx = (idx - r) % axis_size
        o_m_l = attention_block_combine(o_m_l, q, k, v, mask_for(kv_idx))
    o, m, l = o_m_l
    return finalize_attention(o, l, q.dtype)


def ring_attention_sharded(q_shards: Sequence[torch.Tensor],
                           k_shards: Sequence[torch.Tensor],
                           v_shards: Sequence[torch.Tensor],
                           devices: Sequence[torch.device],
                           causal: bool = True,
                           span: RingSpan | None = None) -> list[torch.Tensor]:
    """One ring over ``devices``: shard ``i``'s local chunks ``[B, C, H,
    D]`` (on ``devices[i]``; the global sequence is the chunks laid out in
    ring order) -> its output chunk. The single-controller counterpart of
    calling the JAX function inside ``shard_map``. With a ``span`` the
    chunks are those of its shards, at their global indices, and the ring
    hops to the other ranks."""
    span = span or whole_ring(devices)
    bodies = [_ring_body(i, span.size, causal, q, k, v)
              for i, q, k, v in zip(span.indices, q_shards, k_shards, v_shards)]
    return run_ring(bodies, span.devices, span.hop)


def over_spans(spans: Sequence[RingSpan], sharded):
    """Global-view attention ``[B, T, H, D] -> [B, T, H, D]`` over this
    process's rings: ``sharded(qs, ks, vs, devices, span)`` runs one ring
    (``span`` None for a ring every shard of which is here). Each ring
    attends its data cell's rows: the counts :func:`~relayrl_tpu_torch.
    parallel.context.cell_rows` gives (a minibatch's), else an even split;
    a ring with none is skipped, as every rank that holds its cell skips
    it. The rings run in span order (where process blocks straddle the
    mesh's lines, whole and crossing rings mix, in line order: every rank
    of a crossing ring meets it at the same place); a crossing ring
    attends this rank's chunks of its rows and gathers the output
    (:func:`across_processes`). The output lands on the input's device."""
    def ring(q, k, v):
        rows = cell_rows()
        if rows is None:
            if q.shape[0] % len(spans):
                raise ValueError(f"{q.shape[0]} rows do not split over {len(spans)} rings")
            rows = (q.shape[0] // len(spans),) * len(spans)
        if len(rows) != len(spans) or sum(rows) != q.shape[0]:
            raise ValueError(f"rows {rows} of {len(spans)} data cells for {q.shape[0]} rows")
        outs, start = [], 0
        for span, n in zip(spans, rows):
            part = [x[start:start + n] for x in (q, k, v)]
            start += n
            if n == 0:
                continue
            if span.hop is None:
                devices = list(span.devices)
                (qs,), (ks,), (vs,) = (shard_split(x, [devices]) for x in part)
                outs.append(shard_gather([sharded(qs, ks, vs, devices, None)], q.device))
            else:
                outs.append(across_processes(
                    *part, span,
                    lambda qs, ks, vs, span=span: sharded(qs, ks, vs, span.devices, span)
                ).to(q.device))
        return torch.cat(outs, dim=0) if outs else torch.zeros_like(q)
    return ring


def make_ring_attention(mesh: Mesh, axis_name: str = "sp",
                        causal: bool = True, batch_axes=("dp", "fsdp")):
    """Global-view ring attention ``[B, T, H, D] -> [B, T, H, D]``: time
    sharded on ``axis_name``, batch on whichever of ``batch_axes`` the mesh
    actually has (>1); the output lands on the input's device. Where the
    axis spans processes, this rank attends its chunks of the replicated
    inputs and every rank of the ring gets the whole output."""
    return over_spans(ring_spans(mesh, axis_name, batch_axes),
                      lambda qs, ks, vs, devices, span: ring_attention_sharded(
                          qs, ks, vs, devices, causal, span))
