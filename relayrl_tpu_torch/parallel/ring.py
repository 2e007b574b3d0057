"""Ring attention: causal attention with the sequence sharded over ``sp``.

Counterpart of :mod:`relayrl_tpu.parallel.ring`, the portable ring: each
``sp`` shard holds one contiguous chunk of the sequence, queries stay
resident, and K/V chunks rotate around the ring while an online-softmax
accumulator (:func:`relayrl_tpu_torch.ops.attention.attention_block_combine`)
combines each incoming chunk. Shard ``i`` holds queries ``[i·C, (i+1)·C)``
and, at round ``r``, the K/V chunk of shard ``(i - r) mod n``; chunks
strictly in the future are masked to exact zeros by the combine step.

Single-controller, as the JAX package is: one process drives every shard.
Each shard's body is written once, as a generator over its index, the ring
size and its chunks; each ``yield`` is the rotation step, where the shard
hands over what it sends to its successor and is sent what its predecessor
sent. :func:`run_ring` drives the bodies of one ring in lockstep and
rotates by ``tensor.to(successor's device)``: a no-op when the shards share
a device, a peer copy across GPUs. A multi-process ring (one shard per
rank) will drive the same bodies, answering each ``yield`` with a
``torch.distributed`` send/receive pair.

Differentiable: every step is a torch op (the rotation included), so the
gradient is torch autograd through the ring, as the JAX one is autograd
through ``ppermute``. It launches no kernel; it is the fallback for chunks
that do not tile by 8 (:mod:`relayrl_tpu_torch.parallel.ring_flash` is the
kernel tier).
"""

from __future__ import annotations

import itertools
from typing import Generator, Sequence

import torch

from relayrl_tpu_torch.ops.attention import attention_block_combine, finalize_attention
from relayrl_tpu_torch.parallel.mesh import Mesh

_NEG_INF = -1e30


def run_ring(bodies: Sequence[Generator], devices: Sequence[torch.device]) -> list:
    """Drive one ring's shard bodies in lockstep and return what each
    returns. At every ``yield`` each shard sends a tuple of tensors to its
    successor (shard ``i`` to ``i + 1 mod n``, ``ppermute``'s ring) and
    receives its predecessor's, moved to its own device. Every body must
    yield equally often."""
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
        sent = [advance(i, tuple(t.to(devices[i]) for t in sent[i - 1]))
                for i in range(n)]
    if any(s is not None for s in sent):
        raise RuntimeError("ring shards yielded unequal numbers of times")
    return results


def ring_groups(mesh: Mesh, axis_name: str,
                batch_axes: Sequence[str]) -> list[list[torch.device]]:
    """One device list per ring: the batch splits over whichever of
    ``batch_axes`` the mesh has (>1), in mesh order, and each batch group
    runs its own ring over ``axis_name``; other axes hold replicas, which a
    single controller computes once."""
    b_axes = tuple(ax for ax in batch_axes if mesh.shape.get(ax, 1) > 1)
    return [mesh.axis_devices(axis_name, **dict(zip(b_axes, coord)))
            for coord in itertools.product(*(range(mesh.shape[ax])
                                             for ax in b_axes))]


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
                           causal: bool = True) -> list[torch.Tensor]:
    """One ring over ``devices``: shard ``i``'s local chunks ``[B, C, H,
    D]`` (on ``devices[i]``; the global sequence is the chunks laid out in
    ring order) -> its output chunk. The single-controller counterpart of
    calling the JAX function inside ``shard_map``."""
    n = len(devices)
    bodies = [_ring_body(i, n, causal, q, k, v)
              for i, (q, k, v) in enumerate(zip(q_shards, k_shards, v_shards))]
    return run_ring(bodies, devices)


def make_ring_attention(mesh: Mesh, axis_name: str = "sp",
                        causal: bool = True, batch_axes=("dp", "fsdp")):
    """Global-view ring attention ``[B, T, H, D] -> [B, T, H, D]``: time
    sharded on ``axis_name``, batch on whichever of ``batch_axes`` the mesh
    actually has (>1); the output lands on the input's device."""
    groups = ring_groups(mesh, axis_name, batch_axes)

    def ring(q, k, v):
        shards = zip(*(shard_split(x, groups) for x in (q, k, v)), groups)
        return shard_gather([ring_attention_sharded(qs, ks, vs, devices, causal)
                             for qs, ks, vs, devices in shards], q.device)
    return ring
