"""Multi-head attention as plain tensor code: dense and blockwise.

Counterpart of :mod:`relayrl_tpu.ops.attention`. ``dense_attention`` is the
correctness anchor and the readout row's attention; ``blockwise_attention``
is the online-softmax recurrence over KV blocks, the path a long window
takes when it does not tile for the flash kernel.

Layout convention: ``[batch, time, heads, head_dim]`` (BTHD) everywhere.
Scores and softmax are float32 whatever the input dtype.
"""

from __future__ import annotations

import math

import torch

# Finite large-negative fill: keeps exp()/grad NaN-free where a row is
# fully masked.
_NEG_INF = -1e30


def _positions(offset, n: int, device) -> torch.Tensor:
    """``offset + arange(n)``: ``[n]`` for a scalar offset, ``[B, n]`` for
    a per-batch offset vector."""
    off = torch.as_tensor(offset, device=device)
    return off[..., None] + torch.arange(n, device=device)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset=0,
                    kv_offset=0) -> torch.Tensor:
    """Plain softmax attention on ``[B, Tq, H, D] x [B, Tk, H, D]``.

    ``q_offset``/``kv_offset`` are the time positions of the first
    query/key: an int, or a ``[B]`` tensor giving each batch row its own
    offset (the batched readout row, where every lane reads out at its own
    position)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = _positions(q_offset, q.shape[1], q.device)
        kv_pos = _positions(kv_offset, k.shape[1], q.device)
        mask = q_pos[..., :, None] >= kv_pos[..., None, :]
        mask = mask[:, None] if mask.ndim == 3 else mask[None, None]
        s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def attention_block_combine(carry, q, k_blk, v_blk, mask):
    """One online-softmax accumulation step over a KV block.

    ``carry = (o, m, l)`` with ``o [B,H,Tq,D]`` un-normalized output,
    ``m [B,H,Tq]`` running max, ``l [B,H,Tq]`` running denominator, all
    float32; ``mask [Tq, Tk]`` is the validity of each (query, key) pair."""
    o, m, l = carry
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    s = torch.where(mask, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # Rows with no valid key yet keep m == _NEG_INF; exp(s - m) would be
    # exp(0) = 1 there, so zero those entries via the mask.
    p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    correction = torch.exp(m - m_new)
    l = l * correction + p.sum(dim=-1)
    o = o * correction[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p, v_blk.float())
    return o, m_new, l


def finalize_attention(o: torch.Tensor, l: torch.Tensor,
                       out_dtype) -> torch.Tensor:
    """Normalize the online-softmax accumulator and restore BTHD layout."""
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(out_dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_size: int = 128,
                        causal: bool = True) -> torch.Tensor:
    """Memory-efficient attention: a loop over KV blocks; peak memory is
    O(T * block_size) instead of O(T * T). Requires ``T % block_size == 0``."""
    B, T, H, D = q.shape
    if T % block_size != 0:
        raise ValueError(f"seq len {T} not divisible by block {block_size}")
    dev = q.device
    q_pos = torch.arange(T, device=dev)
    o = torch.zeros((B, H, T, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, T), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=dev)
    for start in range(0, T, block_size):
        kv_pos = start + torch.arange(block_size, device=dev)
        if causal:
            mask = q_pos[:, None] >= kv_pos[None, :]
        else:
            mask = torch.ones((T, block_size), dtype=torch.bool, device=dev)
        blk = slice(start, start + block_size)
        o, m, l = attention_block_combine((o, m, l), q, k[:, blk], v[:, blk],
                                          mask)
    return finalize_attention(o, l, q.dtype)
