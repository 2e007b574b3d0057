"""Ring attention with flash chunk kernels: CUDA kernels, plain versions, ring.

Counterpart of :mod:`relayrl_tpu.parallel.ring_flash`, the kernel tier of
the sequence-parallel ring (:mod:`relayrl_tpu_torch.parallel.ring` is the
portable tier). Each round's "attend the local queries to the visiting K/V
chunk" is one kernel that carries the flash state in and out, so the
``[C, C]`` score matrix of a round never reaches device memory. Three
kernels in ``csrc/ring_flash.cu`` replace the Pallas TPU kernels of
``relayrl_tpu/parallel/ring_flash.py``:

* K4, :func:`chunk_fwd` (← ``_chunk_fwd_kernel``): resume the unfinalized
  ``(acc, m, l)``, attend one K/V chunk, flush the state unfinalized;
* K5, :func:`chunk_dq` (← ``_chunk_dq_kernel``): the dq pass of one
  (q-chunk, kv-chunk) pair, accumulated into a carried f32 buffer;
* K6, :func:`chunk_dkv` (← ``_chunk_dkv_kernel``): the dk/dv pass of one
  pair, accumulated into carried f32 buffers.

In bf16 all three run on the tensor cores, each on the tile step of its
flash counterpart between a resume and a flush of the carried state: K4 on
K1's (``csrc/flash_fwd_tile.cuh``), K5 on K2's and K6 on K3's
(``csrc/flash_bwd_tile.cuh``). In f32 they run on the CUDA cores.

Each takes a ``mode``: a chunk the shard attends at a round is entirely in
the past (``MODE_FULL``, no mask), the shard's own chunk (``MODE_DIAG``,
causal on local positions) or entirely in the future (``MODE_SKIP``). For
SKIP the wrapper launches nothing and hands the carry back as it is (the
JAX package's ``lax.cond``). CPU tensors take the plain versions
(:func:`chunk_fwd_plain`, :func:`chunk_dq_plain`, :func:`chunk_dkv_plain`);
CUDA tensors launch the kernel or raise. ``chunk_fwd.launches``,
``chunk_dq.launches`` and ``chunk_dkv.launches`` count launches.

Layouts: q, k, v, do are ``[B, C, H, D]`` in bf16 or f32, with any
(batch, time, head) strides and a contiguous head dim (views of the fused
qkv projection, split by chunk; in bf16 every q, k, v and do row must
start on a 16-byte boundary, and K4 needs k and v of one stride); the
carried state is f32, contiguous ``[B, H, C, D]`` (acc, dq, dk, dv) and
``[B, H, C]`` (m, l, lse2, delta). The kernels take head dims
:data:`~relayrl_tpu_torch.ops.flash.KERNEL_HEAD_DIMS`; the rings zero-pad a
narrower one to the next of them on every device
(:func:`~relayrl_tpu_torch.ops.flash.pad_head_dim`) and slice the results
back, with every scale from the true head dim.

The numbers, in one place, as the JAX package has them:

* q is scaled by ``log2(e)/sqrt(D)`` and rounded to its dtype once,
  outside the kernels (:func:`prescale_q`); scores are log2-space, the
  softmax runs on ``exp2``;
* the state and every chunk output are f32; the output is ``acc /
  max(l, 1e-30)`` cast once and ``lse2 = m + log2(l_safe)``;
* ``p`` is rounded to v's dtype before ``p.v``, ``ds`` to k's before
  ``ds.k``, ``p`` to do's before ``p^T.do`` and ``ds`` to q's before
  ``ds^T.q``;
* ``delta = rowsum(do * out)`` in f32 from the cast output, by a torch op
  before the backward; ``dq = acc / sqrt(D)`` and ``dk = acc / log2(e)``,
  each cast once at the end of the ring.

The ring (:func:`ring_flash_attention_sharded`, global view
:func:`make_ring_flash_attention`) is one ``torch.autograd.Function``, as
``jax.custom_vjp`` wraps the JAX one. Its backward is the manual two-pass
ring: once the forward's final lse2 is known every (q-chunk, kv-chunk)
pair's gradient is independent; dq accumulates locally while K/V visit,
and dk/dv accumulate on buffers that rotate with their chunk, so after one
rotation more than the forward's each chunk's gradient is back on its
shard. The shard bodies are generators driven by
:func:`~relayrl_tpu_torch.parallel.ring.run_ring` (a ``yield`` is a
rotation). A ring whose ``sp`` axis spans processes drives the same
bodies: each rank drives its block of shards at their global indices
(which set every round's FULL/DIAG/SKIP mode), its edges hop over
``torch.distributed`` send/receive, and the scatter and gather of
:mod:`relayrl_tpu_torch.parallel.ring` keep the rest of the model
replicated on the ranks.

Every kernel allocates its outputs: on a ring of shards that share one
card, the buffer a shard receives is the very tensor its predecessor
wrote, so nothing is updated in place.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Sequence

import torch

from relayrl_tpu_torch.ops.flash import (
    KERNEL_HEAD_DIMS,
    check_rows_aligned,
    flash_attention_delta,
    pad_head_dim,
)
from relayrl_tpu_torch.parallel.mesh import Mesh
from relayrl_tpu_torch.parallel.ring import (
    RingSpan,
    across_processes,
    ring_spans,
    run_ring,
    shard_gather,
    shard_split,
    whole_ring,
)

# Per-round chunk relationship (a kernel int argument).
MODE_SKIP, MODE_FULL, MODE_DIAG = 0, 1, 2
_NEG_INF = -1e30
_LOG2E = 1.4426950408889634


def prescale_q(q: torch.Tensor, head_dim: int | None = None) -> torch.Tensor:
    """Fold the softmax scale (``head_dim``, default q's) and the exp ->
    exp2 base change into q, and round back to q's dtype: ``[B, C, H, D]``,
    contiguous."""
    return (q.float() * (_LOG2E / math.sqrt(head_dim or q.shape[-1]))).to(q.dtype)


# -- plain versions ---------------------------------------------------------

def _scores2(mode: int, qs, k) -> torch.Tensor:
    """Log2-space scores ``[B, H, Cq, Ck]`` (f32), masked to -1e30 above
    the local diagonal under DIAG."""
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if mode == MODE_DIAG:
        C = s.shape[-1]
        s = torch.where(torch.ones((C, C), dtype=torch.bool, device=s.device).tril(),
                        s, _NEG_INF)
    return s


def chunk_fwd_plain(mode: int, qs, k, v, o, m, l):
    """K4's function as plain tensor code: the carried ``(o, m, l)`` after
    attending ``k, v``, the whole chunk as one block."""
    if mode == MODE_SKIP:
        return o, m, l
    s = _scores2(mode, qs, k)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp2(s - m_new[..., None])
    corr = torch.exp2(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return o_new, m_new, l_new


def _probs_and_ds(mode, qs, k, v, do, lse2, delta):
    s = _scores2(mode, qs, k)
    p = torch.exp2(s - lse2[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def chunk_dq_plain(mode: int, qs, k, v, do, lse2, delta, dq):
    """K5's function as plain tensor code: ``dq + ds.k`` (unscaled)."""
    if mode == MODE_SKIP:
        return dq
    _, ds = _probs_and_ds(mode, qs, k, v, do, lse2, delta)
    return dq + torch.einsum("bhqk,bkhd->bhqd", ds.to(k.dtype).float(), k.float())


def chunk_dkv_plain(mode: int, qs, k, v, do, lse2, delta, dk, dv):
    """K6's function as plain tensor code: ``(dk + ds^T.qs, dv + p^T.do)``
    (dk contracted against the prescaled q, unscaled)."""
    if mode == MODE_SKIP:
        return dk, dv
    p, ds = _probs_and_ds(mode, qs, k, v, do, lse2, delta)
    dv = dv + torch.einsum("bhqk,bqhd->bhkd", p.to(do.dtype).float(), do.float())
    dk = dk + torch.einsum("bhqk,bqhd->bhkd", ds.to(qs.dtype).float(), qs.float())
    return dk, dv


# -- kernels ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from relayrl_tpu_torch import _kernels

    lib = _kernels.load("ring_flash")
    dims = [ctypes.c_int] * 4                    # B, H, C, D
    strides = [ctypes.c_longlong] * 3            # one tensor's (b, t, h)
    tail = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # mode, is_bf16, stream
    lib.relayrl_ring_chunk_fwd.argtypes = [ctypes.c_void_p] * 9 + dims + strides * 3 + tail
    lib.relayrl_ring_chunk_dq.argtypes = [ctypes.c_void_p] * 8 + dims + strides * 4 + tail
    lib.relayrl_ring_chunk_dkv.argtypes = [ctypes.c_void_p] * 10 + dims + strides * 4 + tail
    for fn in (lib.relayrl_ring_chunk_fwd, lib.relayrl_ring_chunk_dq,
               lib.relayrl_ring_chunk_dkv):
        fn.restype = ctypes.c_int
    return lib


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_inputs(name: str, mode: int, inputs, state) -> None:
    """What every chunk kernel takes: one CUDA device; ``inputs`` (qs, k,
    v and, in the backward, do) of one ``[B, C, H, D]`` shape and dtype
    with a contiguous head dim; ``state`` contiguous f32 tensors of the
    ``[B, H, C, D]`` / ``[B, H, C]`` shapes their rank says."""
    qs = inputs[0]
    if mode not in (MODE_FULL, MODE_DIAG):
        raise ValueError(f"{name}: mode {mode} is not FULL or DIAG")
    if not qs.is_cuda or any(t.device != qs.device for t in (*inputs, *state)):
        raise ValueError(f"{name} takes CPU tensors (plain version) or CUDA "
                         f"tensors on one device (kernel); got "
                         f"{sorted({str(t.device) for t in (*inputs, *state)})}")
    if qs.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != qs.dtype for t in inputs):
        raise TypeError(f"{name} takes float32 or bfloat16 inputs of one dtype; "
                        f"got {[t.dtype for t in inputs]}")
    if qs.ndim != 4 or any(t.shape != qs.shape for t in inputs):
        raise ValueError(f"{name}: inputs must share one [B, C, H, D] shape; got "
                         f"{[tuple(t.shape) for t in inputs]}")
    B, C, H, D = qs.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in the kernel's {KERNEL_HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in inputs):
        raise ValueError(f"{name}: inputs need a contiguous head dim")
    for t in state:
        want = (B, H, C, D) if t.ndim == 4 else (B, H, C)
        if t.shape != want or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: state must be contiguous f32 {list(want)}; "
                             f"got {tuple(t.shape)} {t.dtype}")


def _dims(qs) -> tuple:
    B, C, H, D = qs.shape
    return B, H, C, D


def _strides(*tensors) -> tuple:
    return tuple(s for t in tensors for s in t.stride()[:3])


def _tail(mode, qs) -> tuple:
    return (int(mode), int(qs.dtype == torch.bfloat16),
            torch.cuda.current_stream(qs.device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")


def chunk_fwd(mode: int, qs, k, v, o, m, l):
    """K4: the carried ``(o, m, l)`` after attending the K/V chunk ``k, v``
    from the prescaled queries ``qs``; fresh f32 tensors (the carry itself
    under SKIP)."""
    if mode == MODE_SKIP:
        return o, m, l
    if _on_cpu(qs, k, v, o, m, l):
        return chunk_fwd_plain(mode, qs, k, v, o, m, l)
    _check_inputs("ring_chunk_fwd", mode, (qs, k, v), (o, m, l))
    check_rows_aligned("ring_chunk_fwd", qs, k, v)
    if qs.dtype == torch.bfloat16 and k.stride() != v.stride():
        raise ValueError("ring_chunk_fwd: bf16 k and v must share strides")
    out = (torch.empty_like(o), torch.empty_like(m), torch.empty_like(l))
    with torch.cuda.device(qs.device):
        err = _library().relayrl_ring_chunk_fwd(
            *(t.data_ptr() for t in (qs, k, v, o, m, l, *out)), *_dims(qs),
            *_strides(qs, k, v), *_tail(mode, qs))
    _raise_on(err, "ring_chunk_fwd")
    chunk_fwd.launches += 1
    return out


def chunk_dq(mode: int, qs, k, v, do, lse2, delta, dq):
    """K5: ``dq + ds.k`` for one (q-chunk, kv-chunk) pair, f32 and
    unscaled; a fresh tensor (``dq`` itself under SKIP)."""
    if mode == MODE_SKIP:
        return dq
    if _on_cpu(qs, k, v, do, lse2, delta, dq):
        return chunk_dq_plain(mode, qs, k, v, do, lse2, delta, dq)
    _check_inputs("ring_chunk_dq", mode, (qs, k, v, do), (lse2, delta, dq))
    check_rows_aligned("ring_chunk_dq", qs, k, v, do)
    out = torch.empty_like(dq)
    with torch.cuda.device(qs.device):
        err = _library().relayrl_ring_chunk_dq(
            *(t.data_ptr() for t in (qs, k, v, do, lse2, delta, dq, out)),
            *_dims(qs), *_strides(qs, k, v, do), *_tail(mode, qs))
    _raise_on(err, "ring_chunk_dq")
    chunk_dq.launches += 1
    return out


def chunk_dkv(mode: int, qs, k, v, do, lse2, delta, dk, dv):
    """K6: ``(dk + ds^T.qs, dv + p^T.do)`` for one pair, f32 and
    unscaled; fresh tensors (``dk, dv`` themselves under SKIP)."""
    if mode == MODE_SKIP:
        return dk, dv
    if _on_cpu(qs, k, v, do, lse2, delta, dk, dv):
        return chunk_dkv_plain(mode, qs, k, v, do, lse2, delta, dk, dv)
    _check_inputs("ring_chunk_dkv", mode, (qs, k, v, do), (lse2, delta, dk, dv))
    check_rows_aligned("ring_chunk_dkv", qs, k, v, do)
    out = (torch.empty_like(dk), torch.empty_like(dv))
    with torch.cuda.device(qs.device):
        err = _library().relayrl_ring_chunk_dkv(
            *(t.data_ptr() for t in (qs, k, v, do, lse2, delta, dk, dv, *out)),
            *_dims(qs), *_strides(qs, k, v, do), *_tail(mode, qs))
    _raise_on(err, "ring_chunk_dkv")
    chunk_dkv.launches += 1
    return out


chunk_fwd.launches = 0
chunk_dq.launches = 0
chunk_dkv.launches = 0


class ChunkCalls(NamedTuple):
    """The chunk functions a ring runs."""

    fwd: Callable
    dq: Callable
    dkv: Callable


# The wrappers: kernels for CUDA tensors, plain versions for CPU ones.
CHUNK_CALLS = ChunkCalls(chunk_fwd, chunk_dq, chunk_dkv)
# The plain versions on any device: the yardstick chip_smoke.py holds the
# kernels' ring to. Nothing in the package runs them on a GPU.
PLAIN_CHUNK_CALLS = ChunkCalls(chunk_fwd_plain, chunk_dq_plain, chunk_dkv_plain)


# -- the ring ---------------------------------------------------------------

def pick_chunk_block(C: int, cap: int = 1024) -> int | None:
    """Largest power-of-two divisor of the chunk length, capped; None when
    the chunk can't tile (callers fall back to the scan ring)."""
    b = 8
    if C % b:
        return None
    while b * 2 <= min(cap, C) and C % (b * 2) == 0:
        b *= 2
    return b


def _check_chunk_tiles(C: int) -> None:
    """The JAX package's tiling contract (its ``_resolve_chunk_config``),
    shared by the ring and the single-device cost model: the chunk must
    tile by 8, so the transformer routes the same shapes to the scan ring
    in both packages. The CUDA kernels walk the chunk in 64-row tiles of
    their own and mask its ragged end, so no block size reaches them (the
    JAX functions' ``block`` has no counterpart here)."""
    if pick_chunk_block(C) is None:
        raise ValueError(
            f"chunk length {C} does not tile; use the scan ring "
            f"(relayrl_tpu_torch.parallel.ring) for this shape")


def _zero_acc(qs) -> torch.Tensor:
    """An f32 ``[B, H, C, D]`` accumulator of zeros for queries ``qs``."""
    B, C, H, D = qs.shape
    return torch.zeros((B, H, C, D), dtype=torch.float32, device=qs.device)


def _init_state(qs):
    o = _zero_acc(qs)
    m = torch.full(o.shape[:3], _NEG_INF, dtype=torch.float32, device=qs.device)
    return o, m, torch.zeros_like(m)


def _finalize_chunk_state(o, l, out_dtype):
    """acc/l -> output chunk ``[B, C, H, D]`` (the flash finalize; 1e-30
    guards fully-masked rows, which only padding can produce). Returns
    (out, l_safe)."""
    l_safe = l.clamp_min(1e-30)
    return (o / l_safe[..., None]).to(out_dtype).permute(0, 2, 1, 3), l_safe


def _round_mode(idx: int, r: int, axis_size: int, causal: bool):
    kv_idx = (idx - r) % axis_size
    if not causal:
        return MODE_FULL, kv_idx
    mode = MODE_DIAG if kv_idx == idx else MODE_FULL if kv_idx < idx else MODE_SKIP
    return mode, kv_idx


def _ring_fwd_body(idx, axis_size, causal, calls, qs, kb, vb):
    """One shard's forward: prescaled local queries, its own K/V chunk ->
    (output chunk, lse2 ``[B, H, C]``)."""
    oml = _init_state(qs)
    # Round 0 on the local chunk, no communication; rounds 1..n-1 rotate
    # then combine (no dead final rotation, as in ring.py).
    oml = calls.fwd(_round_mode(idx, 0, axis_size, causal)[0], qs, kb, vb, *oml)
    for r in range(1, axis_size):
        kb, vb = yield kb, vb
        oml = calls.fwd(_round_mode(idx, r, axis_size, causal)[0], qs, kb, vb, *oml)
    o, m, l = oml
    out, l_safe = _finalize_chunk_state(o, l, qs.dtype)
    return out, m + torch.log2(l_safe)


def _ring_bwd_body(idx, axis_size, causal, calls, qs, kb, vb, do, lse2, delta):
    """One shard's backward -> its (dq, dk, dv) accumulators, f32
    ``[B, H, C, D]`` and unscaled; dk and dv are those of its own chunk."""
    dq_acc, dk_acc, dv_acc = _zero_acc(qs), _zero_acc(qs), _zero_acc(qs)

    def compute(r, kb, vb, dq_acc, dk_acc, dv_acc):
        # The dq and dk/dv passes share the skip schedule by construction.
        mode = _round_mode(idx, r, axis_size, causal)[0]
        return (calls.dq(mode, qs, kb, vb, do, lse2, delta, dq_acc),
                *calls.dkv(mode, qs, kb, vb, do, lse2, delta, dk_acc, dv_acc))

    # Round 0 on the local chunk; rounds 1..n-1 rotate-then-compute. dk/dv
    # ride with their chunk, so they need one more rotation after the last
    # compute to arrive home: n rotations for n rounds of contributions.
    dq_acc, dk_acc, dv_acc = compute(0, kb, vb, dq_acc, dk_acc, dv_acc)
    for r in range(1, axis_size):
        kb, vb, dk_acc, dv_acc = yield kb, vb, dk_acc, dv_acc
        dq_acc, dk_acc, dv_acc = compute(r, kb, vb, dq_acc, dk_acc, dv_acc)
    dk_acc, dv_acc = yield dk_acc, dv_acc
    return dq_acc, dk_acc, dv_acc


def _bhcd_to_bchd(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype).permute(0, 2, 1, 3)


class _RingFlash(torch.autograd.Function):
    """This process's shards of one ring (a
    :class:`~relayrl_tpu_torch.parallel.ring.RingSpan`); the tensor
    arguments are the shards' q chunks, then their k chunks, then their v
    chunks."""

    @staticmethod
    def forward(ctx, span, causal, calls, head_dim, *qkv):
        n = len(span.indices)
        q, k, v = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        results = run_ring([_ring_fwd_body(idx, span.size, causal, calls,
                                           prescale_q(q[i], head_dim), k[i], v[i])
                            for i, idx in enumerate(span.indices)],
                           span.devices, span.hop)
        outs = [out for out, _ in results]
        ctx.save_for_backward(*qkv, *outs, *(lse2 for _, lse2 in results))
        ctx.span, ctx.causal, ctx.calls = span, causal, calls
        ctx.head_dim = head_dim
        return tuple(outs)

    @staticmethod
    def backward(ctx, *d_outs):
        span = ctx.span
        n = len(span.indices)
        saved = ctx.saved_tensors
        q, k, v, out, lse2 = (saved[i * n:(i + 1) * n] for i in range(5))
        bodies = []
        for i, idx in enumerate(span.indices):
            do = d_outs[i] if d_outs[i].stride(-1) == 1 else d_outs[i].contiguous()
            bodies.append(_ring_bwd_body(
                idx, span.size, ctx.causal, ctx.calls, prescale_q(q[i], ctx.head_dim),
                k[i], v[i], do, lse2[i], flash_attention_delta(out[i], do)))
        grads = run_ring(bodies, span.devices, span.hop)
        scale = 1.0 / math.sqrt(ctx.head_dim)
        dq = [_bhcd_to_bchd(g[0] * scale, q[i].dtype) for i, g in enumerate(grads)]
        dk = [_bhcd_to_bchd(g[1] * (1.0 / _LOG2E), k[i].dtype) for i, g in enumerate(grads)]
        dv = [_bhcd_to_bchd(g[2], v[i].dtype) for i, g in enumerate(grads)]
        return (None, None, None, None, *dq, *dk, *dv)


def _ring_flash(q_shards, k_shards, v_shards, devices, causal, calls,
                span: RingSpan | None = None):
    """The flash ring over ``devices`` (every shard here), or over this
    rank's shards of ``span``: one output chunk a shard."""
    _check_chunk_tiles(q_shards[0].shape[1])
    span = span or whole_ring(devices)
    n = len(span.indices)
    padded, D = pad_head_dim(*q_shards, *k_shards, *v_shards)
    outs = _RingFlash.apply(span, bool(causal), calls, D, *padded)
    return [out if out.shape[-1] == D else out[..., :D] for out in outs[:n]]


def ring_flash_attention_sharded(q_shards: Sequence[torch.Tensor],
                                 k_shards: Sequence[torch.Tensor],
                                 v_shards: Sequence[torch.Tensor],
                                 devices: Sequence[torch.device],
                                 causal: bool = True) -> list[torch.Tensor]:
    """One flash-chunk ring over ``devices``, differentiable: the contract
    of :func:`relayrl_tpu_torch.parallel.ring.ring_attention_sharded`
    (shard ``i``'s local chunks ``[B, C, H, D]`` on ``devices[i]``). The
    chunk length must tile by 8 — use :func:`pick_chunk_block` and fall
    back to the scan ring when it returns None."""
    return _ring_flash(q_shards, k_shards, v_shards, devices, causal, CHUNK_CALLS)


def chunked_flash_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_chunks: int, causal: bool = True) -> torch.Tensor:
    """Single-device emulation of the ring's per-chunk kernel schedule
    (forward only) — the ring cost model without a second card.

    Runs K4 with every chunk local: q-chunk i visits kv-chunks 0..i
    (causal) under the ring's FULL/DIAG schedule, with the ``(acc, m, l)``
    state bounced through device memory between calls exactly as the ring
    carries it between rounds. Against
    :func:`relayrl_tpu_torch.ops.flash.flash_attention` at equal T it
    measures what ring chunking costs per device (state traffic and
    per-call overhead), without the transfers."""
    T = q.shape[1]
    if T % n_chunks:
        raise ValueError(f"T={T} not divisible by n_chunks={n_chunks}")
    C = T // n_chunks
    _check_chunk_tiles(C)
    (q, k, v), D = pad_head_dim(q, k, v)
    qs = prescale_q(q, D)
    outs = []
    for iq in range(n_chunks):
        qc = qs[:, iq * C:(iq + 1) * C]
        oml = _init_state(qc)
        last = iq if causal else n_chunks - 1
        for kv in range(last + 1):
            mode = MODE_DIAG if (causal and kv == iq) else MODE_FULL
            chunk = slice(kv * C, (kv + 1) * C)
            oml = chunk_fwd(mode, qc, k[:, chunk], v[:, chunk], *oml)
        outs.append(_finalize_chunk_state(oml[0], oml[2], q.dtype)[0])
    return torch.cat(outs, dim=1)[..., :D]


def _make_ring_flash(mesh: Mesh, axis_name: str, causal: bool, batch_axes,
                     calls: ChunkCalls):
    spans = ring_spans(mesh, axis_name, batch_axes)
    if spans[0].hop is not None:
        span = spans[0]
        return lambda q, k, v: across_processes(
            q, k, v, span,
            lambda qs, ks, vs: _ring_flash(qs, ks, vs, span.devices, causal, calls, span))
    groups = [list(sp.devices) for sp in spans]

    def ring(q, k, v):
        shards = zip(*(shard_split(x, groups) for x in (q, k, v)), groups)
        return shard_gather([_ring_flash(qs, ks, vs, devices, causal, calls)
                             for qs, ks, vs, devices in shards], q.device)
    return ring


def make_ring_flash_attention(mesh: Mesh, axis_name: str = "sp",
                              causal: bool = True,
                              batch_axes=("dp", "fsdp")):
    """Global-view flash-chunk ring attention ``[B, T, H, D] -> same``.

    Drop-in for :func:`relayrl_tpu_torch.parallel.ring.make_ring_attention`
    with the per-round combine running as the chunk kernels: the batch
    splits over the dp x fsdp groups and each group runs its own ring over
    its ``axis_name`` devices. Where the axis spans processes, this rank
    runs K4-K6 on its shards and the K/V chunks hop between ranks."""
    return _make_ring_flash(mesh, axis_name, causal, batch_axes, CHUNK_CALLS)
