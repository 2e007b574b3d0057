"""Flash attention, forward and backward: CUDA kernels, plain versions, wrapper.

Counterpart of :mod:`relayrl_tpu.ops.flash`. Three kernels replace the
Pallas TPU kernels of ``relayrl_tpu/ops/flash.py``; each source note gives
its design and what bounds it on the H100:

* K1, the forward (``csrc/flash_fwd.cu`` ← ``_fwd_kernel``): on ``[B, T, H,
  D]`` inputs, the attention output in the input dtype and the log2-space
  log-sum-exp ``lse2 [B, H, T]`` (f32), what ``relayrl_tpu.ops.flash._fwd``
  returns. Its bf16 kernel runs the products on the tensor cores, with the
  tile step it shares with the ring's K4 (``csrc/flash_fwd_tile.cuh``);
* K2, the dq pass, and K3, the dk/dv pass (``csrc/flash_bwd.cu`` ←
  ``_dq_kernel`` and ``_dkv_kernel``): the two-pass backward that
  ``relayrl_tpu.ops.flash._bwd_pallas`` runs, recomputing ``p`` from
  ``lse2`` and using ``ds = p * (dp - delta)`` with ``delta = rowsum(do *
  o)``, which is computed outside the kernels as the JAX package does, as
  is the prescaled q (:func:`prescale_q`, one copy read by both passes).
  Their bf16 kernels run the products on the tensor cores.

Every bf16 kernel needs each q, k, v (and do) row on a 16-byte boundary;
the wrappers raise otherwise. The kernels are instantiated for head dims
:data:`KERNEL_HEAD_DIMS`; :func:`flash_attention` zero-pads a narrower head
dim to the next of them (:func:`pad_head_dim`) and slices the results back,
on every device, so the CPU runs the same padding through the plain
versions. Every scale uses the true head dim.

The numbers they share with the TPU kernels:

* q is scaled by ``log2(e)/sqrt(D)`` and rounded back to its dtype, so the
  softmax runs in log2 space on ``exp2`` (the forward kernels prescale q at
  their load, the backward reads one prescaled copy);
* scores, the running max and the sum are f32; masked scores are -1e30, so
  ``p`` is exactly 0 there; ``l`` is clamped at 1e-30;
* the forward rounds ``p`` to v's dtype before the PV product; the backward
  rounds ``ds`` to k's dtype before ``ds.k``, ``p`` to do's dtype before
  ``p^T.do`` and ``ds`` to q's dtype before ``ds^T.q``; ``dq = acc/sqrt(D)``
  and ``dk = acc/log2(e)`` (dk contracts against the prescaled q);
* outputs are in the input dtype.

:func:`flash_attention` goes through one ``autograd.Function`` for every
device: CPU tensors take the plain versions forward and backward, CUDA
tensors launch the kernels or raise. ``flash_attention.launches``,
``.dq_launches`` and ``.dkv_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
# Head widths the kernels are instantiated for (csrc/flash_{fwd,bwd}.cu,
# csrc/ring_flash.cu).
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)


def _q_scale(head_dim: int) -> float:
    return _LOG2E / math.sqrt(head_dim)


def pad_head_dim(*xs: torch.Tensor) -> tuple[list[torch.Tensor], int]:
    """``(xs, D)``: tensors of one head dim D (the last axis), zero-padded
    to the narrowest of :data:`KERNEL_HEAD_DIMS` that holds D (8 -> 16,
    24 -> 32, 48 -> 64, 96 -> 128, 192 -> 256), or unchanged when D is one
    of them or wider than all. Zero columns of q, k, v and do leave the
    scores, p, delta and the live columns of O, dq, dk and dv as they are,
    and the padded columns come out zero: slice results back with ``[..., :D]``, and compute every
    scale from D. The pad and the slice are autograd ops, so gradients
    slice back too. Works on any device."""
    D = xs[0].shape[-1]
    width = next((w for w in KERNEL_HEAD_DIMS if w >= D), D)
    if width == D:
        return list(xs), D
    return [F.pad(x, (0, width - D)) for x in xs], D


def _scores2(q: torch.Tensor, k: torch.Tensor, causal: bool, head_dim: int | None):
    """(q prescaled and rounded to its dtype, as f32; log2-space scores
    ``[B, H, Tq, Tk]`` in f32, masked to -1e30). ``head_dim`` (default q's)
    sets the scale."""
    T = q.shape[1]
    qs = (q.float() * _q_scale(head_dim or q.shape[3])).to(q.dtype).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    if causal:
        pos = torch.arange(T, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, _NEG_INF)
    return qs, s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, head_dim: int | None = None):
    """K1's function as plain tensor code: ``(O, lse2)``. ``head_dim``
    (default q's) sets the scale, for q, k, v padded along the head dim."""
    _, s = _scores2(q, k, causal, head_dim)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)      # [B, H, T, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log2(l)).squeeze(-1)


def flash_attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(do * o)`` in f32, as contiguous ``[B, H, T]``."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, lse2, do, delta, causal, head_dim):
    qs, s = _scores2(q, k, causal, head_dim)
    p = torch.exp2(s - lse2[..., None])                    # [B, H, Tq, Tk]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return qs, p, p * (dp - delta[..., None])


def flash_attention_dq_plain(q, k, v, lse2, do, delta, causal: bool = True,
                             head_dim: int | None = None):
    """K2's function as plain tensor code: dq in q's dtype."""
    head_dim = head_dim or q.shape[-1]
    _, _, ds = _probs_and_ds(q, k, v, lse2, do, delta, causal, head_dim)
    acc = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return (acc * (1.0 / math.sqrt(head_dim))).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, lse2, do, delta, causal: bool = True,
                              head_dim: int | None = None):
    """K3's function as plain tensor code: ``(dk, dv)`` in k's and v's
    dtypes."""
    qs, p, ds = _probs_and_ds(q, k, v, lse2, do, delta, causal, head_dim)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qs)
    return (dk * (1.0 / _LOG2E)).to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, out, lse2, do, causal: bool = True,
                              head_dim: int | None = None):
    """The backward as plain tensor code: ``(dq, dk, dv)`` for upstream
    gradient ``do`` of the forward's ``(out, lse2)``."""
    delta = flash_attention_delta(out, do)
    dk, dv = flash_attention_dkv_plain(q, k, v, lse2, do, delta, causal, head_dim)
    return (flash_attention_dq_plain(q, k, v, lse2, do, delta, causal, head_dim),
            dk, dv)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from relayrl_tpu_torch import _kernels

    lib = _kernels.load("flash_fwd")
    fn = lib.relayrl_flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    from relayrl_tpu_torch import _kernels

    lib = _kernels.load("flash_bwd")
    strides = [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9
    lib.relayrl_flash_bwd_dq.argtypes = (
        [ctypes.c_void_p] * 7 + strides
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.relayrl_flash_bwd_dkv.argtypes = (
        [ctypes.c_void_p] * 8 + strides
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.relayrl_flash_bwd_dq.restype = ctypes.c_int
    lib.relayrl_flash_bwd_dkv.restype = ctypes.c_int
    return lib


def _check_kernel_inputs(q, k, v) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            "flash_attention takes CPU tensors (plain version) or CUDA "
            f"tensors on one device (kernel); got {q.device}, {k.device}, "
            f"{v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError("the flash kernel takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must share one [B, T, H, D] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in the kernel's "
                         f"{KERNEL_HEAD_DIMS} (narrower ones are padded; "
                         f"wider ones have no kernel)")
    if q.stride(-1) != 1 or k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError(
            "q, k, v must share strides with a contiguous head dim (views "
            "of one fused qkv projection, or contiguous tensors)")
    check_rows_aligned("flash_attention", q, k, v)


def _launch(q, k, v, causal: bool, head_dim: int):
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse2 = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    s_b, s_t, s_h, _ = q.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().relayrl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse2.data_ptr(), B, H, T, D, s_b, s_t, s_h, _q_scale(head_dim),
            int(causal), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed (cudaError {err})")
    flash_attention.launches += 1
    return out, lse2


def prescale_q(q: torch.Tensor, head_dim: int | None = None) -> torch.Tensor:
    """q scaled by ``log2(e)/sqrt(D)`` (D: ``head_dim``, default q's) and
    rounded to its dtype, contiguous: the one copy both backward kernels
    read, made once outside them as the JAX package's ``_prescale_q`` does
    (the plain versions round q the same way)."""
    return torch.mul(q, _q_scale(head_dim or q.shape[-1])).contiguous()


def _rows_aligned(x: torch.Tensor) -> bool:
    """Every ``[B, T, H]`` row of ``x`` starts on a 16-byte boundary."""
    step = 16 // x.element_size()
    return x.data_ptr() % 16 == 0 and all(s % step == 0 for s in x.stride()[:3])


def check_rows_aligned(name: str, *xs: torch.Tensor) -> None:
    """Raises unless every ``[B, T, H]`` row of each bf16 tensor in ``xs``
    starts on a 16-byte boundary: the bf16 kernels stage rows with 16-byte
    asynchronous copies."""
    if xs[0].dtype == torch.bfloat16 and not all(_rows_aligned(x) for x in xs):
        raise ValueError(
            f"{name}: the bf16 kernels need every q, k, v (and do) row on a "
            f"16-byte boundary (16-byte aligned data and row strides that "
            f"are multiples of 8 elements)")


def _check_bwd_inputs(qs, k, v, lse2, do, delta) -> torch.Tensor:
    """Checks what the backward kernels take beyond the forward's checks of
    q, k, v: the prescaled q, do, lse2, delta, and the bf16 kernels' row
    alignment. Returns ``do`` with a contiguous head dim (copied only when
    it has none, counted in ``flash_attention.do_copies``)."""
    B, T, H, _ = qs.shape
    if do.shape != qs.shape or do.dtype != qs.dtype or do.device != qs.device:
        raise ValueError(f"do must match q's shape, dtype and device; got "
                         f"{tuple(do.shape)} {do.dtype} {do.device}")
    if (qs.shape != k.shape or qs.dtype != k.dtype or qs.device != k.device
            or qs.stride(-1) != 1):
        raise ValueError("the prescaled q must match k's shape, dtype and "
                         "device, with a contiguous head dim")
    for name, x in (("lse2", lse2), ("delta", delta)):
        if (x.shape != (B, H, T) or x.dtype != torch.float32
                or x.device != qs.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 [B, H, T] on "
                             f"q's device; got {tuple(x.shape)} {x.dtype}")
    if do.stride(-1) != 1:
        flash_attention.do_copies += 1
        do = do.contiguous()
    check_rows_aligned("flash_attention backward", qs, k, v, do)
    return do


def _bwd_dims(qs, k, do) -> tuple:
    B, T, H, D = qs.shape
    return (B, H, T, D, *qs.stride()[:3], *k.stride()[:3], *do.stride()[:3])


def _launch_dq(qs, k, v, lse2, do, delta, causal: bool,
               head_dim: int | None = None) -> torch.Tensor:
    """K2: dq ``[B, T, H, D]`` in q's dtype, from ``qs = prescale_q(q)``;
    ``head_dim`` (default qs's) sets the 1/sqrt(D) scale."""
    do = _check_bwd_inputs(qs, k, v, lse2, do, delta)
    dq = torch.empty(qs.shape, dtype=qs.dtype, device=qs.device)
    with torch.cuda.device(qs.device):
        err = _bwd_library().relayrl_flash_bwd_dq(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_bwd_dims(qs, k, do), 1.0 / math.sqrt(head_dim or qs.shape[-1]),
            int(causal), int(qs.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_dq kernel launch failed (cudaError {err})")
    flash_attention.dq_launches += 1
    return dq


def _launch_dkv(qs, k, v, lse2, do, delta, causal: bool):
    """K3: ``(dk, dv)``, each ``[B, T, H, D]`` in the input dtype, from
    ``qs = prescale_q(q)``."""
    do = _check_bwd_inputs(qs, k, v, lse2, do, delta)
    dk = torch.empty(qs.shape, dtype=qs.dtype, device=qs.device)
    dv = torch.empty(qs.shape, dtype=qs.dtype, device=qs.device)
    with torch.cuda.device(qs.device):
        err = _bwd_library().relayrl_flash_bwd_dkv(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_bwd_dims(qs, k, do), int(causal), int(qs.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_dkv kernel launch failed (cudaError {err})")
    flash_attention.dkv_launches += 1
    return dk, dv


class _FlashForward(torch.autograd.Function):
    """Forward and backward of every device: the plain versions for CPU
    tensors, K1 forward and K2/K3 backward for CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, head_dim):
        if q.is_cuda:
            out, lse2 = _launch(q, k, v, causal, head_dim)
        else:
            out, lse2 = flash_attention_plain(q, k, v, causal, head_dim)
        ctx.causal, ctx.head_dim = causal, head_dim
        ctx.save_for_backward(q, k, v, out, lse2)
        ctx.mark_non_differentiable(lse2)
        # lse2 takes no gradient: no zeros are made for it.
        ctx.set_materialize_grads(False)
        return out, lse2

    @staticmethod
    def backward(ctx, d_out, _d_lse2):
        q, k, v, out, lse2 = ctx.saved_tensors
        if not q.is_cuda:
            return (*flash_attention_bwd_plain(q, k, v, out, lse2, d_out,
                                               ctx.causal, ctx.head_dim), None, None)
        delta = flash_attention_delta(out, d_out)
        qs = prescale_q(q, ctx.head_dim)
        dq = _launch_dq(qs, k, v, lse2, d_out, delta, ctx.causal, ctx.head_dim)
        dk, dv = _launch_dkv(qs, k, v, lse2, d_out, delta, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True):
    """Fused attention on ``[B, T, H, D]``: ``(O [B,T,H,D], lse2 [B,H,T])``,
    differentiable in q, k and v.

    CPU tensors take the plain versions; CUDA tensors launch the kernels,
    which take any ``T >= 1``, float32 or bfloat16, head dims up to the
    widest of :data:`KERNEL_HEAD_DIMS` (a narrower one is zero-padded to
    the next of them on every device, :func:`pad_head_dim`), and q, k, v
    that share strides with a contiguous head dim (the upstream gradient
    may have strides of its own). ``flash_attention.launches`` counts K1
    launches, ``.dq_launches`` K2's and ``.dkv_launches`` K3's."""
    (q, k, v), D = pad_head_dim(q, k, v)
    if not q.device.type == k.device.type == v.device.type == "cpu":
        _check_kernel_inputs(q, k, v)
    out, lse2 = _FlashForward.apply(q, k, v, bool(causal), D)
    return (out if out.shape[-1] == D else out[..., :D]), lse2


flash_attention.launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_launches = 0
flash_attention.do_copies = 0
