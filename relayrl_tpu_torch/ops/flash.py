"""Flash-attention forward: the CUDA kernel, its plain version, the wrapper.

Counterpart of :mod:`relayrl_tpu.ops.flash`. The kernel
(``csrc/flash_fwd.cu``) replaces the Pallas TPU forward kernel
``relayrl_tpu/ops/flash.py::_fwd_kernel``; its source note gives the design
and what bounds it on the H100. Both compute, on ``[B, T, H, D]`` inputs,
the attention output in the input dtype and the log2-space log-sum-exp
``lse2 [B, H, T]`` (f32) — what ``relayrl_tpu.ops.flash._fwd`` returns:

* q is scaled by ``log2(e)/sqrt(D)`` and rounded back to its dtype, so the
  softmax runs in log2 space on ``exp2``;
* scores, the running max and the sum are f32; ``p`` is rounded to v's
  dtype before the PV product; masked scores are -1e30; ``l`` is clamped
  at 1e-30.

:func:`flash_attention` runs the plain version for CPU tensors and the
kernel for CUDA tensors; on a CUDA tensor it launches the kernel or raises.
Only the forward is ported: the dq and dk/dv kernels
(``relayrl_tpu/ops/flash.py::_dq_kernel`` and ``::_dkv_kernel``) come with
the learner slice, and until then a backward through the CUDA path raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
# Head widths the kernel is instantiated for (csrc/flash_fwd.cu).
KERNEL_HEAD_DIMS = (16, 32, 64)


def _q_scale(head_dim: int) -> float:
    return _LOG2E / math.sqrt(head_dim)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True):
    """The kernel's function as plain tensor code: ``(O, lse2)``."""
    B, T, H, D = q.shape
    qs = (q.float() * _q_scale(D)).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        pos = torch.arange(T, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)      # [B, H, T, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log2(l)).squeeze(-1)


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
                         f"{KERNEL_HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError(
            "q, k, v must share strides with a contiguous head dim (views "
            "of one fused qkv projection, or contiguous tensors)")


def _launch(q, k, v, causal: bool):
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse2 = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    s_b, s_t, s_h, _ = q.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().relayrl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse2.data_ptr(), B, H, T, D, s_b, s_t, s_h, _q_scale(D),
            int(causal), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed (cudaError {err})")
    flash_attention.launches += 1
    return out, lse2


class _FlashForward(torch.autograd.Function):
    """The kernel under autograd: a backward through it raises rather
    than return silently wrong (absent) gradients."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse2 = _launch(q, k, v, causal)
        ctx.mark_non_differentiable(lse2)
        return out, lse2

    @staticmethod
    def backward(ctx, d_out, d_lse2):
        raise NotImplementedError(
            "flash-attention backward on CUDA is not ported yet: the dq and "
            "dk/dv kernels (relayrl_tpu/ops/flash.py::_dq_kernel and "
            "::_dkv_kernel, K2/K3) come with the learner slice")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True):
    """Fused attention on ``[B, T, H, D]``: ``(O [B,T,H,D], lse2 [B,H,T])``.

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    kernel, which takes any ``T >= 1``, float32 or bfloat16, head dims
    :data:`KERNEL_HEAD_DIMS`, and q, k, v that share strides with a
    contiguous head dim. ``flash_attention.launches`` counts kernel
    launches."""
    if q.device.type == k.device.type == v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    _check_kernel_inputs(q, k, v)
    return _FlashForward.apply(q, k, v, bool(causal))


flash_attention.launches = 0
