"""V-trace off-policy correction (IMPALA) on fixed-shape padded batches.

Counterpart of :mod:`relayrl_tpu.ops.vtrace`: actors run stale policies,
and V-trace importance-weights their trajectories back to the learner's
current policy with clipped ratios. The inputs are padded ``[B, T]``
tensors with a validity mask, as in :mod:`relayrl_tpu_torch.ops.gae`.

The JAX version runs the reverse recursion ``a_t = δ_t + γ c_t a_{t+1}``
as a ``lax.scan`` over T. Here it is a log-depth doubling scan over
(coefficient, value) pairs, the doubling of
:func:`~relayrl_tpu_torch.ops.gae.discount_cumsum` with a coefficient per
step: ``ceil(log2 T)`` steps, 8 at T = 256, no loop over T, and no
division by a product of coefficients (the ``c_t`` may be 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VTraceReturns(NamedTuple):
    vs: torch.Tensor       # [B, T] value targets
    pg_adv: torch.Tensor   # [B, T] policy-gradient advantages (rho-clipped)
    rho: torch.Tensor      # [B, T] clipped importance ratios (diagnostic)


def reverse_linear_scan(coeff: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[t] = x[t] + coeff[t] * out[t+1]`` along the last axis, with
    ``out[T] = 0``.

    Each position holds the affine map ``y -> b + a * y`` of the segment
    that starts there; after the step with shift ``s`` it spans ``2s``
    steps (``b[t] += a[t] * b[t+s]``, ``a[t] *= a[t+s]``), and positions
    whose segment reaches past the end keep theirs."""
    a, b = coeff, x
    n = b.shape[-1]
    shift = 1
    while shift < n:
        b = torch.cat([b[..., :-shift] + a[..., :-shift] * b[..., shift:],
                       b[..., -shift:]], dim=-1)
        a = torch.cat([a[..., :-shift] * a[..., shift:],
                       torch.zeros_like(a[..., -shift:])], dim=-1)
        shift *= 2
    return b


def vtrace(
    behavior_logp: torch.Tensor,
    target_logp: torch.Tensor,
    rew: torch.Tensor,
    val: torch.Tensor,
    valid: torch.Tensor,
    gamma: float,
    last_val: torch.Tensor | None = None,
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
) -> VTraceReturns:
    """Compute V-trace targets/advantages.

    ``behavior_logp`` is the actor-side log-prob stored at sample time;
    ``target_logp`` the learner policy's log-prob of the same actions;
    ``val`` the learner critic's values v(x_t). With behavior == target
    and ``rho_bar, c_bar >= 1`` the recursion telescopes to the on-policy
    n-step return. The caller passes detached ``target_logp`` and ``val``
    where no gradient may flow through the targets (JAX's
    ``stop_gradient``).
    """
    rew = rew * valid
    val = val * valid
    if last_val is None:
        last_val = torch.zeros(rew.shape[:-1], dtype=rew.dtype,
                               device=rew.device)

    log_rho = torch.where(valid > 0, target_logp - behavior_logp,
                          torch.zeros_like(target_logp))
    ratio = torch.exp(log_rho)
    rho = torch.clamp(ratio, max=rho_bar) * valid
    c = torch.clamp(ratio, max=c_bar) * valid

    # v_{t+1} with the bootstrap injected at the last valid step (the
    # construction of ops/gae.gae_advantages).
    lengths = valid.sum(dim=-1).to(torch.int64)
    t_idx = torch.arange(rew.shape[-1], device=rew.device)
    is_last = (t_idx == (lengths[..., None] - 1)) & (valid > 0)
    val_next = torch.cat([val[..., 1:], last_val[..., None]], dim=-1)
    val_next = torch.where(is_last, last_val[..., None], val_next)

    delta = rho * (rew + gamma * val_next - val) * valid

    # Reverse recursion a_t = (δ_t + γ c_t a_{t+1}) · valid_t; δ_t is 0 on
    # padding, so masking the coefficient masks the whole term.
    a = reverse_linear_scan(gamma * c * valid, delta) * valid
    vs = (val + a) * valid

    # vs_{t+1} for the pg advantage, bootstrapping the last valid step.
    vs_next = torch.cat([vs[..., 1:], last_val[..., None]], dim=-1)
    vs_next = torch.where(is_last, last_val[..., None], vs_next)
    pg_adv = rho * (rew + gamma * vs_next - val) * valid
    return VTraceReturns(vs=vs, pg_adv=pg_adv, rho=rho)
