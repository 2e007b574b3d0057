"""Discounted-return / GAE-λ ops on fixed-shape padded batches.

Counterpart of :mod:`relayrl_tpu.ops.gae`: the same functions on padded
``[..., T]`` tensors with a validity mask, so a whole epoch's advantages
are a few tensor ops on the device and no host round trip.

The JAX version runs ``discount_cumsum`` as an associative scan. Here it is
a log-depth doubling scan (Hillis-Steele): ``ceil(log2 T)`` shifted
multiply-adds, 8 at T = 256, and no loop over T. The closed form "cumsum
over discount powers" is not used: dividing by ``discount**T`` (about 2e-6
at γλ = 0.98 · 0.97 and T = 256) loses f32 precision.
"""

from __future__ import annotations

import torch


def discount_cumsum(x: torch.Tensor, discount: float, dim: int = -1) -> torch.Tensor:
    """Reverse discounted cumulative sum along ``dim``:
    ``out[t] = sum_k discount^k * x[t+k]``.

    After the step with shift ``s`` every ``out[t]`` holds the sum of its
    next ``2s`` terms: ``out[t] += discount^s * out[t+s]``."""
    out = x.movedim(dim, -1)
    n = out.shape[-1]
    coeff, shift = float(discount), 1
    while shift < n:
        out = torch.cat([out[..., :-shift] + coeff * out[..., shift:],
                         out[..., -shift:]], dim=-1)
        coeff, shift = coeff * coeff, 2 * shift
    return out.movedim(-1, dim)


def rewards_to_go(rew: torch.Tensor, valid: torch.Tensor, gamma: float) -> torch.Tensor:
    """Masked discounted rewards-to-go over time axis -1 of ``[..., T]``.

    Padding steps (valid == 0) contribute nothing and receive 0.
    """
    return discount_cumsum(rew * valid, gamma) * valid


def gae_advantages(
    rew: torch.Tensor,
    val: torch.Tensor,
    valid: torch.Tensor,
    gamma: float,
    lam: float,
    last_val: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """GAE-λ advantages + return targets on padded ``[..., T]`` tensors.

    ``val`` are the critic values stored at sample time; ``last_val``
    bootstraps truncated episodes (0 for terminal). Returns ``(adv, ret)``,
    both zeroed on padding; ``ret`` are the rewards-to-go.
    """
    rew = rew * valid
    val = val * valid
    if last_val is None:
        last_val = torch.zeros(rew.shape[:-1], dtype=rew.dtype, device=rew.device)
    # v_{t+1}: shift left. At the final valid step the padded successor is
    # 0, so the bootstrap goes in at that index instead.
    val_next = torch.cat([val[..., 1:], last_val[..., None]], dim=-1)
    lengths = valid.sum(dim=-1).to(torch.int64)
    t_idx = torch.arange(rew.shape[-1], device=rew.device)
    is_last = (t_idx == (lengths[..., None] - 1)) & (valid > 0)
    val_next = torch.where(is_last, last_val[..., None], val_next)

    delta = (rew + gamma * val_next - val) * valid
    adv = discount_cumsum(delta, gamma * lam) * valid
    ret = rewards_to_go(rew, valid, gamma)
    return adv, ret


def masked_mean_std(x: torch.Tensor, valid: torch.Tensor, eps: float = 1e-8):
    """Mean/std over valid entries only."""
    count = valid.sum().clamp_min(1.0)
    mean = (x * valid).sum() / count
    var = ((x - mean).square() * valid).sum() / count
    return mean, torch.sqrt(var + eps)


def normalize_advantages(adv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Advantage normalization over the valid set."""
    mean, std = masked_mean_std(adv, valid)
    return (adv - mean) / std * valid
