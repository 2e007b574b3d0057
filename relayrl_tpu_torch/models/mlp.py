"""Categorical-policy helpers shared by the policy families.

Counterpart of the helpers in :mod:`relayrl_tpu.models.mlp`; the MLP
families themselves are not ported yet.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

# Large negative fill for invalid actions: `where` with a finite fill keeps
# softmax and its gradient NaN-free in bf16.
_MASK_FILL = -1e9


def _categorical_logp(logits: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    logp_all = torch.log_softmax(logits, dim=-1)
    return logp_all.gather(-1, act[..., None].long()).squeeze(-1)


def _categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp_all = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp_all)
    return -torch.where(p > 0, p * logp_all, 0.0).sum(dim=-1)


def _categorical_sample(generator: torch.Generator,
                        logits: torch.Tensor) -> torch.Tensor:
    """Gumbel-max draw over the last axis (the construction
    ``jax.random.categorical`` uses), from ``generator``'s stream. Returns
    int64 indices."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _compute_dtype(arch: Mapping[str, Any]) -> torch.dtype:
    name = arch.get("precision", "float32")
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
