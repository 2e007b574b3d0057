"""Numerical ops: GAE and V-trace on padded batches, attention (plain
tensor versions and the CUDA flash kernels)."""

from relayrl_tpu_torch.ops.gae import (
    discount_cumsum,
    gae_advantages,
    masked_mean_std,
    normalize_advantages,
    rewards_to_go,
)
from relayrl_tpu_torch.ops.vtrace import VTraceReturns, vtrace

__all__ = [
    "discount_cumsum",
    "gae_advantages",
    "masked_mean_std",
    "normalize_advantages",
    "rewards_to_go",
    "VTraceReturns",
    "vtrace",
]
