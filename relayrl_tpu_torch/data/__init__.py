"""Host-side data staging: padding, bucketing, epoch buffers."""

from relayrl_tpu_torch.data.batching import (
    BatchStaging,
    PaddedTrajectory,
    TrajectoryBatch,
    fold_trailing_markers,
    pad_trajectory,
    pick_bucket,
    repad_trajectory,
    stack_trajectories,
)
from relayrl_tpu_torch.data.replay_buffer import DEFAULT_BUCKETS, EpochBuffer

__all__ = [
    "BatchStaging",
    "PaddedTrajectory",
    "TrajectoryBatch",
    "fold_trailing_markers",
    "pad_trajectory",
    "pick_bucket",
    "repad_trajectory",
    "stack_trajectories",
    "EpochBuffer",
    "DEFAULT_BUCKETS",
]
