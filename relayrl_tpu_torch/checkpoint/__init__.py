"""Checkpoint/resume (full train state, torch-native saves)."""

from relayrl_tpu_torch.checkpoint.manager import (
    CheckpointManager,
    StepAlreadyExistsError,
    checkpoint_algorithm,
    restore_algorithm,
    restore_latest_healthy,
)

__all__ = ["CheckpointManager", "StepAlreadyExistsError",
           "checkpoint_algorithm", "restore_algorithm",
           "restore_latest_healthy"]
