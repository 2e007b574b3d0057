"""Utilities: the epoch logger."""

from relayrl_tpu_torch.utils.logger import (
    EpochLogger,
    Logger,
    colorize,
    setup_logger_kwargs,
    statistics_scalar,
)

__all__ = [
    "EpochLogger",
    "Logger",
    "colorize",
    "setup_logger_kwargs",
    "statistics_scalar",
]
