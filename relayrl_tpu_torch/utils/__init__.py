"""Observability and misc utilities: the epoch logger and the profiler
hooks (``tb_writer``, ``plot``, ``hostpin`` and ``instrument`` are imported
by name)."""

from relayrl_tpu_torch.utils.logger import (
    EpochLogger,
    Logger,
    colorize,
    setup_logger_kwargs,
    statistics_scalar,
)
from relayrl_tpu_torch.utils.profiling import (
    annotate,
    start_trace_server,
    timed,
    trace,
)

__all__ = [
    "EpochLogger",
    "Logger",
    "colorize",
    "setup_logger_kwargs",
    "statistics_scalar",
    "annotate",
    "start_trace_server",
    "timed",
    "trace",
]
