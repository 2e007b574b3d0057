"""Epoch logging: aligned console table + TSV ``progress.txt``.

A copy of :mod:`relayrl_tpu.utils.logger`, so both packages write the same
``progress.txt`` and mirror its rows into the same ``relayrl_epoch_stat``
gauges.

Capability parity with the reference's SpinningUp-lineage logger
(reference: relayrl_framework/src/native/python/utils/logger.py:103-386 —
``store()`` accumulates per-epoch values, ``log_tabular`` computes
mean/std/min/max, ``dump_tabular`` writes an aligned console table plus a TSV
row to ``<output_dir>/progress.txt``; directory layout
``logs/<exp>/<exp>_s<seed>`` at :388-448; ``save_config`` dumps a JSON of the
run config at :171-198).

The TSV column layout is kept byte-compatible (tab-separated, header row
first) so the reference's TensorBoard tailer/plotting workflow applies
unchanged to our output.
"""

from __future__ import annotations

import atexit
import json
import os
import os.path as osp
import time
from typing import Any, Mapping

import numpy as np

_COLOR_CODES = {
    "gray": 30, "red": 31, "green": 32, "yellow": 33,
    "blue": 34, "magenta": 35, "cyan": 36, "white": 37,
}


def colorize(string: str, color: str, bold: bool = False) -> str:
    num = _COLOR_CODES.get(color, 37)
    if bold:
        return f"\x1b[{num};1m{string}\x1b[0m"
    return f"\x1b[{num}m{string}\x1b[0m"


def statistics_scalar(values, with_min_and_max: bool = False):
    """Mean/std(/min/max) of a list of scalars
    (ref: BaseReplayBuffer.statistics_scalar)."""
    arr = np.asarray(values, dtype=np.float32).ravel()
    if arr.size == 0:
        nan = float("nan")
        return (nan, nan, nan, nan) if with_min_and_max else (nan, nan)
    mean = float(arr.mean())
    std = float(arr.std())
    if with_min_and_max:
        return mean, std, float(arr.min()), float(arr.max())
    return mean, std


def setup_logger_kwargs(
    exp_name: str, seed: int | None = None, data_dir: str | None = None
) -> dict[str, Any]:
    """Standard run-directory layout (ref: logger.py:388-448):
    ``<data_dir>/<exp_name>/<exp_name>_s<seed>``."""
    data_dir = data_dir or osp.join(os.getcwd(), "logs")
    relpath = exp_name if seed is None else osp.join(exp_name, f"{exp_name}_s{seed}")
    return {"output_dir": osp.join(data_dir, relpath), "exp_name": exp_name}


class Logger:
    """Tabular logger writing ``progress.txt`` (ref: logger.py:103-296)."""

    def __init__(
        self,
        output_dir: str | None = None,
        output_fname: str = "progress.txt",
        exp_name: str | None = None,
    ):
        self.output_dir = output_dir or f"/tmp/experiments/{int(time.time())}"
        os.makedirs(self.output_dir, exist_ok=True)
        self.output_file = open(osp.join(self.output_dir, output_fname), "a")
        atexit.register(self.output_file.close)
        self.first_row = True
        self.log_headers: list[str] = []
        self.log_current_row: dict[str, Any] = {}
        self.exp_name = exp_name

    def log(self, msg: str, color: str = "green") -> None:
        print(colorize(msg, color, bold=True), flush=True)

    def log_tabular(self, key: str, val: Any) -> None:
        if self.first_row:
            self.log_headers.append(key)
        elif key not in self.log_headers:
            raise KeyError(
                f"new key {key!r} introduced after the first epoch; the TSV "
                "schema is fixed at the first dump_tabular"
            )
        if key in self.log_current_row:
            raise KeyError(f"key {key!r} already logged this epoch")
        self.log_current_row[key] = val

    def save_config(self, config: Mapping[str, Any]) -> None:
        """JSON dump of the run config (ref: logger.py:171-198)."""
        def _default(obj):
            return repr(obj)

        out = dict(config)
        if self.exp_name is not None:
            out["exp_name"] = self.exp_name
        serialized = json.dumps(out, indent=2, sort_keys=True, default=_default)
        with open(osp.join(self.output_dir, "config.json"), "w") as f:
            f.write(serialized)

    def dump_tabular(self) -> None:
        # Console rendering: left-aligned keys dot-padded to the value
        # column, values right-aligned — an original layout; only the TSV
        # half below preserves the reference's progress.txt schema.
        vals = [self.log_current_row.get(key, "") for key in self.log_headers]
        rendered = [
            f"{v:.4g}" if hasattr(v, "__float__") else str(v) for v in vals
        ]
        key_w = max((len(k) for k in self.log_headers), default=0)
        val_w = max((len(s) for s in rendered), default=0)
        lines = [f"epoch {'=' * max(4, key_w + val_w)}"]
        for key, valstr in zip(self.log_headers, rendered):
            pad = "." * (key_w - len(key) + 2)
            lines.append(f"  {key} {pad} {valstr:>{val_w}}")
        print("\n".join(lines), flush=True)
        if self.output_file is not None:
            if self.first_row:
                self.output_file.write("\t".join(self.log_headers) + "\n")
            self.output_file.write("\t".join(map(str, vals)) + "\n")
            self.output_file.flush()
        # The same row mirrors into the telemetry registry as
        # `relayrl_epoch_stat{stat=...}` gauges, so exported epoch metrics
        # never drift from the logged ones. Looked up per dump (epoch
        # cadence) so a registry installed after construction still gets
        # the rows; a NullRegistry makes this a no-op.
        from relayrl_tpu_torch import telemetry

        registry = telemetry.get_registry()
        if registry.enabled:
            for key, val in zip(self.log_headers, vals):
                if hasattr(val, "__float__"):
                    registry.gauge(
                        "relayrl_epoch_stat",
                        "latest epoch-log row value, one child per column",
                        labels={"stat": key}).set(float(val))
        self.log_current_row.clear()
        self.first_row = False


class EpochLogger(Logger):
    """Logger + per-epoch value accumulation (ref: logger.py:299-386)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.epoch_dict: dict[str, list] = {}

    def store(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.epoch_dict.setdefault(k, []).append(v)

    def log_tabular(
        self,
        key: str,
        val: Any = None,
        with_min_and_max: bool = False,
        average_only: bool = False,
    ) -> None:
        if val is not None:
            super().log_tabular(key, val)
        else:
            values = self.epoch_dict.get(key, [])
            stats = statistics_scalar(values, with_min_and_max=with_min_and_max)
            super().log_tabular("Average" + key if not average_only else key, stats[0])
            if not average_only:
                super().log_tabular("Std" + key, stats[1])
            if with_min_and_max:
                super().log_tabular("Max" + key, stats[3])
                super().log_tabular("Min" + key, stats[2])
            self.epoch_dict[key] = []

    def get_stats(self, key: str, with_min_and_max: bool = False):
        return statistics_scalar(self.epoch_dict.get(key, []), with_min_and_max)
