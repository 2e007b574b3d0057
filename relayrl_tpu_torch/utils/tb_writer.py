"""TensorBoard writer tailing ``progress.txt``.

Capability parity with the reference's TensorboardWriter subprocess
(reference: relayrl_framework/src/native/python/training_tensorboard.py:
18-265 — tails the newest progress.txt with pandas, validates configured
``scalar_tags`` against the TSV header, writes scalars into a
``tb_<algo>_<timestamp>`` directory next to the progress file, optionally
shells out ``tensorboard --logdir`` on first write; config keys
default_config.json:39-45).

Re-designed in-process: the reference spawns a subprocess whose CLI args are
never actually passed (python_training_tensorboard.rs:24-30 — the writer
runs unconfigured); here the training server owns a writer object and calls
``poll()`` after each epoch — no subprocess, no file-watch races, same
progress.txt compatibility.

A copy of :mod:`relayrl_tpu.utils.tb_writer`; ``tensorboardX`` is imported
when the first row is written.
"""

from __future__ import annotations

import os
import os.path as osp
import time


class TensorboardWriter:
    def __init__(
        self,
        progress_path: str,
        scalar_tags: str | list[str] = "AverageEpRet;LossPi",
        global_step_tag: str = "Epoch",
        logdir: str | None = None,
        launch_tb_on_startup: bool = False,
    ):
        self.progress_path = progress_path
        if isinstance(scalar_tags, str):
            scalar_tags = [t for t in scalar_tags.split(";") if t]
        self.scalar_tags = list(scalar_tags)
        self.global_step_tag = global_step_tag
        self.logdir = logdir or osp.join(
            osp.dirname(progress_path) or ".", f"tb_{int(time.time())}")
        self._writer = None
        self._rows_consumed = 0
        self._header: list[str] | None = None
        self._warned_missing: set[str] = set()
        self._launch = launch_tb_on_startup
        self._tb_proc = None

    @classmethod
    def from_logger(cls, logger, tb_params: dict) -> "TensorboardWriter":
        return cls(
            progress_path=osp.join(logger.output_dir, "progress.txt"),
            scalar_tags=tb_params.get("scalar_tags", "AverageEpRet;LossPi"),
            global_step_tag=tb_params.get("global_step_tag", "Epoch"),
            launch_tb_on_startup=bool(tb_params.get("launch_tb_on_startup", False)),
        )

    def _ensure_writer(self):
        if self._writer is None:
            from tensorboardX import SummaryWriter

            os.makedirs(self.logdir, exist_ok=True)
            self._writer = SummaryWriter(self.logdir)
            if self._launch:
                self._launch_tensorboard()
        return self._writer

    def _launch_tensorboard(self):
        """Best-effort ``tensorboard --logdir`` spawn (ref behavior,
        training_tensorboard.py:268-287)."""
        import shutil
        import subprocess

        exe = shutil.which("tensorboard")
        if exe is None:
            return
        try:
            self._tb_proc = subprocess.Popen(
                [exe, "--logdir", osp.dirname(self.logdir) or "."],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        except OSError:
            self._tb_proc = None

    def poll(self) -> int:
        """Consume new progress.txt rows → TB scalars. Returns rows written."""
        if not osp.isfile(self.progress_path):
            return 0
        with open(self.progress_path, "r") as f:
            lines = f.read().splitlines()
        if not lines:
            return 0
        header = lines[0].split("\t")
        if self._header != header:
            self._header = header
            self._rows_consumed = 0
            for tag in self.scalar_tags:
                if tag not in header and tag not in self._warned_missing:
                    self._warned_missing.add(tag)
                    print(f"[TensorboardWriter] tag {tag!r} not in progress.txt "
                          f"header {header}", flush=True)
        rows = lines[1 + self._rows_consumed:]
        written = 0
        writer = self._ensure_writer()
        col = {name: i for i, name in enumerate(header)}
        step_idx = col.get(self.global_step_tag)
        for row in rows:
            vals = row.split("\t")
            if len(vals) != len(header):
                continue
            try:
                step = int(float(vals[step_idx])) if step_idx is not None else (
                    self._rows_consumed + written)
            except ValueError:
                continue
            for tag in self.scalar_tags:
                i = col.get(tag)
                if i is None:
                    continue
                try:
                    writer.add_scalar(tag, float(vals[i]), step)
                except ValueError:
                    continue
            written += 1
        self._rows_consumed += len(rows)
        if written:
            writer.flush()
        return written

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._tb_proc is not None:
            self._tb_proc.terminate()
            self._tb_proc = None
