"""Plotting utilities for progress.txt datasets.

Capability parity with the reference's plot module
(reference: relayrl_framework/src/native/python/utils/plot.py — dataset
discovery over log directories at :90-119 (``get_newest_dataset`` feeds the
TB writer), smoothing + multi-run seaborn plots at :229-306). Implemented on
pandas + matplotlib (no seaborn dependency) against the same TSV layout.

A copy of :mod:`relayrl_tpu.utils.plot`, with ``pandas`` and ``matplotlib``
imported inside the functions that use them (not every machine the port
runs on has them).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Sequence

import numpy as np


def find_progress_files(logdir: str) -> list[str]:
    """All progress.txt files under a log root (newest last)."""
    hits = []
    for root, _, files in os.walk(logdir):
        if "progress.txt" in files:
            hits.append(osp.join(root, "progress.txt"))
    return sorted(hits, key=osp.getmtime)


def get_newest_dataset(logdir: str) -> pd.DataFrame | None:
    """Most recently modified run's progress table (ref: plot.py:90-119)."""
    files = find_progress_files(logdir)
    if not files:
        return None
    return load_dataset(files[-1])


def load_dataset(progress_path: str,
                 condition: str | None = None) -> pd.DataFrame:
    import pandas as pd

    df = pd.read_csv(progress_path, sep="\t")
    df["Condition"] = condition or osp.basename(osp.dirname(progress_path))
    return df


def smooth_series(values, radius: int = 10) -> np.ndarray:
    """Symmetric moving average (the reference's smoothing behavior)."""
    values = np.asarray(values, dtype=np.float64)
    if radius <= 0 or len(values) < 2:
        return values
    kernel = np.ones(2 * radius + 1)
    padded = np.concatenate(
        [np.full(radius, values[0]), values, np.full(radius, values[-1])])
    return np.convolve(padded, kernel / kernel.sum(), mode="valid")


def plot_progress(
    logdirs: Sequence[str] | str,
    value: str = "AverageEpRet",
    x: str = "Epoch",
    smooth: int = 1,
    out_path: str | None = None,
    show: bool = False,
):
    """Plot one metric across runs; returns the matplotlib figure."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(logdirs, str):
        logdirs = [logdirs]
    fig, ax = plt.subplots(figsize=(8, 5))
    plotted = 0
    for logdir in logdirs:
        for path in find_progress_files(logdir):
            df = load_dataset(path)
            if value not in df.columns or x not in df.columns:
                continue
            ax.plot(df[x], smooth_series(df[value], smooth),
                    label=str(df["Condition"].iloc[0]))
            plotted += 1
    if plotted == 0:
        raise ValueError(f"no runs with columns ({x}, {value}) under {logdirs}")
    ax.set_xlabel(x)
    ax.set_ylabel(value)
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
    if show:  # pragma: no cover
        plt.show()
    return fig
