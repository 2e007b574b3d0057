"""Algorithm plugin contract.

Counterpart of :mod:`relayrl_tpu.algorithms.base`: the registry
(``register_algorithm``, ``build_algorithm``, ``registered_algorithms``),
``anchor_path`` and the part of ``AlgorithmBase`` the on-policy family
uses: the reference contract (``receive_trajectory -> bool``,
``train_model``, ``save``, ``log_epoch``, ``bundle``, ``version``) and the
ingest finite guard with its drop counter.

Not ported yet: the guardrail probes, the in-flight dispatch window
(``runtime/pipeline.py``), warmup and the multi-host hooks. The port's
update runs synchronously: ``train_on_batch`` returns after the update has
been issued, and its metrics stay on the device until read.
"""

from __future__ import annotations

import abc
import os
from typing import Any, Callable, Mapping, Sequence

from relayrl_tpu_torch.types.action import ActionRecord
from relayrl_tpu_torch.types.model_bundle import ModelBundle

_ALGO_REGISTRY: dict[str, Callable[..., "AlgorithmBase"]] = {}


def register_algorithm(name: str):
    def deco(cls):
        _ALGO_REGISTRY[name.upper()] = cls
        return cls
    return deco


def build_algorithm(name: str, **kwargs) -> "AlgorithmBase":
    try:
        cls = _ALGO_REGISTRY[name.upper()]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; registered: {sorted(_ALGO_REGISTRY)}"
        ) from None
    return cls(**kwargs)


def registered_algorithms() -> list[str]:
    return sorted(_ALGO_REGISTRY)


def anchor_path(path: str, env_dir: str | None) -> str:
    """Anchor a relative artifact path (model file, checkpoint dir) under
    ``env_dir`` so default-named run artifacts land in the run's directory
    instead of the caller's cwd. Absolute paths pass through untouched."""
    if env_dir and not os.path.isabs(path):
        return os.path.join(env_dir, path)
    return path


class AlgorithmBase(abc.ABC):
    """Host-side orchestration around an update on the device."""

    # Trajectories rejected by the ingest finite-value guard
    # (types/columnar.py trajectory_is_finite); class default so the
    # first increment materializes the instance counter.
    dropped_nonfinite = 0

    def _drop_nonfinite(self) -> None:
        """Count + log one trajectory rejected by the finite-value guard (a
        NaN/inf would not crash; it would silently poison the learner
        state and, through the next publish, the fleet)."""
        self.dropped_nonfinite += 1
        print(f"[{self.ALGO_NAME}] dropped non-finite trajectory "
              f"(#{self.dropped_nonfinite})", flush=True)

    # -- reference contract --
    @abc.abstractmethod
    def receive_trajectory(self, actions: Sequence[ActionRecord]) -> bool:
        """Ingest one episode; returns True when a train step ran (the
        training server publishes a new model on True)."""

    @abc.abstractmethod
    def train_model(self) -> Mapping[str, Any]:
        """Run one epoch update; returns metrics."""

    @abc.abstractmethod
    def save(self, path) -> None:
        """Write the distributable model artifact."""

    @abc.abstractmethod
    def log_epoch(self) -> None:
        """Dump the epoch's tabular diagnostics."""

    @abc.abstractmethod
    def bundle(self) -> ModelBundle:
        """Current policy as a versioned transportable bundle."""

    @property
    @abc.abstractmethod
    def version(self) -> int:
        """Monotonic model version (bumped once per train step)."""
