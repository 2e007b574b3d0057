"""Algorithm plugin contract.

Counterpart of :mod:`relayrl_tpu.algorithms.base`: the registry
(``register_algorithm``, ``build_algorithm``, ``registered_algorithms``),
``anchor_path`` and the part of ``AlgorithmBase`` the on-policy family
uses: the reference contract (``receive_trajectory -> bool``,
``train_model``, ``save``, ``log_epoch``, ``bundle``, ``version``), the
ingest finite guard with its drop counter, and the training server's half:
the in-flight dispatch window (``inflight``), ``dispatched_version``,
``force_version``, ``snapshot_for_publish``, ``capture_epoch_stats``,
``stage_batch``, ``reset_ingest_buffers``, ``checkpoint_aux`` /
``restore_aux`` and ``warmup``; and the guardrail probe hooks
(``_guard_probe_tree``, ``_guard_pre_update``, ``_guard_merge_probes``)
that ``train_on_batch`` calls around each update once the server's
guardrails attach :class:`~relayrl_tpu_torch.guardrails.GuardProbes`.

The version is a host-side integer bumped at dispatch, so reading it never
waits on the device (the JAX package keeps a host mirror of its device
step for the same reason). An eager update compiles nothing, so
``warmup`` returns 0; a CUDA-graph capture per bucket would live there,
and :meth:`AlgorithmBase._warmup_is_collective` keeps it from running
solo once the update is a collective over processes. The families' mesh
hooks (``enable_multihost``, ``mh_zero_batch``) live in
:mod:`relayrl_tpu_torch.algorithms.onpolicy` and
:mod:`relayrl_tpu_torch.algorithms.offpolicy`.
"""

from __future__ import annotations

import abc
import os
from typing import Any, Callable, Mapping, Sequence

import torch

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

    # The per-algorithm finite guard's enable flag. The guardrail plane
    # (relayrl_tpu_torch/guardrails) sets it False ONLY in the
    # observe-only "warn" validation mode: the plane then owns the
    # boundary, and this belt must stand down or warn mode silently
    # re-enforces.
    ingest_finite_guard = True

    # Divergence-watchdog probe source (guardrails/watchdog.GuardProbes),
    # installed by Guardrails.attach_algorithm; None = no probes, the
    # dispatch path pays one identity check.
    _guard_probes = None

    # Bounded async-dispatch window (runtime/pipeline.InflightWindow):
    # how many updates may be dispatched-but-unfenced. 0 fences every
    # dispatch.
    max_inflight_updates = 2
    _inflight = None

    # The mesh enable_multihost ran the update over (None: one device).
    _mesh = None

    def _drop_nonfinite(self) -> None:
        """Count + log one trajectory rejected by the finite-value guard (a
        NaN/inf would not crash; it would silently poison the learner
        state and, through the next publish, the fleet)."""
        self.dropped_nonfinite += 1
        print(f"[{self.ALGO_NAME}] dropped non-finite trajectory "
              f"(#{self.dropped_nonfinite})", flush=True)

    # -- divergence-watchdog probes (guardrails plane) --
    def _guard_probe_tree(self):
        """The param tree the health probes observe: ``state.params`` (the
        on-policy and value families' one params module), else every
        ``*_params`` field but the ``target_*`` ones (the actor-critic
        families; a target is a polyak copy of what is already probed),
        else the whole state."""
        params = getattr(self.state, "params", None)
        if params is not None:
            return params
        fields = getattr(type(self.state), "__dataclass_fields__", {})
        tree = {name: getattr(self.state, name) for name in fields
                if name.endswith("_params") and not name.startswith("target_")}
        return tree or self.state

    def _guard_pre_update(self):
        """A device copy of the probe target, queued BEFORE the update
        moves the params in place (the update-norm probe's base). None
        when probes are off — one identity check. A probe failure
        DISABLES the probes (logged once) instead of propagating: the
        guardrail plane must never break the learner it protects."""
        probes = self._guard_probes
        if probes is None:
            return None
        try:
            return probes.pre_update(self._guard_probe_tree())
        except Exception as e:
            self._guard_probes = None
            print(f"[guardrails] health probes DISABLED "
                  f"(pre-update probe failed: {e!r})", flush=True)
            return None

    def _guard_merge_probes(self, metrics, old_copy) -> Mapping[str, Any]:
        """Merge the post-update probe scalars (0-d device tensors) into
        ``metrics``; pass-through when probes are off. The merged dict
        rides the in-flight window and LazyMetrics exactly like the
        update's own metrics — read at the fence, never on the dispatch
        path."""
        probes = self._guard_probes
        if probes is None:
            return metrics
        merged = dict(metrics)
        try:
            merged.update(probes.post_update(old_copy,
                                             self._guard_probe_tree()))
        except Exception as e:
            self._guard_probes = None
            print(f"[guardrails] health probes DISABLED "
                  f"(post-update probe failed: {e!r})", flush=True)
            return metrics
        return merged

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

    # -- the training server's half --
    def _warmup_is_collective(self) -> bool:
        """True when the update is a collective over several processes
        (``enable_multihost`` on a mesh that spans them): a warmup run on
        one process alone would hang the others, so ``warmup`` refuses."""
        return self._mesh is not None and self._mesh.process_count > 1

    def warmup(self, should_continue=None) -> int:
        """Pre-build the update for the batch shapes the first epochs can
        hit; returns the number of shapes prepared. An eager update has
        nothing to build, so this returns 0 (the server calls it where
        the JAX package compiles, ahead of the first batch), as it does
        when the update is collective (:meth:`_warmup_is_collective`)."""
        return 0

    def checkpoint_aux(self):
        """Host-side arrays to persist beside the train state, or None
        (on-policy: an epoch buffer refills within one epoch)."""
        return None

    def restore_aux(self, aux) -> None:
        """Apply a previously saved :meth:`checkpoint_aux` payload."""

    @property
    def inflight(self):
        """The dispatched-but-unfenced update window, created lazily."""
        if self._inflight is None:
            from relayrl_tpu_torch.runtime.pipeline import InflightWindow

            self._inflight = InflightWindow(self.max_inflight_updates)
        return self._inflight

    def force_version(self, version: int) -> None:
        """Fast-forward the model version past a rolled-back line of
        history, so swap gates and checkpoint step numbers stay
        monotonic."""
        self.state.step = int(version)

    def reset_ingest_buffers(self) -> None:
        """Drop partially accumulated host-side ingest state (base:
        nothing to drop)."""

    @property
    def dispatched_version(self) -> int:
        """Model version including dispatched-but-unfenced updates — what
        an async publish stamps on its snapshot. The port's version is a
        host counter bumped at dispatch, so this is :attr:`version`."""
        return int(self.version)

    def _publish_module(self) -> torch.nn.Module:
        """The params module a published bundle carries."""
        return self.state.params

    def _publish_arch(self) -> dict:
        return self.arch

    def snapshot_for_publish(self):
        """Cheap publish handoff: a device clone of the params, queued on
        the learner's stream behind every dispatched update, and an event
        recorded after it. The optimizer moves the live params in place,
        so the clone is what keeps a publish from tearing across two
        versions; the publisher thread waits on the event before its
        device-to-host read (:meth:`PublishSnapshot.host_params`)."""
        from relayrl_tpu_torch.runtime.pipeline import (
            PublishSnapshot,
            record_event,
        )
        from relayrl_tpu_torch.weights import logical_state, state_to_jax

        module = self._publish_module()
        with torch.no_grad():
            # A placed module's split parameters gather whole here, on
            # the learner's stream behind the dispatched updates (from
            # every rank, a collective, where a split crosses processes).
            state = {k: v.clone() for k, v in logical_state(module).items()}
        return PublishSnapshot(
            version=self.dispatched_version, arch=self._publish_arch(),
            state=state, event=record_event(self.device),
            to_host=lambda host: state_to_jax(module, host))

    def capture_epoch_stats(self, updated: bool):
        """Snapshot-and-reset the host counters an epoch log needs, at
        dispatch time; returns the payload for ``log_epoch(stats=...)``,
        or None when no log is due."""
        return None

    def stage_batch(self, host_batch) -> dict:
        """Move an assembled host batch to the device ahead of dispatch;
        :meth:`_to_device` passes device tensors through, so a staged
        batch and a host batch are interchangeable downstream."""
        return self._to_device(host_batch)

    def _to_device(self, host_batch) -> dict[str, torch.Tensor]:
        """The one host-to-device move of a batch."""
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in host_batch.items()}
