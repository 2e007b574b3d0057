"""Shared host-side orchestration for the on-policy algorithm family.

Counterpart of :mod:`relayrl_tpu.algorithms.onpolicy`: episodes stream into
an :class:`~relayrl_tpu_torch.data.EpochBuffer`, every full epoch drains
into one update on the device, and ``receive_trajectory -> True`` is the
publish signal. Subclasses implement ``_setup`` (arch, policy, state and
the ``(state, batch) -> (state, metrics)`` update) and ``_log_keys``.

A drained batch moves to the device once (in
:meth:`OnPolicyAlgorithm.train_on_batch`, or earlier through
``stage_batch``). The update returns once its kernels are queued: its
metrics come back as a :class:`~relayrl_tpu_torch.runtime.pipeline.
LazyMetrics` read in one device-to-host copy, and the in-flight window
(``learner.max_inflight_updates``) bounds how far dispatch runs ahead of
the device, fencing on the CUDA event recorded after each update. The
epoch buffer's staging slabs are reused after ``window + 1`` drains, by
which time the update that read a slab has been fenced.

``enable_multihost(mesh)`` runs the update over a mesh
(:mod:`relayrl_tpu_torch.parallel.learner`): the state placed by the
sharding rules, the optimizers rebuilt over the shard leaves, each batch
placed and checked. The publish path, the checkpoint and the guardrail
probes read the whole parameters (:func:`relayrl_tpu_torch.weights.
logical_state`). When the mesh's ``dp`` or ``fsdp`` axis spans processes
(:mod:`relayrl_tpu_torch.parallel.distributed`), the server's broadcast
loop ships each epoch batch from the coordinator (non-coordinators feed
the broadcast ``mh_zero_batch``), every process trains on its rows with
its gradients and batch statistics summed over the group, and every
process holds the same parameters after each update (its own shards of
them where fsdp, ep or tp crosses, its own pipeline stages where pp
does: :meth:`bundle`, the publish snapshot, the checkpoint and the probes
then gather, and every process calls them in the same order).
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from relayrl_tpu_torch.algorithms.base import AlgorithmBase, anchor_path
from relayrl_tpu_torch.config import ConfigLoader
from relayrl_tpu_torch.data import EpochBuffer
from relayrl_tpu_torch.models import resolve_device
from relayrl_tpu_torch.runtime.pipeline import LazyMetrics, record_event
from relayrl_tpu_torch.types.columnar import (
    DecodedTrajectory,
    trajectory_is_finite,
)
from relayrl_tpu_torch.types.model_bundle import ModelBundle
from relayrl_tpu_torch.utils import EpochLogger, setup_logger_kwargs
from relayrl_tpu_torch.weights import params_to_jax


def read_metrics(metrics: Mapping[str, Any]) -> dict[str, float]:
    """0-d device metrics -> floats, in one device-to-host transfer."""
    if not metrics:
        return {}
    if isinstance(metrics, LazyMetrics):
        return dict(metrics.resolve())
    values = torch.stack([torch.as_tensor(v).float().reshape(())
                          for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


class OnPolicyAlgorithm(AlgorithmBase):
    """Epoch-buffer learner loop of the on-policy family.

    ``device`` defaults to the GPU; without one the caller must pass
    ``device="cpu"``. Seeds: the initial weights are drawn from a CPU
    ``torch.Generator`` seeded by ``seed`` and ``seed_salt`` (the process
    id unless given), as the JAX package folds the salt into its key.
    """

    ALGO_NAME = "ONPOLICY"  # subclasses override

    def __init__(
        self,
        env_dir: str | None = None,
        config_path: str | None = None,
        obs_dim: int = 4,
        act_dim: int = 2,
        buf_size: int | None = None,
        logger_kwargs: Mapping[str, Any] | None = None,
        device=None,
        **overrides,
    ):
        loader = ConfigLoader(self.ALGO_NAME, config_path,
                              create_if_missing=False)
        params = loader.get_algorithm_params()
        params.update(overrides)
        learner = loader.get_learner_params()

        self.device = resolve_device(device)
        self.obs_dim, self.act_dim = int(obs_dim), int(act_dim)
        self.discrete = bool(params.get("discrete", True))
        self.traj_per_epoch = int(params.get("traj_per_epoch", 8))
        self.gamma = float(params.get("gamma", 0.99))
        seed = int(params.get("seed", 1))
        salt = int(params.get("seed_salt", os.getpid()))
        generator = torch.Generator().manual_seed(int(
            np.random.SeedSequence([seed, salt]).generate_state(1, np.uint64)[0]))

        # Subclass: sets self.arch, self.policy, self.state, self._update.
        self._setup(params, learner, generator)

        # Async-dispatch window (runtime/pipeline): how many updates may
        # be dispatched-but-unfenced. 0 = fence every dispatch.
        self.max_inflight_updates = int(params.get(
            "max_inflight_updates",
            learner.get("max_inflight_updates", 2)))

        self.buffer = EpochBuffer(
            obs_dim=self.obs_dim,
            act_dim=self.act_dim,
            traj_per_epoch=self.traj_per_epoch,
            discrete=self.discrete,
            buckets=params.get(
                "bucket_lengths",
                learner.get("bucket_lengths", (64, 256, 1000))),
            max_traj_length=loader.get_max_traj_length(),
            staging_slots=self.max_inflight_updates + 1,
        )

        lk = dict(logger_kwargs) if logger_kwargs else setup_logger_kwargs(
            f"relayrl-{self.ALGO_NAME.lower()}", seed,
            data_dir=os.path.join(env_dir or ".", "logs"))
        self.logger = EpochLogger(**lk)
        self.logger.save_config({"algorithm": self.ALGO_NAME, **params,
                                 "obs_dim": obs_dim, "act_dim": act_dim})
        self.epoch = 0
        self._last_metrics: Mapping[str, torch.Tensor] = {}
        self.server_model_path = anchor_path(
            loader.get_server_model_path(), env_dir)

    # -- subclass contract --
    def _setup(self, params: dict, learner: dict,
               generator: torch.Generator) -> None:
        raise NotImplementedError

    def _resolve_freeze(self, params: dict, learner: dict,
                        module) -> tuple[str, ...]:
        """The ``learner.freeze`` knob (per-algorithm ``freeze`` override
        wins): validated regex patterns over flax leaf paths. Records
        ``self.freeze_info``, the JAX package's accounting."""
        from relayrl_tpu_torch.algorithms.freeze import (
            freeze_info,
            normalize_freeze_spec,
        )

        patterns = normalize_freeze_spec(
            params.get("freeze", learner.get("freeze")))
        if not patterns:
            return ()
        self.freeze_info = freeze_info(module, patterns)
        if self.freeze_info["frozen_leaves"] == 0:
            import warnings

            warnings.warn(
                f"learner.freeze patterns {list(patterns)} matched no "
                f"param leaves — check them against e.g. "
                f"'params/block_0/qkv/kernel' style paths")
        print(f"[{self.ALGO_NAME}] learner.freeze: "
              f"{self.freeze_info['frozen_leaves']}/"
              f"{self.freeze_info['total_leaves']} leaves frozen "
              f"({self.freeze_info['frozen_bytes']} bytes) by "
              f"{list(patterns)}", flush=True)
        return patterns

    def _log_keys(self) -> Sequence[str]:
        return ("LossPi",)

    # -- reference contract --
    def receive_trajectory(self, actions) -> bool:
        """Buffer one episode (a sequence of ``ActionRecord``); at a full
        epoch, train and log. Returns True when an update ran."""
        batch = self.accumulate(actions)
        if batch is None:
            return False
        self.train_on_batch(batch)
        self.log_epoch()
        return True

    def accumulate(self, item):
        """Buffer one trajectory without training; returns the drained
        epoch batch dict when the buffer fills, else None. Takes a
        sequence of ``ActionRecord`` or a columnar ``DecodedTrajectory``.
        Marker-only trajectories carry no steps and are skipped;
        non-finite ones are dropped and counted."""
        if isinstance(item, DecodedTrajectory):
            if item.n_steps == 0:
                return None
        elif not item or all(a.act is None for a in item):
            return None
        if self.ingest_finite_guard and not trajectory_is_finite(item):
            self._drop_nonfinite()
            return None
        if self.buffer.add_episode(item):
            return self.buffer.drain().as_dict()
        return None

    def train_on_batch(self, host_batch: Mapping[str, Any]) -> LazyMetrics:
        """One update on an assembled batch dict (host arrays or device
        tensors). Returns once the update is queued: its metrics come back
        as a :class:`LazyMetrics`, and the update enters the in-flight
        window with the CUDA event recorded after it. With guardrail
        probes attached, the probe target is copied before the update and
        probed after it; the probe scalars join the metrics (and so the
        same event and the same one device-to-host read)."""
        probe_base = self._guard_pre_update()
        self.state, metrics = self._update(self.state,
                                           self._to_device(host_batch))
        metrics = self._guard_merge_probes(metrics, probe_base)
        self._last_metrics = LazyMetrics(metrics)
        self.inflight.push(self._last_metrics, record_event(self.device),
                           version=self.dispatched_version)
        return self._last_metrics

    def train_model(self) -> Mapping[str, torch.Tensor]:
        return self.train_on_batch(self.buffer.drain().as_dict())

    def maybe_log_epoch(self) -> None:
        # One update == one epoch for the on-policy family.
        self.log_epoch()

    def reset_ingest_buffers(self) -> None:
        """A rolled-back stream may have part-filled the epoch buffer;
        those episodes belong to the rolled-back line."""
        self.buffer.reset()

    def capture_epoch_stats(self, updated: bool):
        """One update == one epoch: a log is due exactly when an update
        dispatched. Pops the episode stats now, so episodes arriving
        while the update is in flight land in the next epoch's row."""
        if not updated:
            return None
        return self.buffer.pop_episode_stats()

    def log_epoch(self, stats=None, metrics=None) -> None:
        """One row of the epoch log. ``stats``/``metrics`` are deferred
        :meth:`capture_epoch_stats` payloads (the pipelined server logs
        an epoch after its update's fence); without them the episode
        stats pop here and the latest metrics apply. Reading the metrics
        is one device-to-host transfer."""
        rets, lens = (self.buffer.pop_episode_stats() if stats is None
                      else stats)
        values = read_metrics(self._last_metrics if metrics is None
                              else metrics)
        self.epoch += 1
        self.logger.store(EpRet=rets or [0.0], EpLen=lens or [0])
        self.logger.log_tabular("Epoch", self.epoch)
        self.logger.log_tabular("EpRet", with_min_and_max=True)
        self.logger.log_tabular("EpLen", average_only=True)
        for key in self._log_keys():
            self.logger.log_tabular(key, values.get(key, 0.0))
        self.logger.dump_tabular()

    def mh_zero_batch(self, b: int, t: int) -> dict:
        """Placeholder epoch batch (shape and dtype only): what a
        non-coordinator feeds the batch broadcast, and a warm-up batch."""
        from relayrl_tpu_torch.data.batching import TrajectoryBatch

        return TrajectoryBatch.zeros(b, t, self.obs_dim, self.act_dim,
                                     self.discrete)

    def enable_multihost(self, mesh) -> None:
        """Run the update over ``mesh``. Call once, on every process, right
        after construction (identical seeds give identical initial state;
        see the server's ``seed_salt``): the update becomes
        :func:`make_sharded_update`'s (the mesh ambient around it, each
        batch placed and its splits checked), and :func:`place_state`
        places the state by the sharding rules and rebuilds its optimizers
        over the shard leaves, any Adam moments split with their
        parameters. Over several processes the server's broadcast loop
        queues assembled batches (``_mh_ready``) for an unbounded time, so
        the epoch buffer's staging slabs are off (each drain copies), and
        the in-flight window is rebuilt over the same bound."""
        from relayrl_tpu_torch.parallel import make_sharded_update, place_state

        self._mesh = mesh
        self._update = make_sharded_update(self._update, mesh, self.state)
        self.state = place_state(self.state, mesh)
        if mesh.process_count > 1:
            self.buffer.disable_staging()
            self._inflight = None

    def save(self, path=None) -> None:
        self.bundle().save(path or self.server_model_path)

    def _publish_module(self):
        return self.state.params

    def bundle(self) -> ModelBundle:
        """The current policy for actors: params as the flax tree of numpy
        arrays, so port and JAX actors both load it (a collective where a
        split of the params, or the pipeline's stages, cross processes)."""
        return ModelBundle(version=self.version, arch=self.arch,
                           params=params_to_jax(self.state.params))

    @property
    def version(self) -> int:
        return int(self.state.step)
