"""Shared host-side orchestration for the off-policy algorithm family.

Counterpart of :mod:`relayrl_tpu.algorithms.offpolicy`: transitions stream
into a :class:`~relayrl_tpu_torch.data.step_buffer.StepReplayBuffer`, and
after ``update_after`` steps the learner runs gradient updates per
received trajectory (the update-to-data ratio ``updates_per_step``,
bounded per ingest by ``max_updates_per_ingest`` with the backlog carried
as update debt), publishing the actor after each ingest that trained.

Subclasses implement ``_setup`` (arch, policy, the modules, ``self.state``
and ``self._update``) and ``fresh_state`` (a state over given modules with
fresh Adam). An update is one function ``(state, batch, noise) -> (state,
metrics)``: the algorithm draws the noise (TD3's smoothing noise, SAC's
next-action and policy draws) from the generator whose state rides in
``state.rng``, on its device, and passes it in, so a comparison can pass
the JAX update's own draws instead. ``updates_per_dispatch`` K runs K such
updates in one call, a plain loop over the same update (the JAX package's
``lax.scan``): the same kernels in the same order, so fused and unfused
updates are bit-equal. The update reads nothing back to the host: the
version is a host counter, TD3's policy delay reads it, and the metrics
stay 0-d device tensors until the in-flight window fences them.

Not ported: the multi-host hooks (``enable_multihost``, ``mh_zero_batch``)
and the jit warmup (an eager update compiles nothing).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from relayrl_tpu_torch.algorithms.base import AlgorithmBase, anchor_path
from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
from relayrl_tpu_torch.config import ConfigLoader
from relayrl_tpu_torch.data.step_buffer import StepReplayBuffer
from relayrl_tpu_torch.models import resolve_device
from relayrl_tpu_torch.models.q_networks import PIXEL_ARCH_KEYS, conv_trunk_kwargs
from relayrl_tpu_torch.runtime.pipeline import LazyMetrics, record_event
from relayrl_tpu_torch.types.columnar import (
    DecodedTrajectory,
    trajectory_is_finite,
)
from relayrl_tpu_torch.types.model_bundle import ModelBundle
from relayrl_tpu_torch.utils import EpochLogger, setup_logger_kwargs
from relayrl_tpu_torch.weights import params_from_jax, params_to_jax

_MULTIHOST = ("the multi-host learner is not ported (ROADMAP.md queue 1 "
              "item 11); run one process")


def polyak_update(online: nn.Module, target: nn.Module, polyak: float) -> None:
    """target <- polyak * target + (1 - polyak) * online, in place
    (optax's ``incremental_update`` with step size ``1 - polyak``;
    polyak near 1 means slow targets)."""
    step = 1.0 - polyak
    with torch.no_grad():
        targets = list(target.parameters())
        torch._foreach_mul_(targets, 1.0 - step)
        torch._foreach_add_(targets, [p.detach() for p in online.parameters()],
                            alpha=step)


def frozen_copy(module: nn.Module) -> nn.Module:
    """A target network: a copy of ``module`` that takes no gradient."""
    import copy

    target = copy.deepcopy(module)
    target.requires_grad_(False)
    return target


def target_of(modules: Mapping[str, nn.Module], field: str) -> nn.Module:
    """``modules["target_" + field]``, else a frozen copy of
    ``modules[field]`` (a fresh learner's targets start as copies)."""
    target = modules.get(f"target_{field}")
    return frozen_copy(modules[field]) if target is None else target


def draw_normal(rng: torch.Tensor, shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Standard normals of ``shape`` on ``device`` from the generator
    state ``rng``; returns them and the advanced state (a CPU tensor, so
    a checkpoint restores the same stream)."""
    gen = torch.Generator(device=device)
    gen.set_state(rng)
    noise = torch.randn(shape, generator=gen, device=device)
    return noise, gen.get_state()


def seeded_rng(seed: int, stream: int, device) -> torch.Tensor:
    """A generator state on ``device`` from (seed, stream)."""
    gen = torch.Generator(device=device).manual_seed(int(
        np.random.SeedSequence([int(seed), int(stream)])
        .generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return gen.get_state()


class OffPolicyAlgorithm(AlgorithmBase):
    """Transition-replay learner loop shared by DQN/C51/DDPG/TD3/SAC.

    ``device`` defaults to the GPU; without one the caller must pass
    ``device="cpu"``. The initial weights and the update noise are
    deterministic given ``seed``, as in the JAX package.
    """

    ALGO_NAME = "OFFPOLICY"  # subclasses override
    DEFAULT_DISCRETE = True

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
        self.gamma = float(params.get("gamma", 0.99))
        self.polyak = float(params.get("polyak", 0.995))
        self.batch_size = int(params.get("batch_size", 256))
        self.update_after = int(params.get("update_after", 1000))
        self.updates_per_step = float(params.get("updates_per_step", 1.0))
        # Bound on updates per receive_trajectory call: a long episode past
        # warmup owes stored * updates_per_step updates, but running them
        # all inside one ingest call starves the ingest queue and delays
        # the publish. The backlog is carried in ``_update_debt``.
        self.max_updates_per_ingest = int(
            params.get("max_updates_per_ingest", 64))
        if self.max_updates_per_ingest < 1:
            raise ValueError(
                "max_updates_per_ingest must be >= 1 (it bounds the "
                "updates run per ingest call; use updates_per_step=0 to "
                "disable training on ingest)")
        self._update_debt = 0.0
        # Dispatch fusion: K sampled-batch updates in one call.
        self.updates_per_dispatch = max(
            1, int(params.get("updates_per_dispatch", 1)))
        self.max_inflight_updates = int(params.get(
            "max_inflight_updates",
            learner.get("max_inflight_updates", 2)))
        # Sample staging: sampled batches are written into a ring of
        # reusable host buffers (pinned on the GPU, so their host-to-device
        # copies run asynchronously) instead of fresh allocations per draw.
        self._sample_ring: list[dict] = []
        self._sample_slot = 0
        self.traj_per_epoch = int(params.get("traj_per_epoch", 8))
        self.seed = int(params.get("seed", 1))
        self._init_generator = torch.Generator().manual_seed(int(
            np.random.SeedSequence([self.seed]).generate_state(1, np.uint64)[0]
            >> np.uint64(1)))

        self.buffer = StepReplayBuffer(
            obs_dim=self.obs_dim,
            act_dim=self.act_dim,
            capacity=int(buf_size or params.get("buffer_size", 100_000)),
            discrete=bool(params.get("discrete", self.DEFAULT_DISCRETE)),
            seed=self.seed,
            obs_dtype=str(params.get("obs_dtype", "float32")),
        )

        # Subclass: sets self.arch, self.policy, self.state, self._update.
        self._setup(params, learner)

        lk = dict(logger_kwargs) if logger_kwargs else setup_logger_kwargs(
            f"relayrl-{self.ALGO_NAME.lower()}", self.seed,
            data_dir=os.path.join(env_dir or ".", "logs"))
        self.logger = EpochLogger(**lk)
        self.logger.save_config({"algorithm": self.ALGO_NAME, **params,
                                 "obs_dim": obs_dim, "act_dim": act_dim})
        self.epoch = 0
        self._traj_since_log = 0
        self._ep_returns: list[float] = []
        self._ep_lengths: list[int] = []
        self._last_metrics: Mapping[str, Any] = {}
        self.server_model_path = anchor_path(
            loader.get_server_model_path(), env_dir)

    # -- subclass contract --
    def _setup(self, params: dict, learner: dict) -> None:
        raise NotImplementedError

    def fresh_state(self, modules: Mapping[str, nn.Module], rng=None):
        """A train state over ``modules`` (the online networks by state
        field name, and optionally their targets; a missing target is a
        copy of its online network) with fresh Adam at this learner's
        rates and version 0."""
        raise NotImplementedError

    def _actor_module(self) -> nn.Module:
        """The module the registered policy kind applies (the publish)."""
        raise NotImplementedError

    def _metric_keys(self) -> Sequence[str]:
        return ("LossQ",)

    def _draw_noise(self, state):
        """The update's noise and the state with its generator advanced;
        None for the algorithms that draw none."""
        return None, state

    # -- modules across the two packages --
    def load_module(self, field: str, tree, device=None) -> nn.Module:
        """The state field ``field``'s network built from a flax params
        tree, on ``device`` (default: this learner's)."""
        with torch.device("meta"):
            module = self._module_fns[field.removeprefix("target_")]()
        module = module.to_empty(device=device or self.device)
        module.load_state_dict(params_from_jax(tree))
        if field.startswith("target_"):
            module.requires_grad_(False)
        return module

    def state_trees(self, state=None) -> dict[str, Any]:
        """Every network of ``state`` (default: the live one) as a flax
        params tree of numpy arrays, by state field name."""
        state = self.state if state is None else state
        return {f.name: params_to_jax(getattr(state, f.name))
                for f in dataclasses.fields(state)
                if isinstance(getattr(state, f.name), nn.Module)}

    # -- reference contract --
    def receive_trajectory(self, actions) -> bool:
        """Accepts ``Sequence[ActionRecord]`` or a columnar
        ``DecodedTrajectory``. Empty or marker-only trajectories store
        nothing and log no phantom episode."""
        batches = self.accumulate(actions)
        trained = False
        if batches:
            self.train_on_batches(batches)
            trained = True
        if self._traj_since_log >= self.traj_per_epoch:
            self.log_epoch()
        return trained

    def train_model(self) -> Mapping[str, Any]:
        self.train_on_batches([self.buffer.sample(self.batch_size)])
        return self._last_metrics

    def _run_update(self, state, batch):
        noise, state = self._draw_noise(state)
        return self._update(state, batch, noise)

    def _fused_update(self, state, batches):
        """K sequential updates in one call: the unfused loop's updates,
        in its order. Returns the last update's metrics."""
        metrics = None
        for batch in batches:
            state, metrics = self._run_update(state, batch)
        return state, metrics

    def train_on_batches(self, host_batches: Sequence[Mapping[str, Any]]
                         ) -> Mapping[str, Any]:
        """Run the due updates, groups of ``updates_per_dispatch`` as one
        call each (one in-flight entry, its metrics the group's last
        update's); the remainder goes through :meth:`train_on_batch`."""
        k = self.updates_per_dispatch
        i, n = 0, len(host_batches)
        while k > 1 and n - i >= k:
            chunk = [self._to_device(b) for b in host_batches[i:i + k]]
            probe_base = self._guard_pre_update()
            self.state, metrics = self._fused_update(self.state, chunk)
            self._push(metrics, probe_base)
            i += k
        for b in host_batches[i:]:
            self.train_on_batch(b)
        return self._last_metrics

    def train_on_batch(self, host_batch: Mapping[str, Any]) -> Mapping[str, Any]:
        """One update on a sampled transition batch, queued on the device;
        its metrics come back as a :class:`LazyMetrics`."""
        probe_base = self._guard_pre_update()
        self.state, metrics = self._run_update(self.state,
                                               self._to_device(host_batch))
        self._push(metrics, probe_base)
        return self._last_metrics

    def _push(self, metrics, probe_base) -> None:
        metrics = self._guard_merge_probes(metrics, probe_base)
        self._last_metrics = LazyMetrics(metrics)
        self.inflight.push(self._last_metrics, record_event(self.device))

    def _to_device(self, host_batch) -> dict[str, torch.Tensor]:
        """The one host-to-device move of a batch. A staging slot's arrays
        live in pinned memory on the GPU, so their copies are queued
        without waiting (:meth:`_sample_staged` keeps the slot unwritten
        until then); device tensors pass through."""
        out = {}
        for key, value in host_batch.items():
            if isinstance(value, np.ndarray):
                value = torch.from_numpy(value)
            out[key] = torch.as_tensor(value).to(self.device, non_blocking=True)
        return out

    def reset_ingest_buffers(self) -> None:
        """Guardrail rollback: stale-but-finite replay experience is valid
        off-policy data, so the ring is kept (or replaced by the restored
        checkpoint's aux snapshot). But when the ingest finite guard stands
        down (the guardrails' "warn" posture), admitted poison may sit in
        the ring, and every update after the restore would diverge again:
        scrub it."""
        if not self.ingest_finite_guard:
            dropped = self.buffer.scrub_nonfinite()
            if dropped:
                print(f"[guardrails] replay ring scrubbed after rollback: "
                      f"{dropped} non-finite transition(s) dropped",
                      flush=True)

    def accumulate(self, item):
        """Ingest WITHOUT training: store the episode, keep the update-debt
        ledger, and return the list of sampled batches now due (None when
        no update is due: warmup, or ``updates_per_step`` 0)."""
        if isinstance(item, DecodedTrajectory):
            if item.n_steps == 0:
                return None
            rew_total = item.total_reward
        elif not item or all(a.act is None for a in item):
            return None
        else:
            rew_total = float(sum(a.rew for a in item))
        if self.ingest_finite_guard and not trajectory_is_finite(item):
            # A non-finite transition in the ring would be resampled
            # forever.
            self._drop_nonfinite()
            return None
        stored = self.buffer.add_episode(item)
        self._ep_returns.append(rew_total)
        self._ep_lengths.append(stored)
        self._traj_since_log += 1
        if (self.updates_per_step <= 0
                or self.buffer.total_steps < self.update_after
                or stored == 0):
            return None
        self._update_debt += stored * self.updates_per_step
        n = min(self.max_updates_per_ingest, max(1, int(self._update_debt)))
        self._update_debt = max(0.0, self._update_debt - n)
        return [self._sample_staged(n) for _ in range(n)]

    def _new_sample_slot(self) -> dict[str, np.ndarray]:
        """One staging slot shaped like a sample; pinned on the GPU."""
        out = self.buffer.make_sample_out(self.batch_size)
        if self.device.type != "cuda":
            return out
        return {key: torch.from_numpy(arr).pin_memory().numpy()
                for key, arr in out.items()}

    def _sample_staged(self, round_size: int) -> dict:
        """One sampled batch written into a reusable staging slot.

        A slot is rewritten only after ``round + window * k + 1`` further
        draws. Its host-to-device copy is queued on the learner's stream
        before the update that reads it (by ``stage_batch`` or at
        dispatch), so the event recorded after that update also covers
        the copy. One in-flight entry covers up to ``updates_per_dispatch``
        batches, so the distance counts batches, not dispatches: while the
        window holds W unfenced entries, up to W * k slots may still feed
        copies, and the current round's ``round_size`` slots may all be
        staged before the first of them dispatches. Every older slot's
        update has been fenced, and its copy with it."""
        need = (round_size
                + self.max_inflight_updates * self.updates_per_dispatch + 1)
        while len(self._sample_ring) < need:
            self._sample_ring.append(self._new_sample_slot())
        self._sample_slot = (self._sample_slot + 1) % len(self._sample_ring)
        return self.buffer.sample(self.batch_size,
                                  out=self._sample_ring[self._sample_slot])

    def enable_multihost(self, mesh) -> None:
        raise NotImplementedError(_MULTIHOST)

    def mh_zero_batch(self, b: int, t: int) -> dict:
        raise NotImplementedError(_MULTIHOST)

    def checkpoint_aux(self):
        """Replay buffer contents (chronological) + counters: a resumed
        learner keeps its experience instead of re-warming from an empty
        ring."""
        if len(self.buffer) == 0:
            return None
        return {"replay": self.buffer.state_arrays()}

    def restore_aux(self, aux) -> None:
        if aux and "replay" in aux:
            self.buffer.load_state_arrays(aux["replay"])

    def capture_epoch_stats(self, updated: bool):
        """A log is due on trajectory cadence, even without an update
        (warmup still logs). Pops the episode counters now, so the deferred
        row matches what the synchronous path would have printed."""
        if self._traj_since_log < self.traj_per_epoch:
            return None
        stats = (self._ep_returns or [0.0], self._ep_lengths or [0],
                 self.buffer.total_steps)
        self._ep_returns, self._ep_lengths = [], []
        self._traj_since_log = 0
        return stats

    def log_epoch(self, stats=None, metrics=None) -> None:
        """One row of the epoch log; ``stats``/``metrics`` are deferred
        :meth:`capture_epoch_stats` payloads (the pipelined server logs an
        epoch after its update's fence). Reading the metrics is one
        device-to-host transfer."""
        if stats is None:
            stats = (self._ep_returns or [0.0], self._ep_lengths or [0],
                     self.buffer.total_steps)
            self._ep_returns, self._ep_lengths = [], []
            self._traj_since_log = 0
        values = read_metrics(self._last_metrics if metrics is None
                              else metrics)
        rets, lens, total_steps = stats
        self.epoch += 1
        self.logger.store(EpRet=rets, EpLen=lens)
        self.logger.log_tabular("Epoch", self.epoch)
        self.logger.log_tabular("EpRet", with_min_and_max=True)
        self.logger.log_tabular("EpLen", average_only=True)
        self.logger.log_tabular("TotalEnvInteracts", total_steps)
        for key in self._metric_keys():
            self.logger.log_tabular(key, values.get(key, 0.0))
        self.logger.dump_tabular()

    def save(self, path=None) -> None:
        self.bundle().save(path or self.server_model_path)

    def _publish_module(self) -> nn.Module:
        return self._actor_module()

    def bundle(self) -> ModelBundle:
        return ModelBundle(version=self.version, arch=self._publish_arch(),
                           params=params_to_jax(self._actor_module()))

    @property
    def version(self) -> int:
        return int(self.state.step)


class EpsilonGreedyMixin:
    """Linear epsilon annealing shared by the epsilon-greedy family
    (DQN/C51): parse the schedule in ``_setup`` via ``_setup_epsilon``,
    publish the current value in the bundle arch."""

    def _setup_epsilon(self, params: dict) -> float:
        self.eps_start = float(params.get("epsilon_start", 1.0))
        self.eps_end = float(params.get("epsilon_end", 0.05))
        self.eps_decay_steps = int(params.get("epsilon_decay_steps", 10_000))
        return self.eps_start

    def _pixel_trunk(self, params: dict) -> dict:
        """Pixel variant: ``obs_shape`` switches the q-net to the Nature
        conv trunk. Copies the pixel keys (the cnn_discrete family's) from
        ``params`` into the arch; returns :func:`conv_trunk_kwargs`'."""
        for key in PIXEL_ARCH_KEYS:
            if key in params:
                self.arch[key] = params[key]
        return conv_trunk_kwargs(self.arch)

    def current_epsilon(self) -> float:
        frac = min(1.0, self.buffer.total_steps / max(1, self.eps_decay_steps))
        return self.eps_start + frac * (self.eps_end - self.eps_start)

    def _publish_arch(self) -> dict:
        return {**self.arch, "epsilon": self.current_epsilon()}

    def _metric_keys(self):
        return ("LossQ", "QVals")
