"""Vectorized actor host: N logical agents, one batched policy step.

Counterpart of :mod:`relayrl_tpu.runtime.vector_actor`. One process steps
``num_envs`` environment lanes through ONE batched policy forward and
presents each lane as its own trajectory stream; a single
:meth:`maybe_swap` installs new params for every lane at once (a batched
step reads one params module, so no dispatch mixes versions).

Sequence policies run the padded-window path with stacked per-lane
windows: one forward over ``[N, W, obs_dim]`` with each lane reading out
at its own row (no KV cache, as in the JAX package's host). Every lane
draws its action from the host's one generator, so a batch-of-1 host is
bit-identical to a
:class:`~relayrl_tpu_torch.runtime.policy_actor.PolicyActor` serving
through its window (``use_kv_cache=False``) with the same seed (both go
through ``make_batched_window_step``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from relayrl_tpu_torch.models import build_policy, validate_policy
from relayrl_tpu_torch.runtime.policy_actor import (
    apply_bundle_swap,
    apply_wire_swap,
    make_batched_step,
    make_batched_window_step,
    normalize_obs,
    push_window,
    resolve_actor_context,
)
from relayrl_tpu_torch.types.action import ActionRecord
from relayrl_tpu_torch.types.model_bundle import ModelBundle, exploration_kwargs
from relayrl_tpu_torch.types.trajectory import Trajectory


class VectorActorHost:
    """N env lanes → one batched policy dispatch → N trajectory streams.

    ``on_send(lane, payload)`` receives each lane's serialized episodes.
    ``device`` defaults to the GPU; without one the caller must pass
    ``device="cpu"``. ``seed`` seeds the host's sampling generator.
    """

    def __init__(
        self,
        bundle: ModelBundle,
        num_envs: int,
        max_traj_length: int = 1000,
        on_send=None,
        seed: int = 0,
        validate: bool = True,
        device=None,
    ):
        if num_envs < 1:
            raise ValueError(f"num_envs must be >= 1, got {num_envs}")
        self._lock = threading.Lock()
        self.num_envs = int(num_envs)
        self.arch = dict(bundle.arch)
        self.policy = build_policy(self.arch, device)
        self.params = self.policy.load_params(bundle.params)
        if validate:
            validate_policy(self.policy, self.params)
        self.version = bundle.version
        self._batched_fn = make_batched_step(self.policy)
        self._windows = None
        self._window_lens = None
        self._batched_window_fn = None
        if self.policy.step_window is not None:
            ctx = resolve_actor_context(self.arch)
            self._windows = np.zeros(
                (self.num_envs, ctx, int(self.arch["obs_dim"])), np.float32)
            self._window_lens = np.zeros(self.num_envs, np.int32)
            self._batched_window_fn = make_batched_window_step(self.policy)
        self._explore_kwargs = exploration_kwargs(self.arch)
        self._generator = torch.Generator(
            device=self.policy.device).manual_seed(seed)
        self.trajectories = [
            Trajectory(
                max_length=max_traj_length,
                on_send=(None if on_send is None
                         else (lambda payload, _lane=lane:
                               on_send(_lane, payload))))
            for lane in range(self.num_envs)
        ]
        self.steps_served = 0
        self.dispatches = 0
        self.swaps = 0
        from relayrl_tpu_torch import telemetry

        reg = telemetry.get_registry()
        self._m_steps = reg.counter(
            "relayrl_actor_env_steps_total",
            "policy steps served (one per env step per lane)")
        self._m_dispatches = reg.counter(
            "relayrl_actor_batched_dispatches_total",
            "batched policy dispatches (each serves num_envs lanes)")
        reg.gauge("relayrl_actor_lanes",
                  "env lanes per batched dispatch on this host").set(
                      self.num_envs)
        # Model-wire v2 decode state, created on the first v2 frame: ONE
        # decoder for all lanes (one subscription, one delta apply, one
        # host-to-device copy, N lanes served).
        self._wire_decoder = None

    def request_for_actions(self, obs, masks=None,
                            rewards=None) -> list[ActionRecord]:
        """One batched policy dispatch for all lanes; appends one
        ActionRecord per lane to that lane's trajectory.

        ``obs`` is stacked ``[N, ...]``; ``rewards`` (length N, or None)
        carries each lane's env reward earned since its previous request
        and is attached to that lane's PREVIOUS record. ``masks`` is None
        or stacked ``[N, act_dim]``.
        """
        obs = np.asarray(obs)
        if obs.shape[0] != self.num_envs:
            raise ValueError(
                f"obs batch {obs.shape[0]} != num_envs {self.num_envs}")
        obs = normalize_obs(obs)
        masks_arr = (None if masks is None
                     else np.asarray(masks, dtype=np.float32))
        with self._lock:
            if rewards is not None:
                for lane, r in enumerate(rewards):
                    if r and self.trajectories[lane].get_actions():
                        self.trajectories[lane].get_actions()[-1] \
                            .update_reward(float(r))
            # ONE params read under the lock for the whole batch: every
            # lane acts on the same model version.
            if self._batched_window_fn is not None:
                self._push_windows(obs)
                acts_np, aux_np = self._batched_window_fn(
                    self.params, self._generator, self._windows,
                    self._window_lens, masks_arr)
            else:
                acts_np, aux_np = self._batched_fn(
                    self.params, self._generator, obs, masks_arr,
                    self._explore_kwargs)
            records = []
            for lane in range(self.num_envs):
                record = ActionRecord(
                    obs=obs[lane],
                    act=acts_np[lane],
                    mask=None if masks_arr is None else masks_arr[lane],
                    rew=0.0,  # filled by the lane's NEXT request / terminal
                    # np.asarray: indexing a stacked [N] aux column yields
                    # a numpy SCALAR, which the wire codec would encode as
                    # a float64 — the 0-d ndarray keeps dtype (and bytes)
                    # identical to the single-actor path.
                    data={k: np.asarray(v[lane])
                          for k, v in aux_np.items()},
                    done=False,
                )
                self.trajectories[lane].add_action(record, send_if_done=True)
                records.append(record)
            self.steps_served += self.num_envs
            self.dispatches += 1
        self._m_steps.inc(self.num_envs)
        self._m_dispatches.inc()
        return records

    def flag_last_action(self, lane: int, reward: float = 0.0,
                         truncated: bool = False, final_obs=None,
                         terminated: bool | None = None,
                         final_mask=None) -> None:
        """Terminal marker for ONE lane (lanes end episodes independently
        under autoreset): appends a done action carrying the final reward,
        which ships that lane's trajectory. Same semantics as
        ``PolicyActor.flag_last_action``."""
        if terminated:
            truncated = False
        with self._lock:
            if self._windows is not None:
                # Episode boundary for this lane only.
                self._windows[lane, :, :] = 0.0
                self._window_lens[lane] = 0
            record = ActionRecord(
                obs=(None if final_obs is None
                     else np.asarray(final_obs, np.float32)),
                mask=(None if final_mask is None
                      else np.asarray(final_mask, np.float32)),
                rew=float(reward), done=True, truncated=bool(truncated))
            self.trajectories[lane].add_action(record, send_if_done=True)

    def maybe_swap(self, bundle: ModelBundle) -> bool:
        """Install a newer model for EVERY lane atomically (the gate shared
        with PolicyActor, under the lock the batched step holds)."""
        return apply_bundle_swap(self, bundle)

    def swap_from_bytes(self, buf: bytes) -> bool:
        return self.maybe_swap(ModelBundle.from_bytes(buf))

    def swap_from_wire(self, version: int, blob: bytes):
        """Wire-v2-aware swap shared with PolicyActor (one decoder, one
        atomic install for every lane)."""
        return apply_wire_swap(self, version, blob)

    def reset_episode(self, lane: int | None = None) -> None:
        """Reset per-episode serving state (history windows) without
        touching trajectories — one lane, or all lanes when ``lane`` is
        None."""
        with self._lock:
            if self._windows is None:
                return
            if lane is None:
                self._windows[:] = 0.0
                self._window_lens[:] = 0
            else:
                self._windows[lane, :, :] = 0.0
                self._window_lens[lane] = 0

    def _push_windows(self, obs: np.ndarray) -> None:
        """Append one observation per lane to the stacked rolling history
        (lock held); each lane goes through the shared push_window rule."""
        for lane in range(self.num_envs):
            self._window_lens[lane], _ = push_window(
                self._windows[lane], int(self._window_lens[lane]),
                obs[lane])


def coerce_env_action(act) -> object:
    """Wire action → what ``env.step`` expects: python scalar for 0-d
    (int for integer dtypes, float otherwise), ndarray for vectors."""
    arr = np.asarray(act)
    if arr.ndim == 0:
        return int(arr) if np.issubdtype(arr.dtype, np.integer) else float(arr)
    return arr


def run_vector_gym_loop(host, venv, steps: int,
                        seed: int | None = None) -> list[list[float]]:
    """Drive a :class:`~relayrl_tpu_torch.envs.vector.SyncVectorEnv` (or
    any stacked gym-like with autoreset) through a vector host for
    ``steps`` batched policy dispatches. Returns per-lane completed
    episode returns."""
    n = venv.num_envs
    obs, _ = venv.reset(seed=seed)
    rewards = np.zeros(n, np.float32)
    ep_ret = np.zeros(n, np.float64)
    returns: list[list[float]] = [[] for _ in range(n)]
    for _ in range(steps):
        records = host.request_for_actions(obs, rewards=rewards)
        actions = [coerce_env_action(r.act) for r in records]
        obs, rews, terms, truncs, infos = venv.step(actions)
        ep_ret += rews
        for lane in range(n):
            if terms[lane] or truncs[lane]:
                # Autoreset already happened inside venv.step; the
                # pre-reset observation rides the info dict for the
                # time-limit bootstrap.
                time_limited = not terms[lane]
                host.flag_last_action(
                    lane, float(rews[lane]),
                    truncated=bool(time_limited),
                    final_obs=(infos[lane].get("final_observation")
                               if time_limited else None),
                    terminated=bool(terms[lane]))
                returns[lane].append(float(ep_ret[lane]))
                ep_ret[lane] = 0.0
                rewards[lane] = 0.0  # new episode: nothing earned yet
            else:
                rewards[lane] = rews[lane]
    return returns
