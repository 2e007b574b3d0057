"""Stacked-env driver: N gym-likes behind one batched reset/step surface.

The vector actor host (``runtime/vector_actor.py``) steps N environment
lanes against a single batched policy dispatch; this module supplies the
matching env side — a synchronous vector wrapper over the built-in (or
Gymnasium) gym-likes with **per-env autoreset**: a lane that terminates or
truncates is reset inside the same ``step`` call, its pre-reset
observation preserved in that lane's info dict under
``"final_observation"`` (the Gymnasium VectorEnv convention) so time-limit
bootstrapping still sees the successor state.

Synchronous on purpose: the policy apply is the batched part; env
dynamics here are cheap numpy loops, and a thread/process pool per env
would reintroduce exactly the oversubscription the vector host removes.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


class SyncVectorEnv:
    """N same-shaped gym-like envs stepped in lockstep with autoreset."""

    def __init__(self, env_fns: Sequence[Callable[[], object]]):
        if not env_fns:
            raise ValueError("SyncVectorEnv needs at least one env factory")
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space
        self._base_seed: int | None = None
        self._episode = [0] * self.num_envs  # per-lane episode index

    def reset(self, seed: int | None = None):
        """Reset every lane; per-lane seeds are ``seed + lane`` so lanes
        decorrelate while the whole stack stays reproducible."""
        self._base_seed = None if seed is None else int(seed)
        self._episode = [0] * self.num_envs
        obs_rows, infos = [], []
        for lane, env in enumerate(self.envs):
            obs, info = env.reset(
                seed=None if seed is None else seed + lane)
            obs_rows.append(np.asarray(obs))
            infos.append(info)
        return np.stack(obs_rows), infos

    def _autoreset_seed(self, lane: int) -> int | None:
        """Derived per-lane seed for episode ``e`` of lane ``k``:
        ``base + k + num_envs * e`` — episode 0 is exactly ``reset(seed)``'s
        ``seed + lane`` contract, and the stride keeps every (lane,
        episode) seed distinct, so a seeded vector stack is reproducible
        across its WHOLE run, not just the first episode per lane.
        Unseeded stacks keep the old behavior (entropy-seeded resets)."""
        if self._base_seed is None:
            return None
        return self._base_seed + lane + self.num_envs * self._episode[lane]

    def step(self, actions):
        """Step every lane; finished lanes autoreset in place.

        Returns ``(obs[N,...], rewards[N], terminated[N], truncated[N],
        infos)`` where a finished lane's ``obs`` row is already the reset
        observation of its NEXT episode and its info dict carries
        ``final_observation`` (the pre-reset obs) plus ``reset_info``
        (the info dict of the autoreset — previously discarded, which
        lost e.g. Gymnasium envs' reset-time seeds/options echo).
        """
        obs_rows, rewards, terms, truncs, infos = [], [], [], [], []
        for lane, (env, action) in enumerate(zip(self.envs, actions)):
            obs, reward, terminated, truncated, info = env.step(action)
            if terminated or truncated:
                info = dict(info)
                info["final_observation"] = np.asarray(obs)
                self._episode[lane] += 1
                obs, reset_info = env.reset(seed=self._autoreset_seed(lane))
                info["reset_info"] = reset_info
            obs_rows.append(np.asarray(obs))
            rewards.append(reward)
            terms.append(bool(terminated))
            truncs.append(bool(truncated))
            infos.append(info)
        return (np.stack(obs_rows), np.asarray(rewards, np.float32),
                np.asarray(terms, bool), np.asarray(truncs, bool), infos)

    def close(self) -> None:
        for env in self.envs:
            close = getattr(env, "close", None)
            if close is not None:
                close()

