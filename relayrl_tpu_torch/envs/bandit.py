"""Bandit battery: one-step contextual bandit (numpy built-in).

A copy of :mod:`relayrl_tpu.envs.bandit`; seeded alike, it gives the same
bits.

The fast-regression-signal env for scheduler/learner plumbing: every
episode is ONE
step — observe an integer context, pick an arm, collect 1.0 iff the arm
matches the context's deterministic target ``(ctx * mult + shift) %
n_arms`` — so a learner's reward curve responds within a handful of
epochs and a broken ingest/credit path shows up in seconds, not
minutes.

Observations are an int32 one-hot of the context (0/1 integers, like
GridWorld's raw coordinates: exercises the integer obs path; the
learner casts at the padding boundary). Dynamics are ALL integer —
context draw, target arithmetic, 0/1 reward, flags — so the batched
device twin (``envs/device/bandit.py``) holds FULL bitwise parity with no float
carve-out.
"""

from __future__ import annotations

import numpy as np

from relayrl_tpu_torch.envs.spaces import Box, Discrete


class BanditEnv:
    """One-step contextual bandit: obs = int32 one-hot context; reward
    1.0 exactly when the arm equals ``(ctx * mult + shift) % n_arms``."""

    def __init__(self, n_contexts: int = 8, n_arms: int = 4,
                 mult: int = 3, shift: int = 1):
        if n_contexts < 1 or n_arms < 2:
            raise ValueError("need n_contexts >= 1 and n_arms >= 2")
        self.n_contexts = int(n_contexts)
        self.n_arms = int(n_arms)
        self.mult = int(mult)
        self.shift = int(shift)
        self.observation_space = Box(0, 1, shape=(self.n_contexts,),
                                     dtype=np.int32)
        self.action_space = Discrete(self.n_arms)
        self._rng = np.random.default_rng()
        self._ctx = 0

    def _obs(self) -> np.ndarray:
        obs = np.zeros(self.n_contexts, np.int32)
        obs[self._ctx] = 1
        return obs

    def target_arm(self, ctx: int) -> int:
        """The deterministic correct arm for a context — part of the
        twin-parity contract (the device env computes the same residue)."""
        return (int(ctx) * self.mult + self.shift) % self.n_arms

    def reset(self, seed: int | None = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._ctx = int(self._rng.integers(self.n_contexts))
        return self._obs(), {}

    def step(self, action):
        arm = int(np.clip(int(action), 0, self.n_arms - 1))
        reward = 1.0 if arm == self.target_arm(self._ctx) else 0.0
        # Every episode is one step; the terminal obs is the (unchanged)
        # context one-hot — there is no successor state to encode.
        return self._obs(), reward, True, False, {}
