"""Memory tasks: environments solvable ONLY by conditioning on history.

The reference trains exclusively on fully-observed classic control
(examples/ tree); these built-ins exist to exercise the long-context model
family end-to-end — a per-step MLP policy is capped at chance by
construction, while a sequence policy (transformer over the trajectory
time axis) can solve them by attending back to the cue.

``RecallEnv``: at t=0 the observation shows a one-hot cue; every later
observation hides it. At the final ("query") step the agent must emit the
action matching the cue: reward +1, else 0. Expected return of any
memoryless policy = 1/n_cues; a policy with memory reaches 1.0.
"""

from __future__ import annotations

import numpy as np

from relayrl_tpu_torch.envs.spaces import Box, Discrete


class RecallEnv:
    """Remember-the-cue: obs = [cue one-hot (t=0 only), is_query, t/T].

    ``horizon`` actions per episode; only the last one is scored. The
    distractor phase can optionally carry observation noise to stop
    policies keying on spurious features.
    """

    def __init__(self, horizon: int = 8, n_cues: int = 2,
                 noise: float = 0.0):
        if horizon < 2:
            raise ValueError("horizon must be >= 2 (cue step + query step)")
        self.horizon = int(horizon)
        self.n_cues = int(n_cues)
        self.noise = float(noise)
        self.observation_space = Box(-np.inf, np.inf,
                                     shape=(self.n_cues + 2,))
        self.action_space = Discrete(self.n_cues)
        self._rng = np.random.default_rng()
        self._cue = 0
        self._t = 0

    def _obs(self) -> np.ndarray:
        obs = np.zeros(self.n_cues + 2, np.float32)
        if self._t == 0:
            obs[self._cue] = 1.0
        elif self.noise > 0.0:
            obs[: self.n_cues] = self._rng.normal(
                0.0, self.noise, self.n_cues)
        obs[self.n_cues] = 1.0 if self._t == self.horizon - 1 else 0.0
        obs[self.n_cues + 1] = self._t / self.horizon
        return obs

    def reset(self, seed: int | None = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._cue = int(self._rng.integers(self.n_cues))
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        is_query = self._t == self.horizon - 1
        reward = float(int(action) == self._cue) if is_query else 0.0
        self._t += 1
        terminated = self._t >= self.horizon
        return self._obs(), reward, terminated, False, {}
