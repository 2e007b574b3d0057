"""GridWorld: integer-observation navigation (numpy built-in).

A copy of :mod:`relayrl_tpu.envs.gridworld`; seeded alike, it gives the
same bits.

A ``size × size`` grid; the agent starts on a uniformly random non-goal
cell and must reach the fixed goal in the far corner. Observations are
the agent's **raw int32 coordinates** ``[row, col]`` — deliberately not
one-hot or normalized floats: this env exists (with its batched device twin,
``envs/device/gridworld.py``) to exercise the integer-column path of the
columnar trajectory wire end to end, where obs ship as an int32 column
and only become float at the learner's padding boundary.

Dynamics are all-integer (moves clamp at the borders, reward is exactly
``1.0`` on reaching the goal and ``0.0`` otherwise), so the device twin's
parity golden holds FULL bitwise equality — observation, reward, flags —
with no float-tolerance carve-out (tests/test_torch_device_envs.py).
"""

from __future__ import annotations

import numpy as np

from relayrl_tpu_torch.envs.spaces import Box, Discrete

# action -> (d_row, d_col); order is part of the twin-parity contract
MOVES = np.array([[-1, 0], [1, 0], [0, -1], [0, 1]], np.int32)


class GridWorldEnv:
    """Reach the corner: obs = int32 ``[row, col]``; actions
    up/down/left/right; reward 1.0 exactly at the goal."""

    def __init__(self, size: int = 5, max_steps: int = 50):
        if size < 2:
            raise ValueError("size must be >= 2 (start and goal differ)")
        self.size = int(size)
        self.max_steps = int(max_steps)
        self.goal = np.array([self.size - 1, self.size - 1], np.int32)
        self.observation_space = Box(0, self.size - 1, shape=(2,),
                                     dtype=np.int32)
        self.action_space = Discrete(4)
        self._rng = np.random.default_rng()
        self._pos = np.zeros(2, np.int32)
        self._t = 0

    def reset(self, seed: int | None = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        # Uniform over the size*size - 1 non-goal cells: the goal owns
        # the LAST linear index, so drawing below it excludes exactly it.
        idx = int(self._rng.integers(self.size * self.size - 1))
        self._pos = np.array([idx // self.size, idx % self.size], np.int32)
        self._t = 0
        return self._pos.copy(), {}

    def step(self, action):
        move = MOVES[int(action)]
        self._pos = np.clip(self._pos + move, 0, self.size - 1)
        self._t += 1
        terminated = bool((self._pos == self.goal).all())
        reward = 1.0 if terminated else 0.0
        truncated = self._t >= self.max_steps
        return self._pos.copy(), reward, terminated, truncated, {}
