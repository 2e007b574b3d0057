"""GridWorld as batched tensors: the device twin of
``envs/gridworld.GridWorldEnv``, and the counterpart of
:mod:`relayrl_tpu.envs.jax.gridworld`.

All-integer dynamics (int32 positions, clamped moves, exactly-integral
rewards), so every field equals the numpy and JAX twins' bit for bit. The
int32 ``[row, col]`` observation rides the columnar wire as an int32
column on the anakin tier.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from relayrl_tpu_torch.envs.device.base import DeviceEnv
from relayrl_tpu_torch.envs.gridworld import MOVES
from relayrl_tpu_torch.envs.spaces import Box, Discrete
from relayrl_tpu_torch.models.base import resolve_device


class GridWorldState(NamedTuple):
    pos: torch.Tensor  # [N, 2] int32
    t: torch.Tensor    # [N] int32


class DeviceGridWorld(DeviceEnv):
    """Reach the corner: obs = int32 ``[row, col]``; actions
    up/down/left/right; reward 1.0 exactly at the goal."""

    def __init__(self, size: int = 5, max_steps: int = 50, device=None):
        if size < 2:
            raise ValueError("size must be >= 2 (start and goal differ)")
        self.size = int(size)
        self.max_steps = int(max_steps)
        self.observation_space = Box(0, self.size - 1, shape=(2,),
                                     dtype=np.int32)
        self.action_space = Discrete(4)
        self.device = resolve_device(device)
        self._moves = torch.as_tensor(MOVES, dtype=torch.int32, device=self.device)

    def reset(self, generator, n):
        # Uniform over the non-goal cells (the goal owns the last linear
        # index), the distribution the numpy twin draws from.
        idx = torch.randint(0, self.size * self.size - 1, (n,), generator=generator,
                            device=self.device, dtype=torch.int32)
        pos = torch.stack([idx // self.size, idx % self.size], dim=1)
        state = GridWorldState(pos=pos, t=torch.zeros_like(idx))
        return state, pos

    def step(self, state, action, generator=None):
        move = self._moves[action.reshape(-1).long()]
        pos = torch.clamp(state.pos + move, 0, self.size - 1)
        t = state.t + 1
        terminated = (pos == self.size - 1).all(dim=1)
        reward = terminated.to(torch.float32)
        truncated = t >= self.max_steps
        return GridWorldState(pos=pos, t=t), pos, reward, terminated, truncated
