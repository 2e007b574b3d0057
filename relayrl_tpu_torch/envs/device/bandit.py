"""Bandit battery as batched tensors: the device twin of
``envs/bandit.py``, and the counterpart of
:mod:`relayrl_tpu.envs.jax.bandit`.

All-integer dynamics (context draw, target-arm residue, 0/1 reward,
flags), so every field equals the numpy and JAX twins' bit for bit.
One-step episodes: every step crosses an episode boundary, so the
autoreset and the terminal folding run at the highest rate there is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from relayrl_tpu_torch.envs.device.base import DeviceEnv
from relayrl_tpu_torch.envs.spaces import Box, Discrete
from relayrl_tpu_torch.models.base import resolve_device


class BanditState(NamedTuple):
    ctx: torch.Tensor  # [N] int32


class DeviceBandit(DeviceEnv):
    """One-step contextual bandit: obs = int32 one-hot context; reward
    1.0 exactly when the arm equals ``(ctx * mult + shift) % n_arms``."""

    def __init__(self, n_contexts: int = 8, n_arms: int = 4,
                 mult: int = 3, shift: int = 1, device=None):
        if n_contexts < 1 or n_arms < 2:
            raise ValueError("need n_contexts >= 1 and n_arms >= 2")
        self.n_contexts = int(n_contexts)
        self.n_arms = int(n_arms)
        self.mult = int(mult)
        self.shift = int(shift)
        self.observation_space = Box(0, 1, shape=(self.n_contexts,),
                                     dtype=np.int32)
        self.action_space = Discrete(self.n_arms)
        self.device = resolve_device(device)

    def _obs(self, ctx) -> torch.Tensor:
        return (torch.arange(self.n_contexts, dtype=torch.int32, device=self.device)[None]
                == ctx[:, None]).to(torch.int32)

    def reset(self, generator, n):
        ctx = torch.randint(0, self.n_contexts, (n,), generator=generator,
                            device=self.device, dtype=torch.int32)
        return BanditState(ctx=ctx), self._obs(ctx)

    def step(self, state, action, generator=None):
        arm = torch.clamp(action.reshape(-1).to(torch.int32), 0, self.n_arms - 1)
        target = (state.ctx * self.mult + self.shift) % self.n_arms
        reward = (arm == target).to(torch.float32)
        done = torch.ones_like(arm, dtype=torch.bool)
        return state, self._obs(state.ctx), reward, done, ~done
