"""Pendulum-v1 swing-up as batched tensors: the device twin of
``envs/classic.PendulumEnv``, and the counterpart of
:mod:`relayrl_tpu.envs.jax.pendulum`.

Same torque-limited dynamics in the same operation order (constants from
the numpy class), float32 throughout; the reward is computed from the
PRE-update angle, like the numpy twin. Continuous action: ``[N]`` or
``[N, 1]``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from relayrl_tpu_torch.envs.classic import PendulumEnv
from relayrl_tpu_torch.envs.device.base import DeviceEnv
from relayrl_tpu_torch.envs.spaces import Box
from relayrl_tpu_torch.models.base import resolve_device


class PendulumState(NamedTuple):
    theta: torch.Tensor      # [N] float32
    theta_dot: torch.Tensor  # [N] float32
    t: torch.Tensor          # [N] int32


class DevicePendulum(DeviceEnv):
    """Batched pendulum swing-up, Gymnasium Pendulum-v1 semantics."""

    def __init__(self, max_steps: int | None = None, device=None):
        c = PendulumEnv
        high = np.array([1.0, 1.0, c.MAX_SPEED], np.float32)
        self.observation_space = Box(-high, high)
        self.action_space = Box(-c.MAX_TORQUE, c.MAX_TORQUE, shape=(1,))
        self.max_steps = int(max_steps or c.MAX_STEPS)
        self.device = resolve_device(device)

    def reset(self, generator, n):
        draw = torch.rand((n, 2), generator=generator, device=self.device)
        state = PendulumState(theta=draw[:, 0] * (2 * np.pi) - np.pi,
                              theta_dot=draw[:, 1] * 2.0 - 1.0,
                              t=torch.zeros(n, dtype=torch.int32, device=self.device))
        return state, self._obs(state)

    def step(self, state, action, generator=None):
        c = PendulumEnv
        u = torch.clamp(action.reshape(-1).to(torch.float32),
                        -c.MAX_TORQUE, c.MAX_TORQUE)
        theta, theta_dot = state.theta, state.theta_dot
        norm_theta = ((theta + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_theta**2 + 0.1 * theta_dot**2 + 0.001 * u**2

        theta_dot = theta_dot + (
            3 * c.G / (2 * c.L) * torch.sin(theta)
            + 3.0 / (c.M * c.L**2) * u
        ) * c.DT
        theta_dot = torch.clamp(theta_dot, -c.MAX_SPEED, c.MAX_SPEED)
        theta = theta + theta_dot * c.DT
        t = state.t + 1
        new = PendulumState(theta=theta, theta_dot=theta_dot, t=t)
        return (new, self._obs(new), -cost, torch.zeros_like(t, dtype=torch.bool),
                t >= self.max_steps)

    def _obs(self, state: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(state.theta), torch.sin(state.theta),
                            state.theta_dot], dim=1)
