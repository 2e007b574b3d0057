"""CartPole-v1 dynamics as batched tensors: the device twin of
``envs/classic.CartPoleEnv``, and the counterpart of
:mod:`relayrl_tpu.envs.jax.cartpole`.

The step math is the same Barto-Sutton-Anderson equations in the same
operation order as the JAX twin, in float32 (the physics constants come
from the numpy class, so the twins cannot drift apart); one step from the
same state agrees with the JAX env to float32 rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from relayrl_tpu_torch.envs.classic import CartPoleEnv
from relayrl_tpu_torch.envs.device.base import DeviceEnv
from relayrl_tpu_torch.envs.spaces import Box, Discrete
from relayrl_tpu_torch.models.base import resolve_device


class CartPoleState(NamedTuple):
    state: torch.Tensor  # [N, 4] float32: x, x_dot, theta, theta_dot
    t: torch.Tensor      # [N] int32 steps taken this episode


class DeviceCartPole(DeviceEnv):
    """Batched cart-pole, Gymnasium CartPole-v1 semantics."""

    def __init__(self, max_steps: int | None = None, device=None):
        self.observation_space = Box(-np.inf, np.inf, shape=(4,))
        self.action_space = Discrete(2)
        self.max_steps = int(max_steps or CartPoleEnv.MAX_STEPS)
        self.device = resolve_device(device)

    def reset(self, generator, n):
        state = torch.rand((n, 4), generator=generator, device=self.device) * 0.1 - 0.05
        return (CartPoleState(state=state,
                              t=torch.zeros(n, dtype=torch.int32, device=self.device)),
                state)

    def step(self, state, action, generator=None):
        c = CartPoleEnv
        x, x_dot, theta, theta_dot = state.state.unbind(1)
        force = torch.where(action.reshape(-1).to(torch.int32) == 1,
                            c.FORCE_MAG, -c.FORCE_MAG).to(torch.float32)
        cos_t, sin_t = torch.cos(theta), torch.sin(theta)
        total_mass = c.MASS_CART + c.MASS_POLE
        pole_ml = c.MASS_POLE * c.HALF_LENGTH

        temp = (force + pole_ml * theta_dot**2 * sin_t) / total_mass
        theta_acc = (c.GRAVITY * sin_t - cos_t * temp) / (
            c.HALF_LENGTH * (4.0 / 3.0 - c.MASS_POLE * cos_t**2 / total_mass)
        )
        x_acc = temp - pole_ml * theta_acc * cos_t / total_mass

        x = x + c.TAU * x_dot
        x_dot = x_dot + c.TAU * x_acc
        theta = theta + c.TAU * theta_dot
        theta_dot = theta_dot + c.TAU * theta_acc
        new = torch.stack([x, x_dot, theta, theta_dot], dim=1)
        t = state.t + 1

        terminated = (x.abs() > c.X_LIMIT) | (theta.abs() > c.THETA_LIMIT)
        # Independent flags, exactly like the numpy twin (both may be
        # true on one step; terminated beats truncated downstream).
        truncated = t >= self.max_steps
        return (CartPoleState(state=new, t=t), new, torch.ones_like(x),
                terminated, truncated)
