"""Classic-control dynamics (numpy, Gymnasium step/reset API).

A copy of :mod:`relayrl_tpu.envs.classic` with its imports rewritten, so
the port and the JAX package step the same dynamics from one seed.

CartPole follows the standard Barto-Sutton-Anderson cart-pole equations and
Gymnasium's v1 episode spec (500-step limit, +1 per step, termination at
±12° / ±2.4 m); Pendulum is the standard torque-limited swing-up with the
``[cosθ, sinθ, θ̇]`` observation and quadratic cost. These are the tasks the
reference's example notebooks train on (reference: examples/ tree — CartPole
and LunarLander notebooks per transport).
"""

from __future__ import annotations

import numpy as np

from relayrl_tpu_torch.envs.spaces import Box, Discrete


class CartPoleEnv:
    """Cart-pole balancing, Gymnasium CartPole-v1 semantics."""

    GRAVITY = 9.8
    MASS_CART = 1.0
    MASS_POLE = 0.1
    HALF_LENGTH = 0.5
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * np.pi / 180
    X_LIMIT = 2.4
    MAX_STEPS = 500

    def __init__(self, max_steps: int | None = None):
        self.observation_space = Box(-np.inf, np.inf, shape=(4,))
        self.action_space = Discrete(2)
        self.max_steps = int(max_steps or self.MAX_STEPS)
        self._rng = np.random.default_rng()
        self._state = np.zeros(4, np.float64)
        self._t = 0

    def reset(self, seed: int | None = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._t = 0
        return self._state.astype(np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if int(action) == 1 else -self.FORCE_MAG
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        total_mass = self.MASS_CART + self.MASS_POLE
        pole_ml = self.MASS_POLE * self.HALF_LENGTH

        temp = (force + pole_ml * theta_dot**2 * sin_t) / total_mass
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.HALF_LENGTH * (4.0 / 3.0 - self.MASS_POLE * cos_t**2 / total_mass)
        )
        x_acc = temp - pole_ml * theta_acc * cos_t / total_mass

        x += self.TAU * x_dot
        x_dot += self.TAU * x_acc
        theta += self.TAU * theta_dot
        theta_dot += self.TAU * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._t += 1

        terminated = bool(
            abs(x) > self.X_LIMIT or abs(theta) > self.THETA_LIMIT
        )
        truncated = self._t >= self.max_steps
        return self._state.astype(np.float32), 1.0, terminated, truncated, {}


class PendulumEnv:
    """Torque-limited pendulum swing-up, Gymnasium Pendulum-v1 semantics."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0
    MAX_STEPS = 200

    def __init__(self, max_steps: int | None = None):
        high = np.array([1.0, 1.0, self.MAX_SPEED], np.float32)
        self.observation_space = Box(-high, high)
        self.action_space = Box(-self.MAX_TORQUE, self.MAX_TORQUE, shape=(1,))
        self.max_steps = int(max_steps or self.MAX_STEPS)
        self._rng = np.random.default_rng()
        self._theta = 0.0
        self._theta_dot = 0.0
        self._t = 0

    def reset(self, seed: int | None = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._theta = self._rng.uniform(-np.pi, np.pi)
        self._theta_dot = self._rng.uniform(-1.0, 1.0)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        theta, theta_dot = self._theta, self._theta_dot
        norm_theta = ((theta + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_theta**2 + 0.1 * theta_dot**2 + 0.001 * u**2

        theta_dot = theta_dot + (
            3 * self.G / (2 * self.L) * np.sin(theta)
            + 3.0 / (self.M * self.L**2) * u
        ) * self.DT
        theta_dot = float(np.clip(theta_dot, -self.MAX_SPEED, self.MAX_SPEED))
        theta = theta + theta_dot * self.DT
        self._theta, self._theta_dot = theta, theta_dot
        self._t += 1
        return self._obs(), -float(cost), False, self._t >= self.max_steps, {}

    def _obs(self) -> np.ndarray:
        return np.array(
            [np.cos(self._theta), np.sin(self._theta), self._theta_dot],
            np.float32,
        )
