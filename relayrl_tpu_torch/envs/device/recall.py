"""Recall memory task as batched tensors: the device twin of
``envs/memory.RecallEnv``, and the counterpart of
:mod:`relayrl_tpu.envs.jax.recall`.

Integer-derived observations (cue one-hot, query flag, phase fraction):
with ``noise=0`` (the default) every field equals the JAX twin's bit for
bit, and the numpy twin's whenever ``horizon`` is a power of two. The
phase is ``t`` times the float32 reciprocal of ``horizon``, as XLA computes
the JAX twin's ``t / horizon``; for a power of two that is exact, so it
also equals the numpy twin's float64 division rounded to float32. The
distractor noise (``noise > 0``) is drawn from the generator ``step`` is
handed, for every lane at every step, where the JAX twin carries a key in
its state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from relayrl_tpu_torch.envs.device.base import DeviceEnv
from relayrl_tpu_torch.envs.spaces import Box, Discrete
from relayrl_tpu_torch.models.base import resolve_device


class RecallState(NamedTuple):
    cue: torch.Tensor  # [N] int32
    t: torch.Tensor    # [N] int32


class DeviceRecall(DeviceEnv):
    """Remember-the-cue: obs = [cue one-hot (t=0 only), is_query, t/T]."""

    def __init__(self, horizon: int = 8, n_cues: int = 2,
                 noise: float = 0.0, device=None):
        if horizon < 2:
            raise ValueError("horizon must be >= 2 (cue step + query step)")
        self.horizon = int(horizon)
        self.n_cues = int(n_cues)
        self.noise = float(noise)
        self.observation_space = Box(-np.inf, np.inf,
                                     shape=(self.n_cues + 2,))
        self.action_space = Discrete(self.n_cues)
        self.device = resolve_device(device)
        self._inv_horizon = float(np.float32(1.0) / np.float32(self.horizon))

    def _obs(self, cue, t, generator) -> torch.Tensor:
        n = cue.shape[0]
        if self.noise > 0.0:
            distractor = self.noise * torch.randn(
                (n, self.n_cues), generator=generator, device=self.device)
        else:
            distractor = torch.zeros((n, self.n_cues), device=self.device)
        one_hot = (torch.arange(self.n_cues, device=self.device)[None]
                   == cue[:, None]).to(torch.float32)
        head = torch.where((t == 0)[:, None], one_hot, distractor)
        is_query = (t == self.horizon - 1).to(torch.float32)
        phase = t.to(torch.float32) * self._inv_horizon
        return torch.cat([head, is_query[:, None], phase[:, None]], dim=1)

    def reset(self, generator, n):
        cue = torch.randint(0, self.n_cues, (n,), generator=generator,
                            device=self.device, dtype=torch.int32)
        state = RecallState(cue=cue, t=torch.zeros_like(cue))
        return state, self._obs(cue, state.t, generator)

    def step(self, state, action, generator=None):
        is_query = state.t == self.horizon - 1
        hit = is_query & (action.reshape(-1).to(torch.int32) == state.cue)
        reward = hit.to(torch.float32)
        t = state.t + 1
        new = RecallState(cue=state.cue, t=t)
        terminated = t >= self.horizon
        return (new, self._obs(state.cue, t, generator), reward, terminated,
                torch.zeros_like(terminated))
