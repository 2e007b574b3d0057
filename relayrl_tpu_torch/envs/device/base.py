"""The on-device environment ABI: batched tensor functions over lanes.

Counterpart of :mod:`relayrl_tpu.envs.jax.base`, the JAX package's pure
functions over pytree state that its Anakin tier ``vmap``s and
``lax.scan``s. Here every call already serves a leading lane axis, so the
fused rollout (``runtime/anakin.py``) steps ``N`` lanes with one call per
env step and, on a CUDA device, captures the whole window as one CUDA
graph::

    reset(generator, n)        -> (state, obs)
    step(state, action, generator=None)
                               -> (state, obs, reward, terminated, truncated)

* ``state`` is a NamedTuple of tensors whose first axis is the lane:
  fixed shapes and dtypes, no Python objects, no data-dependent shapes
  (what a capture needs). ``step`` is deterministic given ``state``; an
  env with observation noise (Recall at ``noise > 0``) draws it from the
  ``generator`` it is handed, for every lane at every step.
* ``reward``/``terminated``/``truncated`` follow the numpy built-ins'
  Gymnasium step contract field for field.
* Dtypes are pinned as the JAX envs pin them: float32 observations and
  rewards, int32 counters and integer observations, bool flags.

Randomness comes from ``torch.Generator`` streams, not threefry keys, so
a reset here never equals the JAX env's reset bit for bit; the tests hand
both the JAX reset's state and hold the dynamics to it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class DeviceEnv:
    """Base class carrying the space metadata and the device; subclasses
    implement the batched ``reset``/``step`` pair. Instances hold only
    static configuration (horizon, physics constants), never per-episode
    state, so one instance serves every lane."""

    observation_space: Any
    action_space: Any
    device: torch.device

    @property
    def obs_dim(self) -> int:
        return int(self.observation_space.shape[0])

    def reset(self, generator: torch.Generator, n: int) -> tuple[NamedTuple, torch.Tensor]:
        raise NotImplementedError

    def step(self, state, action, generator: torch.Generator | None = None):
        raise NotImplementedError


def _lanes(pred: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``pred [N]`` viewed to broadcast over ``like``'s trailing axes."""
    return pred.view(pred.shape + (1,) * (like.ndim - pred.ndim))


def tree_where(pred: torch.Tensor, on_true, on_false):
    """Per-field ``torch.where`` over two same-type state tuples; ``pred``
    is a ``[N]`` bool lane mask. The masking primitive the autoreset is
    built from."""
    return type(on_true)(*(torch.where(_lanes(pred, a), a, b)
                           for a, b in zip(on_true, on_false)))


def step_autoreset(env: DeviceEnv, state, action,
                   generator: torch.Generator | None = None, reset=None):
    """One env step for every lane with the episode boundary folded in.

    Returns ``(state, obs, reward, terminated, truncated, final_obs)``:
    for a lane that just finished, ``state``/``obs`` are already the NEXT
    episode's reset state and observation and ``final_obs`` is the
    pre-reset observation (the time-limit bootstrap); for the others
    ``final_obs`` equals ``obs``.

    ``reset`` is the ``(state, obs)`` to reset into; by default it is
    drawn here from ``generator`` for EVERY lane at every step, as the JAX
    twin computes it unconditionally, so the random stream never depends
    on episode lengths and nothing has a data-dependent shape. ``generator``
    also serves ``step``'s own draws (observation noise)."""
    stepped_state, stepped_obs, reward, terminated, truncated = env.step(
        state, action, generator)
    done = terminated | truncated
    if reset is None:
        reset = env.reset(generator, done.shape[0])
    reset_state, reset_obs = reset
    next_state = tree_where(done, reset_state, stepped_state)
    next_obs = torch.where(_lanes(done, reset_obs), reset_obs, stepped_obs)
    return next_state, next_obs, reward, terminated, truncated, stepped_obs
