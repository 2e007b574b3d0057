"""Built-in environments: the classic-control tasks, the memory task,
GridWorld, the bandit battery, TokenGen, the Atari-style pixel pipeline
and the vector env (copies of the JAX package's numpy envs), and
:func:`make`, the built-in branch of :func:`relayrl_tpu.envs.make`
(the port does not depend on Gymnasium). Their batched on-device twins,
which the anakin tier steps, are in :mod:`relayrl_tpu_torch.envs.device`.
"""

from relayrl_tpu_torch.envs.atari import (
    ALEUnavailableError,
    AtariPreprocessing,
    SyntheticPixelEnv,
    make_atari,
)
from relayrl_tpu_torch.envs.bandit import BanditEnv
from relayrl_tpu_torch.envs.classic import CartPoleEnv, PendulumEnv
from relayrl_tpu_torch.envs.gridworld import GridWorldEnv
from relayrl_tpu_torch.envs.memory import RecallEnv
from relayrl_tpu_torch.envs.spaces import Box, Discrete
from relayrl_tpu_torch.envs.tokengen import TokenGenEnv
from relayrl_tpu_torch.envs.vector import SyncVectorEnv

_BUILTIN = {
    "CartPole-v1": CartPoleEnv,
    "Pendulum-v1": PendulumEnv,
    # Memory task (no Gymnasium counterpart): built-in only.
    "Recall-v0": RecallEnv,
    # Integer-observation navigation: the columnar wire's int32 obs column.
    "GridWorld-v0": GridWorldEnv,
    # One-step contextual bandit battery (all-integer dynamics).
    "Bandit-v0": BanditEnv,
    # Token-level autoregressive generation: one episode = one generation,
    # scored at the terminal boundary.
    "TokenGen-v0": TokenGenEnv,
}


def list_envs() -> dict[str, list[str]]:
    """Every env id the port resolves, keyed by plane: ``"builtin"``, the
    numpy built-ins (:func:`make`), and ``"device"``, the batched
    on-device twins (``envs.device.make_device``, the anakin tier's
    ``actor.jax_env``)."""
    from relayrl_tpu_torch.envs.device import DEVICE_ENVS

    return {"builtin": sorted(_BUILTIN), "device": sorted(DEVICE_ENVS)}


def make(env_id: str, **kwargs):
    """Create a built-in env by id."""
    if env_id in _BUILTIN:
        return _BUILTIN[env_id](**kwargs)
    raise ValueError(f"unknown env {env_id!r}; built-ins: {sorted(_BUILTIN)}")


__all__ = ["make", "list_envs", "make_atari", "ALEUnavailableError",
           "AtariPreprocessing", "SyntheticPixelEnv", "BanditEnv", "Box", "CartPoleEnv",
           "Discrete", "GridWorldEnv", "PendulumEnv", "RecallEnv", "SyncVectorEnv",
           "TokenGenEnv"]
