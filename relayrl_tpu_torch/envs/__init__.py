"""Built-in environments: the classic-control tasks, the memory task, the
Atari-style pixel pipeline and the vector env (copies of the JAX package's
numpy envs), and
:func:`make`, the built-in branch of :func:`relayrl_tpu.envs.make`
(the port does not depend on Gymnasium)."""

from relayrl_tpu_torch.envs.atari import (
    ALEUnavailableError,
    AtariPreprocessing,
    SyntheticPixelEnv,
    make_atari,
)
from relayrl_tpu_torch.envs.classic import CartPoleEnv, PendulumEnv
from relayrl_tpu_torch.envs.memory import RecallEnv
from relayrl_tpu_torch.envs.spaces import Box, Discrete
from relayrl_tpu_torch.envs.vector import SyncVectorEnv

_BUILTIN = {
    "CartPole-v1": CartPoleEnv,
    "Pendulum-v1": PendulumEnv,
    # Memory task (no Gymnasium counterpart): built-in only.
    "Recall-v0": RecallEnv,
}


def make(env_id: str, **kwargs):
    """Create a built-in env by id."""
    if env_id in _BUILTIN:
        return _BUILTIN[env_id](**kwargs)
    raise ValueError(f"unknown env {env_id!r}; built-ins: {sorted(_BUILTIN)}")


__all__ = ["make", "make_atari", "ALEUnavailableError", "AtariPreprocessing",
           "SyntheticPixelEnv", "Box", "CartPoleEnv", "Discrete", "PendulumEnv", "RecallEnv",
           "SyncVectorEnv"]
