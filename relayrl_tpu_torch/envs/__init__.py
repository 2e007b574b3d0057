"""Built-in environments the serving slice runs: the memory task and the
stacked-env driver (copies of the JAX package's numpy envs)."""

from relayrl_tpu_torch.envs.memory import RecallEnv
from relayrl_tpu_torch.envs.spaces import Box, Discrete
from relayrl_tpu_torch.envs.vector import SyncVectorEnv

__all__ = ["Box", "Discrete", "RecallEnv", "SyncVectorEnv"]
