"""Learner algorithms.

Importing this package registers the ported algorithms with the registry
(:func:`build_algorithm` resolves them by name, as in the JAX package).
"""

from relayrl_tpu_torch.algorithms.base import (
    AlgorithmBase,
    build_algorithm,
    register_algorithm,
    registered_algorithms,
)
from relayrl_tpu_torch.algorithms.c51 import C51, C51State
from relayrl_tpu_torch.algorithms.ddpg import DDPG, DDPGState
from relayrl_tpu_torch.algorithms.dqn import DQN, DQNState
from relayrl_tpu_torch.algorithms.impala import IMPALA, ImpalaState
from relayrl_tpu_torch.algorithms.offpolicy import OffPolicyAlgorithm
from relayrl_tpu_torch.algorithms.ppo import PPO, PPOState
from relayrl_tpu_torch.algorithms.reinforce import REINFORCE, ReinforceState
from relayrl_tpu_torch.algorithms.sac import SAC, SACState
from relayrl_tpu_torch.algorithms.td3 import TD3, TD3State

__all__ = [
    "AlgorithmBase",
    "build_algorithm",
    "register_algorithm",
    "registered_algorithms",
    "C51",
    "C51State",
    "DDPG",
    "DDPGState",
    "DQN",
    "DQNState",
    "IMPALA",
    "ImpalaState",
    "OffPolicyAlgorithm",
    "PPO",
    "PPOState",
    "REINFORCE",
    "ReinforceState",
    "SAC",
    "SACState",
    "TD3",
    "TD3State",
]
