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
from relayrl_tpu_torch.algorithms.reinforce import REINFORCE, ReinforceState

__all__ = [
    "AlgorithmBase",
    "build_algorithm",
    "register_algorithm",
    "registered_algorithms",
    "REINFORCE",
    "ReinforceState",
]
