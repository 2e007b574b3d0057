"""Runtime: the single-agent actor and the vector actor host."""

from relayrl_tpu_torch.runtime.policy_actor import PolicyActor
from relayrl_tpu_torch.runtime.vector_actor import VectorActorHost

__all__ = ["PolicyActor", "VectorActorHost"]
