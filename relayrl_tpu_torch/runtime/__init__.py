"""Runtime: the single-agent actor, the vector actor host, the in-process
loop and the application contract."""

from relayrl_tpu_torch.runtime.application import ApplicationAbstract
from relayrl_tpu_torch.runtime.local_runner import LocalRunner, reward_threshold_reached
from relayrl_tpu_torch.runtime.policy_actor import PolicyActor
from relayrl_tpu_torch.runtime.vector_actor import VectorActorHost

__all__ = ["ApplicationAbstract", "LocalRunner", "PolicyActor", "VectorActorHost",
           "reward_threshold_reached"]
