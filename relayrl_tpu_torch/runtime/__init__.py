"""Runtime: the single-agent actor, the vector actor host, the in-process
loop, the distributed loop (``TrainingServer`` in one process, ``Agent`` or
``VectorAgent`` in another) and the application contract."""

from relayrl_tpu_torch.runtime.agent import Agent, VectorAgent
from relayrl_tpu_torch.runtime.application import ApplicationAbstract
from relayrl_tpu_torch.runtime.local_runner import LocalRunner, reward_threshold_reached
from relayrl_tpu_torch.runtime.policy_actor import PolicyActor
from relayrl_tpu_torch.runtime.server import TrainingServer
from relayrl_tpu_torch.runtime.vector_actor import VectorActorHost

__all__ = ["Agent", "ApplicationAbstract", "LocalRunner", "PolicyActor",
           "TrainingServer", "VectorActorHost", "VectorAgent",
           "reward_threshold_reached"]
