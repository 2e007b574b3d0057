"""On-device environment registry: batched tensor twins of the built-ins.

Counterpart of :mod:`relayrl_tpu.envs.jax` (the JAX package's pure-JAX
envs). ``DEVICE_ENVS`` keeps its ``JAX_ENVS`` ids, which match the numpy
built-ins', so a config flips ``actor.host_mode`` between ``"vector"`` and
``"anakin"`` without renaming the task; the config key stays
``actor.jax_env``, since configs are shared with the JAX package.
:func:`make_device` resolves an id, and the fused rollout
(``runtime/anakin.py``) looks envs up through it.
"""

from relayrl_tpu_torch.envs.device.bandit import BanditState, DeviceBandit
from relayrl_tpu_torch.envs.device.base import DeviceEnv, step_autoreset, tree_where
from relayrl_tpu_torch.envs.device.cartpole import CartPoleState, DeviceCartPole
from relayrl_tpu_torch.envs.device.gridworld import DeviceGridWorld, GridWorldState
from relayrl_tpu_torch.envs.device.pendulum import DevicePendulum, PendulumState
from relayrl_tpu_torch.envs.device.recall import DeviceRecall, RecallState
from relayrl_tpu_torch.envs.device.tokengen import DeviceTokenGen, TokenGenState

DEVICE_ENVS = {
    "CartPole-v1": DeviceCartPole,
    "Pendulum-v1": DevicePendulum,
    "Recall-v0": DeviceRecall,
    "GridWorld-v0": DeviceGridWorld,
    "Bandit-v0": DeviceBandit,
    "TokenGen-v0": DeviceTokenGen,
}


def make_device(env_id: str, device=None, **kwargs) -> DeviceEnv:
    """Create an on-device env by id on ``device`` (default: the GPU;
    without one the caller must pass ``device="cpu"``)."""
    if env_id not in DEVICE_ENVS:
        raise ValueError(
            f"unknown device env {env_id!r}; on-device envs: "
            f"{sorted(DEVICE_ENVS)}")
    return DEVICE_ENVS[env_id](device=device, **kwargs)


__all__ = ["DeviceEnv", "DEVICE_ENVS", "make_device", "step_autoreset", "tree_where",
           "DeviceCartPole", "CartPoleState", "DevicePendulum", "PendulumState",
           "DeviceRecall", "RecallState", "DeviceGridWorld", "GridWorldState",
           "DeviceBandit", "BanditState", "DeviceTokenGen", "TokenGenState"]
