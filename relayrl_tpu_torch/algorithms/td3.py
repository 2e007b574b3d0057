"""TD3.

Counterpart of :mod:`relayrl_tpu.algorithms.td3`: clipped double-Q (twin
critics, min target), target-policy smoothing (clipped Gaussian noise on
the target action) and delayed policy updates. The actor step and both
polyak target steps run on the updates whose version before the update is
a multiple of ``policy_delay`` (the JAX package's ``state.step %
policy_delay == 0``); the version is a host counter, so the branch costs no
device read. ``LossPi`` is 0 on the other updates.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from relayrl_tpu_torch.algorithms.base import register_algorithm
from relayrl_tpu_torch.algorithms.ddpg import ActorCriticAlgorithm
from relayrl_tpu_torch.algorithms.offpolicy import (
    draw_normal,
    polyak_update,
    seeded_rng,
    target_of,
)
from relayrl_tpu_torch.algorithms.reinforce import _opt_step
from relayrl_tpu_torch.models.mlp import _compute_dtype
from relayrl_tpu_torch.models.q_networks import DeterministicActor, TwinQNet
from relayrl_tpu_torch.parallel.context import dp_mean, dp_rows, dp_sum


@dataclasses.dataclass
class TD3State:
    actor_params: nn.Module
    critic_params: nn.Module
    target_actor_params: nn.Module
    target_critic_params: nn.Module
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    rng: torch.Tensor
    step: int = 0


def make_td3_update(act_limit: float, gamma: float, polyak: float,
                    target_noise: float, noise_clip: float, policy_delay: int):
    """The ``(state, batch, noise) -> (state, metrics)`` update; ``noise``
    is the standard-normal draw ``[B, act_dim]`` behind the smoothing
    noise."""

    def update(state: TD3State, batch: Mapping[str, torch.Tensor],
               noise: torch.Tensor):
        obs, act, rew = batch["obs"], batch["act"], batch["rew"]
        obs2, done = batch["obs2"], batch["done"]
        noise = dp_rows(noise)  # this process's rows of the batch's draw
        with torch.no_grad():
            a2 = state.target_actor_params(obs2)
            smooth = torch.clamp(target_noise * noise.to(a2.dtype),
                                 -noise_clip, noise_clip)
            a2 = torch.clamp(a2 + smooth, -act_limit, act_limit)
            q1_t, q2_t = state.target_critic_params(obs2, a2)
            target = rew + gamma * (1.0 - done) * torch.minimum(q1_t, q2_t)
        with torch.enable_grad():
            q1, q2 = state.critic_params(obs, act)
            loss_q = dp_mean((q1 - target).square()) + dp_mean((q2 - target).square())
            _opt_step(state.critic_opt, loss_q)
            if state.step % policy_delay == 0:
                q1_pi = state.critic_params.q1(obs, state.actor_params(obs))
                loss_pi = -dp_mean(q1_pi)
                _opt_step(state.actor_opt, loss_pi)
                loss_pi = loss_pi.detach()
                polyak_update(state.actor_params, state.target_actor_params, polyak)
                polyak_update(state.critic_params, state.target_critic_params, polyak)
            else:
                loss_pi = torch.zeros((), device=q1.device)
        loss_q, loss_pi, q_mean = dp_sum(loss_q.detach(), loss_pi,
                                         dp_mean(q1.detach()))
        metrics = {"LossQ": loss_q, "LossPi": loss_pi, "QVals": q_mean}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return update


@register_algorithm("TD3")
class TD3(ActorCriticAlgorithm):
    ALGO_NAME = "TD3"
    CRITIC = TwinQNet

    def _setup(self, params: dict, learner: dict) -> None:
        act_limit = float(params.get("act_limit", 1.0))
        arch = {
            "kind": "ddpg_continuous",
            "obs_dim": self.obs_dim,
            "act_dim": self.act_dim,
            "hidden_sizes": list(params.get("hidden_sizes", [128, 128])),
            "act_limit": act_limit,
            "act_noise": float(params.get("act_noise", 0.1)),
            "precision": str(learner.get("precision", "float32")),
        }
        hidden, dtype = tuple(arch["hidden_sizes"]), _compute_dtype(arch)
        self._setup_networks(params, learner, arch, lambda: DeterministicActor(
            self.obs_dim, self.act_dim, act_limit, hidden, dtype))
        self._update = make_td3_update(
            act_limit, self.gamma, self.polyak,
            target_noise=float(params.get("target_noise", 0.2)),
            noise_clip=float(params.get("noise_clip", 0.5)),
            policy_delay=int(params.get("policy_delay", 2)))

    def fresh_state(self, modules, rng=None) -> TD3State:
        actor, critic = modules["actor_params"], modules["critic_params"]
        return TD3State(
            actor_params=actor, critic_params=critic,
            target_actor_params=target_of(modules, "actor_params"),
            target_critic_params=target_of(modules, "critic_params"),
            actor_opt=torch.optim.Adam(actor.parameters(), lr=self.actor_lr),
            critic_opt=torch.optim.Adam(critic.parameters(), lr=self.critic_lr),
            rng=seeded_rng(self.seed, 1, self.device) if rng is None else rng)

    def _draw_noise(self, state):
        noise, rng = draw_normal(state.rng, (self.batch_size, self.act_dim),
                                 self.device)
        return noise, dataclasses.replace(state, rng=rng)
