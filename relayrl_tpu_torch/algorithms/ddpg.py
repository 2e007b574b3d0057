"""DDPG.

Counterpart of :mod:`relayrl_tpu.algorithms.ddpg`. One update: the critic's
TD step, the deterministic-policy-gradient actor step (maximizing
Q(s, mu(s)) through the just-updated critic), then both polyak target
steps. Actors receive the deterministic actor as a ``ddpg_continuous``
policy; exploration noise rides the arch.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from relayrl_tpu_torch.algorithms.base import register_algorithm
from relayrl_tpu_torch.algorithms.offpolicy import (
    OffPolicyAlgorithm,
    polyak_update,
    target_of,
)
from relayrl_tpu_torch.algorithms.reinforce import _opt_step
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.models.mlp import _compute_dtype, init_module
from relayrl_tpu_torch.models.q_networks import DeterministicActor, QValueNet
from relayrl_tpu_torch.parallel.context import dp_mean, dp_sum


@dataclasses.dataclass
class DDPGState:
    actor_params: nn.Module
    critic_params: nn.Module
    target_actor_params: nn.Module
    target_critic_params: nn.Module
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    step: int = 0


def make_ddpg_update(gamma: float, polyak: float):
    """The ``(state, batch, noise) -> (state, metrics)`` update (DDPG draws
    no noise)."""

    def update(state: DDPGState, batch: Mapping[str, torch.Tensor], noise=None):
        obs, act, rew = batch["obs"], batch["act"], batch["rew"]
        obs2, done = batch["obs2"], batch["done"]
        with torch.no_grad():
            a2 = state.target_actor_params(obs2)
            q2 = state.target_critic_params(obs2, a2)
            target = rew + gamma * (1.0 - done) * q2
        with torch.enable_grad():
            q = state.critic_params(obs, act)
            loss_q = dp_mean((q - target).square())
            _opt_step(state.critic_opt, loss_q)
            loss_pi = -dp_mean(state.critic_params(obs, state.actor_params(obs)))
            _opt_step(state.actor_opt, loss_pi)
        polyak_update(state.actor_params, state.target_actor_params, polyak)
        polyak_update(state.critic_params, state.target_critic_params, polyak)
        loss_q, loss_pi, q_mean = dp_sum(loss_q.detach(), loss_pi.detach(),
                                         dp_mean(q.detach()))
        metrics = {"LossQ": loss_q, "LossPi": loss_pi, "QVals": q_mean}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return update


class ActorCriticAlgorithm(OffPolicyAlgorithm):
    """The continuous-control family's shared setup: an actor, a critic
    (single or twin) and their targets, each network with its own Adam."""

    DEFAULT_DISCRETE = False
    CRITIC = QValueNet
    ACTOR_LR = CRITIC_LR = 1e-3

    def _setup_networks(self, params: dict, learner: dict, arch: dict,
                        actor_fn) -> None:
        self.arch = arch
        self.policy = build_policy(self.arch, self.device)
        hidden = tuple(self.arch["hidden_sizes"])
        dtype = _compute_dtype(self.arch)
        critic = self.CRITIC
        self._module_fns = {
            "actor_params": actor_fn,
            "critic_params": lambda: critic(self.obs_dim, self.act_dim, hidden, dtype)}
        self.actor_lr = float(params.get("pi_lr", self.ACTOR_LR))
        self.critic_lr = float(params.get("q_lr", self.CRITIC_LR))
        self.act_limit = float(params.get("act_limit", 1.0))
        self.state = self.fresh_state({
            "actor_params": self.policy.init_params(self._init_generator),
            "critic_params": init_module(self._module_fns["critic_params"](),
                                         self._init_generator).to(self.device)})

    def _actor_module(self):
        return self.state.actor_params

    def _metric_keys(self):
        return ("LossQ", "LossPi", "QVals")


@register_algorithm("DDPG")
class DDPG(ActorCriticAlgorithm):
    ALGO_NAME = "DDPG"

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
        self._update = make_ddpg_update(self.gamma, self.polyak)

    def fresh_state(self, modules, rng=None) -> DDPGState:
        actor, critic = modules["actor_params"], modules["critic_params"]
        return DDPGState(
            actor_params=actor, critic_params=critic,
            target_actor_params=target_of(modules, "actor_params"),
            target_critic_params=target_of(modules, "critic_params"),
            actor_opt=torch.optim.Adam(actor.parameters(), lr=self.actor_lr),
            critic_opt=torch.optim.Adam(critic.parameters(), lr=self.critic_lr))
