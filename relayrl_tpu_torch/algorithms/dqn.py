"""DQN (+ double-Q).

Counterpart of :mod:`relayrl_tpu.algorithms.dqn`. One update: the Huber TD
loss (delta 1.0, mean over the batch, optax's ``huber_loss``) on Q(s, a)
against a double-Q target, one Adam step, and the polyak step of the target
network after it. Actors receive the Q-net as an epsilon-greedy
``qnet_discrete`` policy whose epsilon the learner anneals per publish.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from relayrl_tpu_torch.algorithms.base import register_algorithm
from relayrl_tpu_torch.algorithms.offpolicy import (
    EpsilonGreedyMixin,
    OffPolicyAlgorithm,
    polyak_update,
    target_of,
)
from relayrl_tpu_torch.algorithms.reinforce import _opt_step
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.models.mlp import _MASK_FILL, _compute_dtype
from relayrl_tpu_torch.models.q_networks import DiscreteQNet
from relayrl_tpu_torch.parallel.context import dp_mean, dp_sum


@dataclasses.dataclass
class DQNState:
    """The Q-net, its target, their Adam and the update count (the model
    version)."""

    params: nn.Module
    target_params: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0


def huber_loss(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """optax's ``huber_loss`` of the error ``x``, elementwise."""
    abs_x = x.abs()
    quadratic = torch.clamp(abs_x, max=delta)
    return 0.5 * quadratic.square() + delta * (abs_x - quadratic)


def take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[..., idx]`` along the last axis."""
    return values.gather(-1, idx.long()[..., None]).squeeze(-1)


def make_dqn_update(gamma: float, polyak: float, double_q: bool):
    """The ``(state, batch, noise) -> (state, metrics)`` update (DQN draws
    no noise). ``batch`` holds device tensors."""

    def update(state: DQNState, batch: Mapping[str, torch.Tensor], noise=None):
        obs, act, rew = batch["obs"], batch["act"], batch["rew"]
        obs2, mask2, done = batch["obs2"], batch["mask2"], batch["done"]
        with torch.no_grad():
            q2_target = state.target_params(obs2)
            if double_q:
                q2_online = state.params(obs2)
                a2 = torch.where(mask2 > 0, q2_online, _MASK_FILL).argmax(-1)
                next_q = take(q2_target, a2)
            else:
                next_q = torch.where(mask2 > 0, q2_target, _MASK_FILL).amax(-1)
            target = rew + gamma * (1.0 - done) * next_q
        with torch.enable_grad():
            q_a = take(state.params(obs), act)
            loss = dp_mean(huber_loss(q_a - target))
            _opt_step(state.opt, loss)
        polyak_update(state.params, state.target_params, polyak)
        loss, q_mean = dp_sum(loss.detach(), dp_mean(q_a.detach()))
        metrics = {"LossQ": loss, "QVals": q_mean}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return update


@register_algorithm("DQN")
class DQN(EpsilonGreedyMixin, OffPolicyAlgorithm):
    ALGO_NAME = "DQN"
    DEFAULT_DISCRETE = True

    def _setup(self, params: dict, learner: dict) -> None:
        eps0 = self._setup_epsilon(params)
        self.arch = {
            "kind": "qnet_discrete",
            "obs_dim": self.obs_dim,
            "act_dim": self.act_dim,
            "hidden_sizes": list(params.get("hidden_sizes", [128, 128])),
            "epsilon": eps0,
            "precision": str(learner.get("precision", "float32")),
        }
        pixel = self._pixel_trunk(params)
        self.policy = build_policy(self.arch, self.device)
        hidden = tuple(self.arch["hidden_sizes"])
        dtype = _compute_dtype(self.arch)
        self._module_fns = {"params": lambda: DiscreteQNet(
            self.obs_dim, self.act_dim, hidden, dtype, **pixel)}
        self.lr = float(params.get("lr", 1e-3))
        self.state = self.fresh_state(
            {"params": self.policy.init_params(self._init_generator)})
        self._update = make_dqn_update(self.gamma, self.polyak,
                                       bool(params.get("double_q", True)))

    def fresh_state(self, modules, rng=None) -> DQNState:
        net = modules["params"]
        return DQNState(params=net,
                        target_params=target_of(modules, "params"),
                        opt=torch.optim.Adam(net.parameters(), lr=self.lr))

    def _actor_module(self):
        return self.state.params
