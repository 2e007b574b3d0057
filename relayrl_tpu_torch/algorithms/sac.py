"""SAC with automatic entropy-temperature tuning.

Counterpart of :mod:`relayrl_tpu.algorithms.sac`. One update, in the JAX
package's order: alpha = exp(log_alpha) is read once, before anything
moves; the twin critics' soft-Bellman TD step (the next action drawn from
the current actor); the reparameterized squashed-Gaussian actor step
through the just-updated critics; the ``log_alpha`` step toward the target
entropy (``-act_dim`` by default) on the actor step's log-probs; then the
critics' polyak target step. Three Adams: critic, actor and ``log_alpha``.
The ``Alpha`` metric is the alpha the update used.
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
from relayrl_tpu_torch.models.q_networks import (
    SquashedGaussianActor,
    TwinQNet,
    squashed_gaussian_sample,
)
from relayrl_tpu_torch.parallel.context import dp_mean, dp_rows, dp_sum


class LogAlpha(nn.Module):
    """The temperature's log as a module, so a checkpoint restores it in
    place under its optimizer."""

    def __init__(self, value: torch.Tensor):
        super().__init__()
        self.value = nn.Parameter(value.detach().clone().float().reshape(()))


@dataclasses.dataclass
class SACState:
    actor_params: nn.Module
    critic_params: nn.Module
    target_critic_params: nn.Module
    log_alpha: LogAlpha
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    alpha_opt: torch.optim.Optimizer
    rng: torch.Tensor
    step: int = 0


def make_sac_update(act_limit: float, gamma: float, polyak: float,
                    target_entropy: float):
    """The ``(state, batch, noise) -> (state, metrics)`` update; ``noise``
    is ``(next_noise, pi_noise)``, the standard-normal draws ``[B,
    act_dim]`` behind the next action and the policy step's action."""

    def update(state: SACState, batch: Mapping[str, torch.Tensor], noise):
        obs, act, rew = batch["obs"], batch["act"], batch["rew"]
        obs2, done = batch["obs2"], batch["done"]
        # This process's rows of the batch's draws.
        next_noise, pi_noise = (dp_rows(n) for n in noise)
        alpha = torch.exp(state.log_alpha.value.detach())
        with torch.no_grad():
            mu2, log_std2 = state.actor_params(obs2)
            a2, logp_a2 = squashed_gaussian_sample(next_noise, mu2, log_std2,
                                                   act_limit)
            q1_t, q2_t = state.target_critic_params(obs2, a2)
            target = rew + gamma * (1.0 - done) * (
                torch.minimum(q1_t, q2_t) - alpha * logp_a2)
        with torch.enable_grad():
            q1, q2 = state.critic_params(obs, act)
            loss_q = dp_mean((q1 - target).square()) + dp_mean((q2 - target).square())
            _opt_step(state.critic_opt, loss_q)

            mu, log_std = state.actor_params(obs)
            a, logp_a = squashed_gaussian_sample(pi_noise, mu, log_std, act_limit)
            q1_pi, q2_pi = state.critic_params(obs, a)
            loss_pi = dp_mean(alpha * logp_a - torch.minimum(q1_pi, q2_pi))
            _opt_step(state.actor_opt, loss_pi)

            logp_a = logp_a.detach()
            loss_alpha = -dp_mean(torch.exp(state.log_alpha.value)
                                  * (logp_a + target_entropy))
            _opt_step(state.alpha_opt, loss_alpha)
        polyak_update(state.critic_params, state.target_critic_params, polyak)
        loss_q, loss_pi, q_mean, logp_mean = dp_sum(
            loss_q.detach(), loss_pi.detach(), dp_mean(q1.detach()), dp_mean(logp_a))
        metrics = {"LossQ": loss_q, "LossPi": loss_pi, "QVals": q_mean,
                   "Alpha": alpha, "LogPi": logp_mean}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return update


@register_algorithm("SAC")
class SAC(ActorCriticAlgorithm):
    ALGO_NAME = "SAC"
    CRITIC = TwinQNet
    ACTOR_LR = CRITIC_LR = 3e-4

    def _setup(self, params: dict, learner: dict) -> None:
        act_limit = float(params.get("act_limit", 1.0))
        arch = {
            "kind": "sac_continuous",
            "obs_dim": self.obs_dim,
            "act_dim": self.act_dim,
            "hidden_sizes": list(params.get("hidden_sizes", [128, 128])),
            "act_limit": act_limit,
            "precision": str(learner.get("precision", "float32")),
        }
        self.alpha_lr = float(params.get("alpha_lr", 3e-4))
        self.alpha0 = float(params.get("alpha", 0.2))
        hidden, dtype = tuple(arch["hidden_sizes"]), _compute_dtype(arch)
        self._setup_networks(params, learner, arch, lambda: SquashedGaussianActor(
            self.obs_dim, self.act_dim, hidden, dtype))
        self._module_fns["log_alpha"] = lambda: LogAlpha(torch.zeros(()))
        self._update = make_sac_update(
            act_limit, self.gamma, self.polyak,
            target_entropy=float(params.get("target_entropy",
                                            -float(self.act_dim))))

    def fresh_state(self, modules, rng=None) -> SACState:
        actor, critic = modules["actor_params"], modules["critic_params"]
        log_alpha = modules.get("log_alpha")
        if log_alpha is None:
            # f32 log of the f32 alpha, as jnp.log computes it
            log_alpha = LogAlpha(torch.log(torch.tensor(
                self.alpha0, dtype=torch.float32))).to(self.device)
        return SACState(
            actor_params=actor, critic_params=critic,
            target_critic_params=target_of(modules, "critic_params"),
            log_alpha=log_alpha,
            actor_opt=torch.optim.Adam(actor.parameters(), lr=self.actor_lr),
            critic_opt=torch.optim.Adam(critic.parameters(), lr=self.critic_lr),
            alpha_opt=torch.optim.Adam(log_alpha.parameters(), lr=self.alpha_lr),
            rng=seeded_rng(self.seed, 1, self.device) if rng is None else rng)

    def _draw_noise(self, state):
        shape = (self.batch_size, self.act_dim)
        next_noise, rng = draw_normal(state.rng, shape, self.device)
        pi_noise, rng = draw_normal(rng, shape, self.device)
        return (next_noise, pi_noise), dataclasses.replace(state, rng=rng)

    def _metric_keys(self):
        return ("LossQ", "LossPi", "QVals", "Alpha", "LogPi")
