"""C51 (categorical distributional DQN).

Counterpart of :mod:`relayrl_tpu.algorithms.c51`. The categorical
projection of the Bellman-updated support onto the fixed atom grid is two
one-hot products, as in the JAX package; then the cross-entropy, one Adam
step and the polyak step of the target network.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from relayrl_tpu_torch.algorithms.base import register_algorithm
from relayrl_tpu_torch.algorithms.dqn import DQNState
from relayrl_tpu_torch.algorithms.offpolicy import (
    EpsilonGreedyMixin,
    OffPolicyAlgorithm,
    polyak_update,
    target_of,
)
from relayrl_tpu_torch.algorithms.reinforce import _opt_step
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.models.mlp import _MASK_FILL, _compute_dtype
from relayrl_tpu_torch.models.q_networks import DistributionalQNet, c51_support

C51State = DQNState


def categorical_projection(support: torch.Tensor, probs: torch.Tensor,
                           rew: torch.Tensor, done: torch.Tensor,
                           gamma: float) -> torch.Tensor:
    """Project ``T z = r + gamma (1 - d) z`` back onto ``support``.

    ``probs [B, N]`` is the next-state distribution of the chosen action;
    returns the projected target distribution ``[B, N]``. Each source atom
    splits its mass between the floor and ceil neighbours of its updated
    position; one that lands exactly on an atom (floor == ceil) gives all
    of it to that atom."""
    n = support.shape[0]
    v_min, v_max = support[0], support[-1]
    dz = (v_max - v_min) / (n - 1)
    tz = torch.clamp(rew[:, None] + gamma * (1.0 - done[:, None]) * support[None],
                     v_min, v_max)
    b = (tz - v_min) / dz
    low, high = torch.floor(b), torch.ceil(b)
    w_low = (high - b) + (low == high).to(b.dtype)
    w_high = b - low
    # jax.nn.one_hot's comparison form: an index the rounding of b pushes
    # past the last atom (b a hair above n - 1) gives a zero row, as in the
    # JAX package, where F.one_hot would assert on the device.
    bins = torch.arange(n, device=b.device)
    onehot_low = (low.long()[..., None] == bins).to(b.dtype)
    onehot_high = (high.long()[..., None] == bins).to(b.dtype)
    return (torch.einsum("bj,bjn->bn", probs * w_low, onehot_low)
            + torch.einsum("bj,bjn->bn", probs * w_high, onehot_high))


def make_c51_update(support: torch.Tensor, gamma: float, polyak: float):
    """The ``(state, batch, noise) -> (state, metrics)`` update (C51 draws
    no noise)."""

    def update(state: C51State, batch: Mapping[str, torch.Tensor], noise=None):
        obs, act, rew = batch["obs"], batch["act"], batch["rew"]
        obs2, mask2, done = batch["obs2"], batch["mask2"], batch["done"]
        atoms = support.to(obs.device)  # a no-op on the learner's device
        with torch.no_grad():
            probs2 = torch.softmax(state.target_params(obs2), dim=-1)  # [B, A, N]
            q2 = (probs2 * atoms).sum(dim=-1)                          # [B, A]
            a2 = torch.where(mask2 > 0, q2, _MASK_FILL).argmax(-1)
            probs2_a = probs2.gather(
                1, a2[:, None, None].expand(-1, 1, probs2.shape[-1])).squeeze(1)
            target_dist = categorical_projection(atoms, probs2_a, rew, done, gamma)
        with torch.enable_grad():
            logp = torch.log_softmax(state.params(obs), dim=-1)
            logp_a = logp.gather(
                1, act.long()[:, None, None].expand(-1, 1, logp.shape[-1])).squeeze(1)
            loss = -(target_dist * logp_a).sum(dim=-1).mean()
            _opt_step(state.opt, loss)
        polyak_update(state.params, state.target_params, polyak)
        q_a = (torch.exp(logp_a.detach()) * atoms).sum(dim=-1)
        metrics = {"LossQ": loss.detach(), "QVals": q_a.mean()}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return update


@register_algorithm("C51")
class C51(EpsilonGreedyMixin, OffPolicyAlgorithm):
    ALGO_NAME = "C51"
    DEFAULT_DISCRETE = True

    def _setup(self, params: dict, learner: dict) -> None:
        eps0 = self._setup_epsilon(params)
        n_atoms = int(params.get("n_atoms", 51))
        self.arch = {
            "kind": "c51_discrete",
            "obs_dim": self.obs_dim,
            "act_dim": self.act_dim,
            "hidden_sizes": list(params.get("hidden_sizes", [128, 128])),
            "n_atoms": n_atoms,
            "v_min": float(params.get("v_min", -10.0)),
            "v_max": float(params.get("v_max", 10.0)),
            "epsilon": eps0,
            "precision": str(learner.get("precision", "float32")),
        }
        pixel = self._pixel_trunk(params)
        self.policy = build_policy(self.arch, self.device)
        hidden = tuple(self.arch["hidden_sizes"])
        dtype = _compute_dtype(self.arch)
        self._module_fns = {"params": lambda: DistributionalQNet(
            self.obs_dim, self.act_dim, n_atoms, hidden, dtype, **pixel)}
        self.lr = float(params.get("lr", 1e-3))
        self.support = c51_support(self.arch, self.device)
        self.state = self.fresh_state(
            {"params": self.policy.init_params(self._init_generator)})
        self._update = make_c51_update(self.support, self.gamma, self.polyak)

    def fresh_state(self, modules, rng=None) -> C51State:
        net = modules["params"]
        return C51State(params=net,
                        target_params=target_of(modules, "params"),
                        opt=torch.optim.Adam(net.parameters(), lr=self.lr))

    def _actor_module(self):
        return self.state.params
