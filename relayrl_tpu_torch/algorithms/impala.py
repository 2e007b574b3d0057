"""IMPALA-style async A2C with V-trace.

Counterpart of :mod:`relayrl_tpu.algorithms.impala`: a learner for a fleet
of async actors running stale policies. Each trajectory carries the
behavior policy's ``logp_a``; the update importance-weights it to the
current policy with clipped V-trace ratios, then takes one combined A2C
step (policy gradient on the rho-clipped advantage + value MSE to the
``vs`` targets + entropy bonus) with a single optimizer.

One update is one evaluate and one backward: the V-trace targets are
computed on detached ``logp`` and ``v`` (JAX's ``stop_gradient``), the
gradients are clipped by their global norm with optax's rule (scaled by
``max_norm / norm`` only when ``norm >= max_norm``;
``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)``
and so moves every clipped update), then one Adam step. The clip is a
``torch.where`` on the device, with no host read.

Staleness tolerance is the point: ``receive_trajectory`` trains on every
``traj_per_epoch`` batch whichever model version produced it, and the
server publishes after every update.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from relayrl_tpu_torch.algorithms.base import register_algorithm
from relayrl_tpu_torch.algorithms.onpolicy import OnPolicyAlgorithm
from relayrl_tpu_torch.models import apply_arch_overrides, build_policy
from relayrl_tpu_torch.ops.gae import masked_mean_std
from relayrl_tpu_torch.ops.vtrace import vtrace
from relayrl_tpu_torch.parallel.context import dp_gradients, dp_sum


@dataclasses.dataclass
class ImpalaState:
    """Params module, the one Adam (None when every parameter is frozen)
    and the update count, which doubles as the model version."""

    params: nn.Module
    opt: torch.optim.Optimizer | None
    step: int = 0


def make_impala_optimizer(params: nn.Module, lr: float, freeze=()):
    """One Adam over every parameter that ``freeze`` (the
    ``learner.freeze`` regex patterns) leaves trainable, or None."""
    from relayrl_tpu_torch.algorithms.freeze import frozen_names

    frozen = frozen_names(params, freeze) if freeze else set()
    train = [p for name, p in params.named_parameters() if name not in frozen]
    return torch.optim.Adam(train, lr=lr) if train else None


def clip_by_global_norm(grads: list[torch.Tensor],
                        max_norm: float) -> list[torch.Tensor]:
    """optax's ``clip_by_global_norm``: ``g`` while the global norm is
    below ``max_norm``, else ``(g / norm) * max_norm``."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for g in grads]


def make_impala_update(policy, gamma: float, vf_coef: float, ent_coef: float,
                       rho_bar: float, c_bar: float, max_grad_norm: float):
    """The ``(state, batch) -> (state, metrics)`` update. The learning rate
    and the freeze mask live in the state's optimizer
    (:func:`make_impala_optimizer`)."""

    def update(state: ImpalaState, batch: Mapping[str, torch.Tensor]):
        params = state.params
        obs, act, act_mask = batch["obs"], batch["act"], batch["act_mask"]
        rew, valid = batch["rew"], batch["valid"]
        behavior_logp, last_val = batch["logp"], batch["last_val"]
        # The global batch's count: under a data-parallel group each
        # process's losses are its rows' sums over it.
        n_valid, = dp_sum(valid.sum())
        n_valid = n_valid.clamp_min(1.0)

        with torch.enable_grad():
            logp, ent, v = policy.evaluate(params, obs, act, act_mask)
            vt = vtrace(behavior_logp, logp.detach(), rew, v.detach(), valid,
                        gamma, last_val=last_val, rho_bar=rho_bar,
                        c_bar=c_bar)
            pg_loss = -(logp * vt.pg_adv * valid).sum() / n_valid
            vf_loss = ((v - vt.vs).square() * valid).sum() / n_valid
            ent_mean = (ent * valid).sum() / n_valid
            total = pg_loss + vf_coef * vf_loss - ent_coef * ent_mean
            if state.opt is not None:
                train = [p for group in state.opt.param_groups
                         for p in group["params"]]
                # Summed over the data-parallel group before the clip, so
                # the clip reads the global norm.
                grads = dp_gradients(total, train)
                for param, grad in zip(train,
                                       clip_by_global_norm(grads,
                                                           max_grad_norm)):
                    param.grad = grad
                state.opt.step()
                state.opt.zero_grad(set_to_none=True)

        rho_mean, _ = masked_mean_std(vt.rho, valid)
        kl = ((behavior_logp - logp.detach()) * valid).sum() / n_valid
        # Each process's shares of the global means, summed.
        pg_loss, vf_loss, ent_mean, total, kl = dp_sum(
            pg_loss.detach(), vf_loss.detach(), ent_mean.detach(), total.detach(), kl)
        metrics = {
            "LossPi": pg_loss,
            "LossV": vf_loss,
            "Entropy": ent_mean,
            "LossTotal": total,
            "RhoMean": rho_mean,
            "KL": kl,
        }
        return dataclasses.replace(state, step=state.step + 1), metrics

    return update


@register_algorithm("IMPALA")
class IMPALA(OnPolicyAlgorithm):
    """Host orchestration: the epoch-buffer ingest of REINFORCE and PPO,
    with the staleness-corrected update."""

    ALGO_NAME = "IMPALA"

    def _setup(self, params: dict, learner: dict,
               generator: torch.Generator) -> None:
        # obs_shape implies the pixel trunk, as in PPO; an explicit
        # model_kind (e.g. transformer_discrete) still wins.
        default_kind = ("cnn_discrete" if "obs_shape" in params
                        else "mlp_discrete" if self.discrete
                        else "mlp_continuous")
        kind = str(params.get("model_kind", default_kind))
        self.arch = {
            "kind": kind,
            "obs_dim": self.obs_dim,
            "act_dim": self.act_dim,
            "hidden_sizes": list(params.get("hidden_sizes", [128, 128])),
            "has_critic": True,
            "precision": str(learner.get("precision", "float32")),
        }
        if kind == "cnn_discrete" and "obs_shape" in params:
            self.arch["obs_shape"] = list(params["obs_shape"])
            for key in ("conv_spec", "dense", "scale_obs"):
                if key in params:
                    self.arch[key] = params[key]
        apply_arch_overrides(self.arch, params)
        self.policy = build_policy(self.arch, self.device)

        net_params = self.policy.init_params(generator)
        self.freeze = self._resolve_freeze(params, learner, net_params)
        self.lr = float(params.get("lr", 3e-4))
        self._update_kwargs = {
            "gamma": self.gamma,
            "vf_coef": float(params.get("vf_coef", 0.5)),
            "ent_coef": float(params.get("ent_coef", 0.01)),
            "rho_bar": float(params.get("rho_bar", 1.0)),
            "c_bar": float(params.get("c_bar", 1.0)),
            "max_grad_norm": float(params.get("max_grad_norm", 40.0))}
        self.state = self.fresh_state(net_params)
        self._update = self.make_update(self.policy)

    def fresh_state(self, params: nn.Module) -> ImpalaState:
        """A state over ``params`` with fresh Adam at this learner's rate
        and freeze mask."""
        return ImpalaState(params=params,
                           opt=make_impala_optimizer(params, self.lr,
                                                     self.freeze))

    def make_update(self, policy):
        """This learner's update through ``policy`` (the CPU tests and the
        card's checks build one per device)."""
        return make_impala_update(policy, **self._update_kwargs)

    def _log_keys(self):
        return ("LossPi", "LossV", "Entropy", "RhoMean", "KL")
