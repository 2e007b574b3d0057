"""REINFORCE (vanilla policy gradient) ± value baseline.

Counterpart of :mod:`relayrl_tpu.algorithms.reinforce`. One epoch update
on a padded ``[B, T]`` batch, in the reference's order:

1. GAE-λ advantages (rewards-to-go without a baseline) and return
   targets;
2. advantage normalization;
3. one policy step, ``-(logp * adv).mean()`` over the valid steps;
4. ``pi_loss_after``, 5. ``vf_loss_before``;
6. ``train_vf_iters`` value steps on the squared error to the returns;
7. ``vf_loss_after``;
8. the eight metrics (``LossPi``, ``DeltaLossPi``, ``KL``, ``Entropy``,
   ``LossV``, ``DeltaLossV``, ``AdvMean``, ``AdvStd``) as 0-d tensors.

Two ``torch.optim.Adam`` take optax's ``multi_transform`` partition: one
over the ``pi``-labelled parameters, one over the ``vf``-labelled ones,
labelled by top-level module name; frozen parameters are in neither.
optax's Adam defaults (b1 0.9, b2 0.999, eps 1e-8) are torch's. The
update moves the parameters in place.

Each step takes its gradient with ``torch.autograd.grad`` over its own
optimizer's parameters only, so a value step's backward stops at the value
head and never runs through the trunk (XLA drops that gradient too: the
policy optimizer's ``set_to_zero`` discards it). Per update that is 84
forwards through the trunk at ``train_vf_iters`` 80 (one flash forward per
layer each) and one trunk backward (one dq and one dk/dv pass per layer).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from relayrl_tpu_torch.algorithms.base import register_algorithm
from relayrl_tpu_torch.algorithms.onpolicy import OnPolicyAlgorithm
from relayrl_tpu_torch.models import apply_arch_overrides, build_policy
from relayrl_tpu_torch.ops import gae_advantages, masked_mean_std, normalize_advantages
from relayrl_tpu_torch.parallel.context import dp_gradients, dp_sum


@dataclasses.dataclass
class ReinforceState:
    """Params module, the two optimizers (which hold optax's opt states:
    Adam's moments and step counts) and the update count, which doubles
    as the model version. An optimizer is None when its partition is
    empty."""

    params: nn.Module
    pi_opt: torch.optim.Optimizer | None
    vf_opt: torch.optim.Optimizer | None
    step: int = 0


def _param_labels(params: nn.Module) -> dict[str, str]:
    """Label each parameter 'pi' or 'vf' by its top-level module name."""
    return {name: "vf" if name.startswith("vf") else "pi"
            for name, _ in params.named_parameters()}


def make_optimizers(params: nn.Module, pi_lr: float, vf_lr: float, freeze=()):
    """The (pi, vf) Adam pair over one module, partitioned by the pi/vf
    labels. ``freeze`` (regex strings over flax leaf paths, the
    ``learner.freeze`` knob) leaves the matching parameters out of both,
    so they never move."""
    from relayrl_tpu_torch.algorithms.freeze import frozen_names

    frozen = frozen_names(params, freeze) if freeze else set()
    labels = _param_labels(params)
    groups = {"pi": [], "vf": []}
    for name, param in params.named_parameters():
        if name not in frozen:
            groups[labels[name]].append(param)
    return tuple(torch.optim.Adam(groups[label], lr=lr) if groups[label] else None
                 for label, lr in (("pi", pi_lr), ("vf", vf_lr)))


def _opt_step(opt: torch.optim.Optimizer | None, loss: torch.Tensor) -> None:
    """One Adam step on ``loss`` over ``opt``'s parameters alone, its
    gradients summed over the data-parallel group
    (:func:`~relayrl_tpu_torch.parallel.context.dp_gradients`; a parameter
    the loss does not reach takes a zero gradient, as in optax, so every
    Adam moment and step count advances together)."""
    if opt is None:
        return
    params = [p for group in opt.param_groups for p in group["params"]]
    for param, grad in zip(params, dp_gradients(loss, params)):
        param.grad = grad
    opt.step()
    opt.zero_grad(set_to_none=True)


def make_reinforce_update(policy, train_vf_iters: int, gamma: float,
                          lam: float, with_baseline: bool):
    """The ``(state, batch) -> (state, metrics)`` epoch update. The
    learning rates and the freeze mask live in the state's optimizers
    (:func:`make_optimizers`). ``batch`` holds device tensors."""

    def update(state: ReinforceState, batch: Mapping[str, torch.Tensor]):
        params = state.params
        obs, act, act_mask = batch["obs"], batch["act"], batch["act_mask"]
        rew, val, valid = batch["rew"], batch["val"], batch["valid"]
        last_val = batch["last_val"]

        if with_baseline:
            adv, ret = gae_advantages(rew, val, valid, gamma, lam, last_val)
        else:
            # Without a baseline the advantage IS the reward-to-go.
            adv, ret = gae_advantages(rew, torch.zeros_like(val), valid,
                                      gamma, 1.0, torch.zeros_like(last_val))
        adv = normalize_advantages(adv, valid)
        # The global batch's count: under a data-parallel group each
        # process's losses are its rows' sums over it.
        n_valid, = dp_sum(valid.sum())
        n_valid = n_valid.clamp_min(1.0)

        def evaluate():
            return policy.evaluate(params, obs, act, act_mask)

        def pi_loss(logp):
            return -(logp * adv * valid).sum() / n_valid

        def vf_loss(v):
            return ((v - ret).square() * valid).sum() / n_valid

        zero = torch.zeros((), device=valid.device)
        with torch.enable_grad():
            # --- policy step (one, as in the reference) ---
            logp_new, ent, _ = evaluate()
            loss_pi = pi_loss(logp_new)
            _opt_step(state.pi_opt, loss_pi)
            with torch.no_grad():
                # Diagnostics: approx KL vs the behavior log-probs stored
                # at sample time, mean entropy, post-update Δloss.
                approx_kl = ((batch["logp"] - logp_new) * valid).sum() / n_valid
                entropy = (ent * valid).sum() / n_valid
                pi_loss_after = pi_loss(evaluate()[0])
                vf_loss_before = vf_loss(evaluate()[2]) if with_baseline else zero
            # --- value steps ---
            if with_baseline:
                for _ in range(train_vf_iters):
                    _opt_step(state.vf_opt, vf_loss(evaluate()[2]))
                with torch.no_grad():
                    vf_loss_after = vf_loss(evaluate()[2])
            else:
                vf_loss_after = zero

        adv_mean, adv_std = masked_mean_std(adv, valid)
        # Each process's shares of the global means, summed.
        loss_pi, pi_loss_after, approx_kl, entropy, vf_loss_before, vf_loss_after = dp_sum(
            loss_pi.detach(), pi_loss_after, approx_kl, entropy, vf_loss_before,
            vf_loss_after)
        metrics = {
            "LossPi": loss_pi,
            "DeltaLossPi": pi_loss_after - loss_pi,
            "KL": approx_kl,
            "Entropy": entropy,
            "LossV": vf_loss_before,
            "DeltaLossV": vf_loss_after - vf_loss_before,
            "AdvMean": adv_mean,
            "AdvStd": adv_std,
        }
        return dataclasses.replace(state, step=state.step + 1), metrics

    return update


@register_algorithm("REINFORCE")
class REINFORCE(OnPolicyAlgorithm):
    """Host-side REINFORCE orchestration, with the JAX package's ctor:
    ``REINFORCE(env_dir, config_path, obs_dim, act_dim, buf_size,
    logger_kwargs, device, **hyperparam overrides)``."""

    ALGO_NAME = "REINFORCE"

    def _setup(self, params: dict, learner: dict,
               generator: torch.Generator) -> None:
        self.with_baseline = bool(params.get("with_vf_baseline", False))
        self.gamma = float(params.get("gamma", 0.98))
        self.lam = float(params.get("lam", 0.97))

        self.arch = {
            "kind": str(params.get(
                "model_kind",
                "mlp_discrete" if self.discrete else "mlp_continuous")),
            "obs_dim": self.obs_dim,
            "act_dim": self.act_dim,
            "hidden_sizes": list(params.get("hidden_sizes", [128, 128])),
            "activation": "tanh",
            "has_critic": self.with_baseline,
            # learner.precision -> compute dtype; actors inherit it through
            # the arch so learner and actors agree.
            "precision": str(learner.get("precision", "float32")),
        }
        apply_arch_overrides(self.arch, params)
        self.policy = build_policy(self.arch, self.device)

        self.pi_lr = float(params.get("pi_lr", 3e-4))
        self.vf_lr = float(params.get("vf_lr", 1e-3))
        self.train_vf_iters = int(params.get("train_vf_iters", 80))

        net_params = self.policy.init_params(generator)
        freeze = self._resolve_freeze(params, learner, net_params)
        self._update = make_reinforce_update(
            self.policy,
            train_vf_iters=self.train_vf_iters,
            gamma=self.gamma,
            lam=self.lam,
            with_baseline=self.with_baseline,
        )
        pi_opt, vf_opt = make_optimizers(net_params, self.pi_lr, self.vf_lr,
                                         freeze)
        self.state = ReinforceState(params=net_params, pi_opt=pi_opt,
                                    vf_opt=vf_opt)

    def _log_keys(self):
        keys = ["LossPi", "DeltaLossPi", "KL", "Entropy"]
        if self.with_baseline:
            keys += ["LossV", "DeltaLossV"]
        return keys
