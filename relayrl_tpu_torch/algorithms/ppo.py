"""PPO (clipped surrogate).

Counterpart of :mod:`relayrl_tpu.algorithms.ppo`. One epoch update on a
padded ``[B, T]`` batch:

1. GAE-λ advantages and return targets, advantage normalization;
2. ``train_iters`` sweeps of ``minibatch_count`` minibatches of
   trajectory rows, each a fresh shuffle: the update takes the row index
   sets as one ``[train_iters · minibatch_count, B / minibatch_count]``
   tensor, which :class:`PPO` draws from its ``torch.Generator`` state;
3. per minibatch, ONE backward of the total loss (clipped surrogate +
   ``vf_coef`` · value MSE − ``ent_coef`` · entropy); the pi Adam step and
   then the vf Adam step both use those gradients, taken at the params
   before the pi step, as optax's ``multi_transform`` does;
4. KL early stop: once a minibatch's approx-KL exceeds
   ``1.5 · target_kl``, the pi params and the pi Adam state (moments and
   step count) stay as they are for the rest of the update. The minibatch
   that crossed the bar still takes its pi step; the value steps go on.

The stop flag lives on the device. The host reads it once per minibatch,
before the pi step, from a non-blocking copy taken after the previous
minibatch (:class:`_StopFlag`), so the read waits for that minibatch
alone while this minibatch's forward and backward stay queued on the
card. Once set, the flag is not read again.

Metrics come from the first and last minibatch, as in the JAX update.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from relayrl_tpu_torch.algorithms.base import register_algorithm
from relayrl_tpu_torch.algorithms.onpolicy import OnPolicyAlgorithm
from relayrl_tpu_torch.algorithms.reinforce import make_optimizers
from relayrl_tpu_torch.models import apply_arch_overrides, build_policy
from relayrl_tpu_torch.ops import gae_advantages, masked_mean_std, normalize_advantages
from relayrl_tpu_torch.parallel.context import (
    dp_global_rows,
    dp_gradients,
    dp_row_range,
    dp_size,
    dp_sum,
)


@dataclasses.dataclass
class PPOState:
    """Params module, the (pi, vf) Adam pair (None for an empty
    partition), the shuffle generator's state (a CPU uint8 tensor, so a
    checkpoint restores the same shuffles) and the update count, which
    doubles as the model version."""

    params: nn.Module
    pi_opt: torch.optim.Optimizer | None
    vf_opt: torch.optim.Optimizer | None
    rng: torch.Tensor
    step: int = 0


def draw_minibatches(rng: torch.Tensor, batch_rows: int, train_iters: int,
                     minibatch_count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``train_iters`` shuffles of ``batch_rows`` rows, each cut into
    ``minibatch_count`` index sets: ``(idx_sets [train_iters ·
    minibatch_count, batch_rows // minibatch_count], next rng state)``."""
    gen = torch.Generator()
    gen.set_state(rng)
    mb_rows = batch_rows // minibatch_count
    idx = torch.stack([
        torch.randperm(batch_rows, generator=gen)[: mb_rows * minibatch_count]
        .reshape(minibatch_count, mb_rows)
        for _ in range(train_iters)])
    return idx.reshape(train_iters * minibatch_count, mb_rows), gen.get_state()


class _StopFlag:
    """The KL-stop flag: a device bool, and its host copy taken without
    blocking after each minibatch; :meth:`read` waits for that copy
    alone."""

    def __init__(self, device: torch.device):
        self.value = torch.zeros((), dtype=torch.bool, device=device)
        self._host = None
        self._event = None
        self._latched = False

    def update(self, crossed: torch.Tensor) -> None:
        self.value = self.value | crossed
        if self._latched:
            return
        if self.value.device.type == "cuda":
            self._host = self.value.to("cpu", non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = self.value

    def read(self) -> bool:
        """Whether any earlier minibatch crossed the bar."""
        if self._latched or self._host is None:
            return self._latched
        if self._event is not None:
            self._event.synchronize()
        self._latched = bool(self._host)
        return self._latched


def _step_partitions(pi_opt, vf_opt, loss: torch.Tensor | None,
                     stop_pi: _StopFlag) -> None:
    """One backward of ``loss`` over both optimizers' parameters (summed
    over the data-parallel group; ``None``: this process holds no row of
    the minibatch), then the pi step (skipped once the stop flag is set)
    and the vf step."""
    opts = [opt for opt in (pi_opt, vf_opt) if opt is not None]
    params = [p for opt in opts for group in opt.param_groups
              for p in group["params"]]
    for param, grad in zip(params, dp_gradients(loss, params)):
        param.grad = grad
    if pi_opt is not None and not stop_pi.read():
        pi_opt.step()
    if vf_opt is not None:
        vf_opt.step()
    for opt in opts:
        opt.zero_grad(set_to_none=True)


def make_ppo_update(policy, clip_ratio: float, ent_coef: float,
                    vf_coef: float, target_kl: float, gamma: float,
                    lam: float):
    """The ``(state, batch, idx_sets) -> (state, metrics)`` epoch update.
    The learning rates and the freeze mask live in the state's optimizers
    (:func:`~relayrl_tpu_torch.algorithms.reinforce.make_optimizers`);
    ``idx_sets`` (:func:`draw_minibatches`) fixes the minibatches and so
    ``train_iters · minibatch_count``."""

    def update(state: PPOState, batch: Mapping[str, torch.Tensor],
               idx_sets: torch.Tensor):
        params = state.params
        obs, act, act_mask = batch["obs"], batch["act"], batch["act_mask"]
        rew, val, valid = batch["rew"], batch["val"], batch["valid"]
        old_logp, last_val = batch["logp"], batch["last_val"]

        adv, ret = gae_advantages(rew, val, valid, gamma, lam, last_val)
        adv = normalize_advantages(adv, valid)

        counts = None
        if dp_size() > 1:
            # idx_sets index the global batch's rows: this process keeps
            # the ones it holds (maybe none), and each minibatch's count is
            # the global one.
            start, stop_row = dp_row_range(dp_global_rows(valid.shape[0]))
            idx_sets = [(idx[(idx >= start) & (idx < stop_row)] - start).to(valid.device)
                        for idx in idx_sets.cpu()]
            counts, = dp_sum(torch.stack([valid.index_select(0, idx).sum()
                                          for idx in idx_sets]))
        else:
            idx_sets = idx_sets.to(valid.device)
        stop = _StopFlag(valid.device)
        auxes = []
        for i, idx in enumerate(idx_sets):
            o, a, m = (x.index_select(0, idx) for x in (obs, act, act_mask))
            ad, rt, lp_old, vl = (x.index_select(0, idx)
                                  for x in (adv, ret, old_logp, valid))
            n = (vl.sum() if counts is None else counts[i]).clamp_min(1.0)
            if idx.numel() == 0:
                # No row of this minibatch here: zero gradients and zero
                # shares of its statistics join the group's sums.
                _step_partitions(state.pi_opt, state.vf_opt, None, stop)
                pi_loss = v_loss = entropy = approx_kl = clip_frac = n * 0
            else:
                with torch.enable_grad():
                    logp, ent, v = policy.evaluate(params, o, a, m)
                    ratio = torch.exp(logp - lp_old)
                    clipped = torch.clamp(ratio, 1.0 - clip_ratio, 1.0 + clip_ratio)
                    pi_loss = -(torch.minimum(ratio * ad, clipped * ad) * vl).sum() / n
                    v_loss = ((v - rt).square() * vl).sum() / n
                    entropy = (ent * vl).sum() / n
                    total = pi_loss + vf_coef * v_loss - ent_coef * entropy
                    with torch.no_grad():
                        approx_kl = ((lp_old - logp) * vl).sum() / n
                        clip_frac = (((ratio - 1.0).abs() > clip_ratio).float()
                                     * vl).sum() / n
                    _step_partitions(state.pi_opt, state.vf_opt, total, stop)
            # The KL stop reads the global KL, so every process stops at
            # the same minibatch.
            pi_loss, v_loss, entropy, approx_kl, clip_frac = dp_sum(
                pi_loss.detach(), v_loss.detach(), entropy.detach(), approx_kl,
                clip_frac)
            stop.update(approx_kl > 1.5 * target_kl)
            auxes.append({"pi_loss": pi_loss, "v_loss": v_loss,
                          "entropy": entropy, "kl": approx_kl,
                          "clip_frac": clip_frac})

        adv_mean, adv_std = masked_mean_std(adv, valid)
        first, last = auxes[0], auxes[-1]
        metrics = {
            "LossPi": first["pi_loss"],
            "DeltaLossPi": last["pi_loss"] - first["pi_loss"],
            "LossV": first["v_loss"],
            "DeltaLossV": last["v_loss"] - first["v_loss"],
            "KL": last["kl"],
            "Entropy": last["entropy"],
            "ClipFrac": torch.stack([x["clip_frac"] for x in auxes]).mean(),
            "StopIter": stop.value.float(),
            "AdvMean": adv_mean,
            "AdvStd": adv_std,
        }
        return dataclasses.replace(state, step=state.step + 1), metrics

    return update


@register_algorithm("PPO")
class PPO(OnPolicyAlgorithm):
    """Host-side PPO orchestration, with REINFORCE's ctor."""

    ALGO_NAME = "PPO"

    def _setup(self, params: dict, learner: dict,
               generator: torch.Generator) -> None:
        self.minibatch_count = int(params.get("minibatch_count", 4))
        if self.traj_per_epoch % self.minibatch_count:
            raise ValueError(
                f"traj_per_epoch ({self.traj_per_epoch}) must be divisible by "
                f"minibatch_count ({self.minibatch_count})")
        self.lam = float(params.get("lam", 0.95))
        self.train_iters = int(params.get("train_iters", 4))

        obs_shape = params.get("obs_shape")
        if obs_shape is not None:
            kind = "cnn_discrete"
        else:
            kind = "mlp_discrete" if self.discrete else "mlp_continuous"
        self.arch = {
            "kind": str(params.get("model_kind", kind)),
            "obs_dim": self.obs_dim,
            "act_dim": self.act_dim,
            "hidden_sizes": list(params.get("hidden_sizes", [128, 128])),
            "activation": str(params.get("activation", "tanh")),
            "has_critic": True,
            "precision": str(learner.get("precision", "float32")),
        }
        if obs_shape is not None:
            self.arch["obs_shape"] = [int(d) for d in obs_shape]
            for key in ("conv_spec", "dense", "scale_obs"):
                if key in params:
                    self.arch[key] = params[key]
        apply_arch_overrides(self.arch, params)
        self.policy = build_policy(self.arch, self.device)

        net_params = self.policy.init_params(generator)
        self.freeze = self._resolve_freeze(params, learner, net_params)
        self.pi_lr = float(params.get("pi_lr", 3e-4))
        self.vf_lr = float(params.get("vf_lr", 1e-3))
        self._update_kwargs = {
            "clip_ratio": float(params.get("clip_ratio", 0.2)),
            "ent_coef": float(params.get("ent_coef", 0.0)),
            "vf_coef": float(params.get("vf_coef", 0.5)),
            "target_kl": float(params.get("target_kl", 0.015)),
            "gamma": self.gamma,
            "lam": self.lam}
        update = self.make_update(self.policy)

        def epoch_update(state, batch):
            # Over the global batch's rows (each process holds its block).
            idx_sets, rng = draw_minibatches(
                state.rng, dp_global_rows(int(batch["obs"].shape[0])),
                self.train_iters, self.minibatch_count)
            state, metrics = update(state, batch, idx_sets)
            return dataclasses.replace(state, rng=rng), metrics

        self._update = epoch_update
        shuffle = torch.Generator().manual_seed(
            int(torch.randint(0, 2**62, (1,), generator=generator)))
        self.state = self.fresh_state(net_params, shuffle.get_state())

    def fresh_state(self, params: nn.Module, rng: torch.Tensor | None = None) -> PPOState:
        """A state over ``params`` with a fresh (pi, vf) Adam pair at this
        learner's rates and freeze mask; ``rng`` defaults to a copy of the
        current shuffle state."""
        pi_opt, vf_opt = make_optimizers(params, self.pi_lr, self.vf_lr,
                                         self.freeze)
        return PPOState(params=params, pi_opt=pi_opt, vf_opt=vf_opt,
                        rng=(self.state.rng.clone() if rng is None else rng))

    def make_update(self, policy, **overrides):
        """This learner's ``(state, batch, idx_sets)`` update through
        ``policy``; ``overrides`` replace its hyperparameters (a
        ``target_kl`` that trips the stop, say)."""
        return make_ppo_update(policy, **{**self._update_kwargs, **overrides})

    def _log_keys(self):
        return ("LossPi", "DeltaLossPi", "LossV", "DeltaLossV", "KL",
                "Entropy", "ClipFrac")
