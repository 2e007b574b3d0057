"""Value-based and continuous-control model families (the off-policy stack).

Counterpart of :mod:`relayrl_tpu.models.q_networks`. Two kinds of
artifacts:

* **Registered policy kinds**, shipped to actors through a
  :class:`~relayrl_tpu_torch.types.ModelBundle` with the uniform ``step``
  ABI: ``qnet_discrete`` (epsilon-greedy over Q), ``c51_discrete``
  (epsilon-greedy over expected atom values), ``ddpg_continuous``
  (deterministic tanh actor + Gaussian exploration noise) and
  ``sac_continuous`` (squashed-Gaussian sampler). The exploration knobs
  (``epsilon``, ``act_noise``) ride in the arch, and ``step`` takes them
  as keyword arguments, so the learner anneals them per publish.
* **Learner-only critic modules**: Q(s), Q(s, a), the twin and the
  distributional heads.

Submodule names are flax's (``q_trunk.dense_i``, ``q_head``, ``q1``,
``q2``, ``pi_trunk``, ``pi_head``, ``pi_mu``, ``pi_log_std``), so
:mod:`relayrl_tpu_torch.weights` carries the params across both ways. C51's
head is one Dense of ``act_dim * n_atoms`` outputs reshaped after the
product on both sides, so its layout needs no special case. Every draw
(the epsilon-greedy coin and pick, the Gaussian noise) comes from the
``torch.Generator`` passed to ``step``, on the policy's device. With
``arch["obs_shape"]`` the DQN and C51 q-nets take the Nature conv trunk of
:mod:`relayrl_tpu_torch.models.cnn` as ``q_trunk`` (:func:`_q_trunk`), over
flat wire frames, uint8 or float.

These families run no Pallas kernel in the JAX package, and none here:
their products are ``torch.nn.functional.linear`` and ``F.conv2d``.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from relayrl_tpu_torch.models.base import Policy, mlp_sizes, register_model
from relayrl_tpu_torch.models.cnn import (
    NATURE_CONV,
    ConvTrunk,
    resolve_conv_spec,
    validate_conv_spec,
)
from relayrl_tpu_torch.models.mlp import (
    _MASK_FILL,
    MLPTrunk,
    _build_mlp_policy,
    _categorical_sample,
    _compute_dtype,
    _dense,
    normal,
    uniform,
)

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def _q_trunk(obs_dim: int, hidden_sizes, compute_dtype, obs_shape=None,
             conv_spec=None, dense: int = 512,
             scale_obs: bool = True) -> tuple[nn.Module, int]:
    """The shared trunk switch of both q-heads, and its output width:
    ``obs_shape`` set -> the Nature conv trunk over pixel observations;
    None -> the MLP trunk."""
    if obs_shape is not None:
        return (ConvTrunk(obs_shape, conv_spec or NATURE_CONV, dense, scale_obs,
                          compute_dtype), int(dense))
    return (MLPTrunk(obs_dim, hidden_sizes, "relu", compute_dtype),
            hidden_sizes[-1] if hidden_sizes else obs_dim)


# Arch keys that switch a q-net to the pixel (conv-trunk) variant; the
# DQN/C51 setups copy exactly these from hyperparams into the arch, so the
# actors' policy and the learner's modules agree.
PIXEL_ARCH_KEYS = ("obs_shape", "conv_spec", "dense", "scale_obs")


def conv_trunk_kwargs(arch: Mapping[str, Any]) -> dict:
    """Arch -> the pixel-trunk kwargs shared by the q-net policy kinds and the
    DQN/C51 learner modules (empty without ``obs_shape``). Refuses a conv
    spec that collapses the frame, as the JAX package does."""
    obs_shape = arch.get("obs_shape")
    if obs_shape is None:
        return {}
    spec = resolve_conv_spec(arch["conv_spec"]) if arch.get("conv_spec") else None
    validate_conv_spec(obs_shape, spec or NATURE_CONV)
    return {
        "obs_shape": tuple(int(d) for d in obs_shape),
        "conv_spec": spec,
        "dense": int(arch.get("dense", 512)),
        "scale_obs": bool(arch.get("scale_obs", True)),
    }


class DiscreteQNet(nn.Module):
    """obs -> Q[A] (DQN head); trunk per :func:`_q_trunk`."""

    def __init__(self, obs_dim: int, act_dim: int, hidden_sizes,
                 compute_dtype: torch.dtype = torch.float32, **pixel):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.q_trunk, width = _q_trunk(obs_dim, hidden_sizes, compute_dtype, **pixel)
        self.q_head = nn.Linear(width, act_dim)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return _dense(self.q_head, self.q_trunk(obs), self.compute_dtype).float()


class DistributionalQNet(nn.Module):
    """obs -> logits[A, n_atoms] (C51 head); trunk per :func:`_q_trunk`."""

    def __init__(self, obs_dim: int, act_dim: int, n_atoms: int, hidden_sizes,
                 compute_dtype: torch.dtype = torch.float32, **pixel):
        super().__init__()
        self.act_dim, self.n_atoms = int(act_dim), int(n_atoms)
        self.compute_dtype = compute_dtype
        self.q_trunk, width = _q_trunk(obs_dim, hidden_sizes, compute_dtype, **pixel)
        self.q_head = nn.Linear(width, self.act_dim * self.n_atoms)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        logits = _dense(self.q_head, self.q_trunk(obs), self.compute_dtype).float()
        return logits.reshape(*logits.shape[:-1], self.act_dim, self.n_atoms)


class QValueNet(nn.Module):
    """(obs, act) -> scalar Q (the DDPG/TD3/SAC critic)."""

    def __init__(self, obs_dim: int, act_dim: int, hidden_sizes,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.q_trunk = MLPTrunk(obs_dim + act_dim, hidden_sizes, "relu",
                                compute_dtype)
        self.q_head = nn.Linear(
            hidden_sizes[-1] if hidden_sizes else obs_dim + act_dim, 1)

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs, act], dim=-1)
        q = _dense(self.q_head, self.q_trunk(x), self.compute_dtype)
        return q.float().squeeze(-1)


class TwinQNet(nn.Module):
    """Two independent Q(s, a) heads (TD3/SAC clipped double-Q)."""

    def __init__(self, obs_dim: int, act_dim: int, hidden_sizes,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.q1 = QValueNet(obs_dim, act_dim, hidden_sizes, compute_dtype)
        self.q2 = QValueNet(obs_dim, act_dim, hidden_sizes, compute_dtype)

    def forward(self, obs, act):
        return self.q1(obs, act), self.q2(obs, act)


class DeterministicActor(nn.Module):
    """obs -> tanh-squashed action scaled to act_limit (DDPG/TD3 actor)."""

    def __init__(self, obs_dim: int, act_dim: int, act_limit: float,
                 hidden_sizes, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act_limit = float(act_limit)
        self.compute_dtype = compute_dtype
        self.pi_trunk = MLPTrunk(obs_dim, hidden_sizes, "relu", compute_dtype)
        self.pi_head = nn.Linear(hidden_sizes[-1] if hidden_sizes else obs_dim,
                                 act_dim)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        a = _dense(self.pi_head, self.pi_trunk(obs), self.compute_dtype)
        return self.act_limit * torch.tanh(a.float())


class SquashedGaussianActor(nn.Module):
    """obs -> (mu, log_std) of a pre-squash Gaussian (SAC actor)."""

    def __init__(self, obs_dim: int, act_dim: int, hidden_sizes,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        width = hidden_sizes[-1] if hidden_sizes else obs_dim
        self.pi_trunk = MLPTrunk(obs_dim, hidden_sizes, "relu", compute_dtype)
        self.pi_mu = nn.Linear(width, act_dim)
        self.pi_log_std = nn.Linear(width, act_dim)

    def forward(self, obs: torch.Tensor):
        h = self.pi_trunk(obs)
        mu = _dense(self.pi_mu, h, self.compute_dtype)
        log_std = _dense(self.pi_log_std, h, self.compute_dtype)
        log_std = torch.clamp(log_std.float(), LOG_STD_MIN, LOG_STD_MAX)
        return mu.float(), log_std


def squashed_gaussian_logp(pre: torch.Tensor, mu: torch.Tensor,
                           log_std: torch.Tensor) -> torch.Tensor:
    """Log-prob of the squashed action ``tanh(pre)`` (before the
    ``act_limit`` scale, as the JAX package counts it): the Gaussian's,
    minus the tanh change of variables in its softplus form,
    ``log(1 - tanh(x)^2) = 2 (log 2 - x - softplus(-2x))``."""
    std = torch.exp(log_std)
    logp = (-0.5 * (((pre - mu) / std).square() + 2 * log_std
                    + math.log(2 * math.pi))).sum(dim=-1)
    return logp - (2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre))).sum(dim=-1)


def squashed_gaussian_sample(noise: torch.Tensor, mu: torch.Tensor,
                             log_std: torch.Tensor, act_limit: float):
    """A tanh-squashed Gaussian action from the standard-normal ``noise``
    (shaped like ``mu``), and its log-prob."""
    pre = mu + torch.exp(log_std) * noise
    return act_limit * torch.tanh(pre), squashed_gaussian_logp(pre, mu, log_std)


def _masked_argmax(values: torch.Tensor, mask):
    if mask is not None:
        values = torch.where(mask > 0, values, _MASK_FILL)
    return values.argmax(dim=-1), values


def _eps_greedy(generator: torch.Generator, greedy: torch.Tensor,
                values: torch.Tensor, mask, epsilon: float) -> torch.Tensor:
    """Epsilon-greedy over the valid-action set: with probability
    ``epsilon`` a uniform draw among the valid actions (a Gumbel-max draw
    over zero logits, as ``jax.random.categorical`` makes it), else the
    greedy action."""
    if mask is None:
        mask = torch.ones_like(values)
    logits = torch.where(mask > 0, 0.0, _MASK_FILL)
    explore = uniform(generator, greedy.shape, values.device) < epsilon
    random_act = _categorical_sample(generator, logits)
    return torch.where(explore, random_act, greedy)


def _zeros(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(like.shape, dtype=torch.float32, device=like.device)


def _take(values: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    return values.gather(-1, act.long()[..., None]).squeeze(-1)


@register_model("qnet_discrete")
def build_qnet_discrete(arch: Mapping[str, Any], device: torch.device) -> Policy:
    """Epsilon-greedy policy over a Q-network (the DQN actor artifact).
    ``arch["epsilon"]`` is the exploration rate actors apply; the learner
    anneals it per model publish."""
    epsilon_default = float(arch.get("epsilon", 0.05))
    pixel = conv_trunk_kwargs(arch)

    def module_fn(arch):
        return DiscreteQNet(int(arch["obs_dim"]), int(arch["act_dim"]),
                            mlp_sizes(arch), _compute_dtype(arch), **pixel)

    def step(params, generator, obs, mask, epsilon=None):
        eps = epsilon_default if epsilon is None else epsilon
        q = params(obs)
        greedy, q_masked = _masked_argmax(q, mask)
        act = _eps_greedy(generator, greedy, q, mask, eps)
        v = q_masked.max(dim=-1).values
        return act, {"logp_a": torch.zeros_like(v), "v": v}

    def evaluate(params, obs, mask, act):
        q_a = _take(params(obs), act)
        return torch.zeros_like(q_a), torch.zeros_like(q_a), q_a

    def mode(params, obs, mask):
        return _masked_argmax(params(obs), mask)[0]

    return _build_mlp_policy(module_fn, arch, device, step, evaluate, mode)


def c51_support(arch: Mapping[str, Any], device=None) -> torch.Tensor:
    """The fixed atom grid, f32 as ``jnp.linspace`` gives it."""
    return torch.linspace(float(arch.get("v_min", -10.0)),
                          float(arch.get("v_max", 10.0)),
                          int(arch.get("n_atoms", 51)), device=device)


@register_model("c51_discrete")
def build_c51_discrete(arch: Mapping[str, Any], device: torch.device) -> Policy:
    """Epsilon-greedy policy over C51 expected values."""
    epsilon_default = float(arch.get("epsilon", 0.05))
    support = c51_support(arch, device)
    pixel = conv_trunk_kwargs(arch)

    def module_fn(arch):
        return DistributionalQNet(int(arch["obs_dim"]), int(arch["act_dim"]),
                                  int(arch.get("n_atoms", 51)), mlp_sizes(arch),
                                  _compute_dtype(arch), **pixel)

    def expected_q(params, obs):
        probs = torch.softmax(params(obs), dim=-1)
        return (probs * support).sum(dim=-1)

    def step(params, generator, obs, mask, epsilon=None):
        eps = epsilon_default if epsilon is None else epsilon
        q = expected_q(params, obs)
        greedy, q_masked = _masked_argmax(q, mask)
        act = _eps_greedy(generator, greedy, q, mask, eps)
        v = q_masked.max(dim=-1).values
        return act, {"logp_a": torch.zeros_like(v), "v": v}

    def evaluate(params, obs, mask, act):
        q_a = _take(expected_q(params, obs), act)
        return torch.zeros_like(q_a), torch.zeros_like(q_a), q_a

    def mode(params, obs, mask):
        return _masked_argmax(expected_q(params, obs), mask)[0]

    return _build_mlp_policy(module_fn, arch, device, step, evaluate, mode)


@register_model("ddpg_continuous")
def build_ddpg_continuous(arch: Mapping[str, Any], device: torch.device) -> Policy:
    """Deterministic tanh actor with Gaussian exploration noise
    (``arch["act_noise"]``; 0 for evaluation actors)."""
    act_limit = float(arch.get("act_limit", 1.0))
    act_noise_default = float(arch.get("act_noise", 0.1))

    def module_fn(arch):
        return DeterministicActor(int(arch["obs_dim"]), int(arch["act_dim"]),
                                  act_limit, mlp_sizes(arch), _compute_dtype(arch))

    def step(params, generator, obs, mask, act_noise=None):
        noise = act_noise_default if act_noise is None else act_noise
        a = params(obs)
        a = a + noise * normal(generator, a.shape, a.device, a.dtype)
        a = torch.clamp(a, -act_limit, act_limit)
        zero = _zeros(a[..., 0])
        return a, {"logp_a": zero, "v": zero}

    def evaluate(params, obs, mask, act):
        zero = _zeros(params(obs)[..., 0])
        return zero, zero, zero

    def mode(params, obs, mask):
        return params(obs)

    return _build_mlp_policy(module_fn, arch, device, step, evaluate, mode)


@register_model("sac_continuous")
def build_sac_continuous(arch: Mapping[str, Any], device: torch.device) -> Policy:
    """Squashed-Gaussian stochastic actor (SAC)."""
    act_limit = float(arch.get("act_limit", 1.0))

    def module_fn(arch):
        return SquashedGaussianActor(int(arch["obs_dim"]), int(arch["act_dim"]),
                                     mlp_sizes(arch), _compute_dtype(arch))

    def step(params, generator, obs, mask):
        mu, log_std = params(obs)
        noise = normal(generator, mu.shape, mu.device, mu.dtype)
        a, logp = squashed_gaussian_sample(noise, mu, log_std, act_limit)
        return a, {"logp_a": logp, "v": torch.zeros_like(logp)}

    def evaluate(params, obs, mask, act):
        _, log_std = params(obs)
        ent = log_std.sum(dim=-1)  # the Gaussian's entropy up to a constant
        zero = _zeros(ent)
        return zero, ent, zero

    def mode(params, obs, mask):
        mu, _ = params(obs)
        return act_limit * torch.tanh(mu)

    return _build_mlp_policy(module_fn, arch, device, step, evaluate, mode)
