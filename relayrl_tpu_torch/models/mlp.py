"""MLP actor-critic policies (discrete masked-categorical + continuous), and
the helpers the policy families share.

Counterpart of :mod:`relayrl_tpu.models.mlp`: ``mlp_discrete`` (masked
logits over ``act_dim`` actions) and ``mlp_continuous`` (a diagonal
Gaussian with a learned, state-independent ``log_std``), each a policy
trunk and head plus an optional value trunk and head. Trunks run in the
configured compute dtype (``precision``), each Dense as flax computes it
(input and f32 params cast to the compute dtype, the product, then the bias
added in that dtype); logits, the mean, ``v``, the log-probs and the
entropy are f32; parameters are stored f32.

The modules' names are the flax scopes (``pi_trunk.dense_i``,
``pi_head``, ``vf_trunk.dense_i``, ``vf_head``, ``log_std``), so
:mod:`relayrl_tpu_torch.weights` carries the params across both ways.
These families run no Pallas kernel in the JAX package, and none here:
their products are ``torch.nn.functional.linear``.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from relayrl_tpu_torch.models.base import Policy, mlp_sizes, register_model
from relayrl_tpu_torch.weights import params_from_jax

# flax's nn.gelu is the tanh approximation.
_ACTIVATIONS = {"tanh": torch.tanh, "relu": F.relu,
                "gelu": lambda x: F.gelu(x, approximate="tanh")}

# Large negative fill for invalid actions: `where` with a finite fill keeps
# softmax and its gradient NaN-free in bf16.
_MASK_FILL = -1e9


def _categorical_logp(logits: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    logp_all = torch.log_softmax(logits, dim=-1)
    return logp_all.gather(-1, act[..., None].long()).squeeze(-1)


def _categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp_all = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp_all)
    return -torch.where(p > 0, p * logp_all, 0.0).sum(dim=-1)


def _categorical_sample(generator: torch.Generator,
                        logits: torch.Tensor) -> torch.Tensor:
    """Gumbel-max draw over the last axis (the construction
    ``jax.random.categorical`` uses), from ``generator``'s stream. Returns
    int64 indices."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _gaussian_logp(mu: torch.Tensor, log_std: torch.Tensor,
                   act: torch.Tensor) -> torch.Tensor:
    var = torch.exp(2 * log_std)
    return (-0.5 * ((act - mu).square() / var + 2 * log_std
                    + math.log(2 * math.pi))).sum(dim=-1)


def _gaussian_entropy(log_std: torch.Tensor, batch_shape) -> torch.Tensor:
    ent = (0.5 * (1.0 + math.log(2 * math.pi)) + log_std).sum()
    return ent.expand(batch_shape)


def _compute_dtype(arch: Mapping[str, Any]) -> torch.dtype:
    name = arch.get("precision", "float32")
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input and f32 params cast to ``dtype``,
    the matmul, then the bias added in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


def init_dense(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax's Dense initializers: the kernel lecun-normal (a normal
    truncated at two standard deviations, rescaled to variance 1/fan_in),
    the bias zero."""
    std = layer.in_features ** -0.5 / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    nn.init.zeros_(layer.bias)


def init_conv(layer: nn.Conv2d, generator: torch.Generator) -> None:
    """flax's Conv initializers: the kernel lecun-normal over its fan-in
    (kh * kw * in), truncated at two standard deviations; the bias zero."""
    fan_in = layer.in_channels * math.prod(layer.kernel_size)
    std = fan_in ** -0.5 / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    nn.init.zeros_(layer.bias)


def init_module(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's Dense and Conv initializers on every ``Linear`` and
    ``Conv2d`` of ``module``, drawn from ``generator`` in module order."""
    for layer in module.modules():
        if isinstance(layer, nn.Linear):
            init_dense(layer, generator)
        elif isinstance(layer, nn.Conv2d):
            init_conv(layer, generator)
    return module


class MLPTrunk(nn.Module):
    """Dense layers ``dense_0 .. dense_{n-1}``, each followed by the
    activation, in the compute dtype."""

    def __init__(self, in_dim: int, hidden_sizes, activation: str,
                 compute_dtype: torch.dtype):
        super().__init__()
        sizes = (in_dim, *hidden_sizes)
        for i, (n_in, n_out) in enumerate(zip(sizes, sizes[1:])):
            self.add_module(f"dense_{i}", nn.Linear(n_in, n_out))
        self.activation = _ACTIVATIONS[activation]
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        for layer in self.children():
            x = self.activation(_dense(layer, x, self.compute_dtype))
        return x


class _ActorCritic(nn.Module):
    """A policy trunk and head (``act_dim`` outputs) and, with
    ``has_critic``, a value trunk and head."""

    def __init__(self, arch: Mapping[str, Any]):
        super().__init__()
        obs_dim, act_dim = int(arch["obs_dim"]), int(arch["act_dim"])
        hidden = mlp_sizes(arch)
        activation = arch.get("activation", "tanh")
        self.compute_dtype = _compute_dtype(arch)
        self.pi_trunk = MLPTrunk(obs_dim, hidden, activation, self.compute_dtype)
        self.pi_head = nn.Linear(hidden[-1] if hidden else obs_dim, act_dim)
        self.has_critic = bool(arch.get("has_critic", True))
        if self.has_critic:
            self.vf_trunk = MLPTrunk(obs_dim, hidden, activation, self.compute_dtype)
            self.vf_head = nn.Linear(hidden[-1] if hidden else obs_dim, 1)

    def head(self, obs: torch.Tensor) -> torch.Tensor:
        """The policy head's output (logits or mean) in f32."""
        return _dense(self.pi_head, self.pi_trunk(obs), self.compute_dtype).float()

    def value(self, obs: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """``v`` in f32, zeros shaped like ``like`` without a critic."""
        if not self.has_critic:
            return torch.zeros(like.shape[:-1], dtype=torch.float32, device=like.device)
        v = _dense(self.vf_head, self.vf_trunk(obs), self.compute_dtype)
        return v.float().squeeze(-1)


class DiscreteActorCritic(_ActorCritic):
    """Masked-categorical policy head + optional value head."""

    def forward(self, obs, mask=None):
        logits = self.head(obs)
        if mask is not None:
            logits = torch.where(mask > 0, logits, _MASK_FILL)
        return logits, self.value(obs, logits)


class ContinuousActorCritic(_ActorCritic):
    """Diagonal-Gaussian policy with a learned, state-independent
    ``log_std`` (initialised to -0.5) + optional value head."""

    def __init__(self, arch: Mapping[str, Any]):
        super().__init__(arch)
        self.log_std = nn.Parameter(torch.full((int(arch["act_dim"]),), -0.5))

    def forward(self, obs, mask=None):
        del mask  # masks are a discrete-action concept
        mu = self.head(obs)
        return (mu, self.log_std), self.value(obs, mu)


def _build_mlp_policy(module_cls, arch: Mapping[str, Any], device: torch.device,
                      step, evaluate, mode) -> Policy:
    def init_params(generator: torch.Generator) -> nn.Module:
        return init_module(module_cls(arch), generator).to(device)

    def load_params(tree) -> nn.Module:
        with torch.device("meta"):
            module = module_cls(arch)
        module = module.to_empty(device=device)
        module.load_state_dict(params_from_jax(tree))
        return module

    def as_input(obs, mask):
        obs = torch.as_tensor(obs, dtype=torch.float32, device=device)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
        return obs, mask

    return Policy(arch=dict(arch), device=device, init_params=init_params,
                  load_params=load_params,
                  step=lambda params, generator, obs, mask=None, **explore: step(
                      params, generator, *as_input(obs, mask), **explore),
                  evaluate=lambda params, obs, act, mask=None: evaluate(
                      params, *as_input(obs, mask),
                      None if act is None else torch.as_tensor(act, device=device)),
                  mode=lambda params, obs, mask=None: mode(
                      params, *as_input(obs, mask)))


@register_model("mlp_discrete")
def build_mlp_discrete(arch: Mapping[str, Any], device: torch.device) -> Policy:
    def step(params, generator, obs, mask):
        logits, v = params(obs, mask)
        act = _categorical_sample(generator, logits)
        return act, {"logp_a": _categorical_logp(logits, act), "v": v}

    def evaluate(params, obs, mask, act):
        logits, v = params(obs, mask)
        return _categorical_logp(logits, act), _categorical_entropy(logits), v

    def mode(params, obs, mask):
        logits, _ = params(obs, mask)
        return logits.argmax(dim=-1)

    return _build_mlp_policy(DiscreteActorCritic, arch, device, step, evaluate, mode)


@register_model("mlp_continuous")
def build_mlp_continuous(arch: Mapping[str, Any], device: torch.device) -> Policy:
    def step(params, generator, obs, mask):
        (mu, log_std), v = params(obs, mask)
        noise = torch.randn(mu.shape, generator=generator, device=mu.device,
                            dtype=mu.dtype)
        act = mu + torch.exp(log_std) * noise
        return act, {"logp_a": _gaussian_logp(mu, log_std, act), "v": v}

    def evaluate(params, obs, mask, act):
        (mu, log_std), v = params(obs, mask)
        logp = _gaussian_logp(mu, log_std, act.float())
        return logp, _gaussian_entropy(log_std, logp.shape), v

    def mode(params, obs, mask):
        (mu, _), _ = params(obs, mask)
        return mu

    return _build_mlp_policy(ContinuousActorCritic, arch, device, step, evaluate, mode)
