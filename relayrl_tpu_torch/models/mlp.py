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
their products are ``torch.nn.functional.linear``. Placed on a mesh with
``tp`` above 1, a trunk runs its layer pairs column then row parallel
(:meth:`MLPTrunk.forward`), as the JAX sharding rules lay them out.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from relayrl_tpu_torch.models.base import Policy, mlp_sizes, register_model
from relayrl_tpu_torch.parallel.context import enter_split, leave_split
from relayrl_tpu_torch.parallel.sharding import split_blocks
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


class KeyedDraws:
    """Per-row noise drawn from per-row keys, in place of a
    ``torch.Generator``: the serving plane's counterpart of the JAX
    service's per-request PRNG key.

    ``keys`` is ``[N, 2]`` uint32, one key a row (the words of
    ``jax.random.PRNGKey``). Row ``i`` draws from numpy's counter-based
    ``Philox`` keyed by its two words as one 64-bit key: first its
    successor key (:attr:`next_keys`), then, in call order, every block
    of noise a sampler asks for. So a row's noise and successor are a
    function of its key alone, whatever its batchmates, its position or
    the device; the noise is made on the host and reaches the device in
    one copy per block."""

    def __init__(self, keys, device):
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        self.device = torch.device(device)
        self._rows = [np.random.Generator(np.random.Philox(
            key=(int(k0) << 32) | int(k1))) for k0, k1 in keys]
        self.next_keys = np.stack([
            g.integers(0, 1 << 32, size=2, dtype=np.uint32)
            for g in self._rows]) if self._rows else np.zeros((0, 2), np.uint32)

    def _block(self, shape, draw) -> torch.Tensor:
        shape = tuple(shape)
        if not shape or shape[0] != len(self._rows):
            raise ValueError(f"keyed noise of shape {shape} for "
                             f"{len(self._rows)} keyed rows")
        block = np.stack([draw(g, shape[1:]) for g in self._rows])
        return torch.from_numpy(block).to(self.device)

    def uniform(self, shape) -> torch.Tensor:
        """f32 uniforms in [0, 1), as ``torch.rand``."""
        return self._block(shape, lambda g, s: g.random(s, dtype=np.float32))

    def normal(self, shape) -> torch.Tensor:
        """f32 standard normals, as ``torch.randn``."""
        return self._block(
            shape, lambda g, s: g.standard_normal(s, dtype=np.float32))


def uniform(generator, shape, device) -> torch.Tensor:
    """f32 uniforms in [0, 1) from a ``torch.Generator`` or a
    :class:`KeyedDraws`."""
    if isinstance(generator, KeyedDraws):
        return generator.uniform(shape)
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def normal(generator, shape, device, dtype=torch.float32) -> torch.Tensor:
    """Standard normals in ``dtype`` from a ``torch.Generator`` or a
    :class:`KeyedDraws`."""
    if isinstance(generator, KeyedDraws):
        return generator.normal(shape).to(dtype)
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)


def _categorical_sample(generator, logits: torch.Tensor) -> torch.Tensor:
    """Gumbel-max draw over the last axis (the construction
    ``jax.random.categorical`` uses), from ``generator``'s stream (a
    ``torch.Generator`` or a :class:`KeyedDraws`). Returns int64
    indices."""
    u = uniform(generator, logits.shape, logits.device)
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
        """Each layer in turn; a ``dense_{2i}``/``dense_{2i+1}`` pair whose
        kernels :func:`relayrl_tpu_torch.parallel.place_state` split over
        ``tp`` runs tensor parallel (:meth:`_tp_pair`)."""
        cd = self.compute_dtype
        x = x.to(cd)
        layers = list(self.children())
        i = 0
        while i < len(layers):
            blocks = _tp_blocks(layers, i)
            if blocks is not None:
                x = self._tp_pair(x, layers[i + 1], *blocks)
                i += 2
            else:
                x = self.activation(_dense(layers[i], x, cd))
                i += 1
        return x

    def _tp_pair(self, x: torch.Tensor, down: nn.Linear, blocks, group) -> torch.Tensor:
        """Column then row parallel: each tp block's output features of the
        first layer computed on its device from the replicated input, the
        activation applied per block, the second layer's partial products
        from those features summed on the input's device (the psum) and
        its bias added once. Where tp crosses processes (``group``), this
        process computes its blocks: the input enters through
        :func:`~relayrl_tpu_torch.parallel.context.enter_split` and the
        partial sum leaves through :func:`~relayrl_tpu_torch.parallel.
        context.leave_split`, before the bias."""
        cd = self.compute_dtype
        x_in = enter_split(x, group)
        y = None
        for (dev, w_up), (_, b_up), (_, w_down) in blocks:
            h = self.activation(F.linear(x_in.to(dev), w_up.to(cd)) + b_up.to(cd))
            part = F.linear(h, w_down.to(cd)).to(x.device)
            y = part if y is None else y + part
        return self.activation(leave_split(y, group) + down.bias.to(cd))


def _tp_blocks(layers, i: int):
    """The tp blocks of the pair starting at layer ``i`` (even) that this
    process holds, each block's (up kernel rows, up bias, down kernel
    columns), and the tp group to sum their partial products over (None
    where tp stays in the process); None unless both layers are split
    over ``tp``."""
    if i % 2 or i + 1 >= len(layers):
        return None
    parts = (split_blocks(layers[i], "weight", "tp"), split_blocks(layers[i], "bias", "tp"),
             split_blocks(layers[i + 1], "weight", "tp"))
    if any(p is None for p in parts):
        return None
    return list(zip(*parts)), parts[0].group


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
        noise = normal(generator, mu.shape, mu.device, mu.dtype)
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
