"""Convolutional (Atari-class) actor-critic policies (``cnn_discrete``).

Counterpart of :mod:`relayrl_tpu.models.cnn`: the Nature-DQN trunk (three
VALID convs and a 512 dense, ReLU after each) shared between the
categorical policy head and the value head, with the same parameter names
(``trunk.conv_i``, ``trunk.trunk_dense``, ``pi_head``, ``vf_head``), so
:mod:`relayrl_tpu_torch.weights` carries the params across both ways.

Observations arrive as flat wire vectors ``[..., H*W*C]`` (or shaped
``[..., H, W, C]``), uint8 or float, and are reshaped to NHWC, cast to the
compute dtype, scaled by 1/255 in that dtype (``scale_obs``) and permuted
to NCHW for ``F.conv2d``. Before ``trunk_dense`` the feature map is
permuted back to NHWC and flattened, flax's order, so the JAX package's
``trunk_dense`` kernel rows line up with the port's features. Each conv
and Dense computes as flax's does under ``precision``: input and f32
params cast to the compute dtype, the product, then the bias added in that
dtype; the heads' outputs are f32.

The convs run no Pallas kernel in the JAX package (they are XLA
convolutions); here they are ``F.conv2d`` (cuDNN on the card).
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from relayrl_tpu_torch.models.base import Policy, register_model
from relayrl_tpu_torch.models.mlp import (
    _MASK_FILL,
    _build_mlp_policy,
    _categorical_entropy,
    _categorical_logp,
    _categorical_sample,
    _compute_dtype,
    _dense,
)

# (features, kernel, stride) — the Nature-DQN trunk.
NATURE_CONV = ((32, 8, 4), (64, 4, 2), (64, 3, 1))

# The JAX package's "tpu" preset: the Nature geometry with channel widths
# raised to 64/128/128. Kept under its config name ("tpu"), since configs
# select it by that value.
TPU_CONV = ((64, 8, 4), (128, 4, 2), (128, 3, 1))

CONV_PRESETS = {"nature": NATURE_CONV, "tpu": TPU_CONV}


def resolve_conv_spec(spec) -> tuple:
    """Resolve a conv spec that may be a preset name ("nature"/"tpu") or an
    explicit ((features, kernel, stride), ...) sequence."""
    if isinstance(spec, str):
        try:
            return CONV_PRESETS[spec.lower()]
        except KeyError:
            raise ValueError(
                f"unknown conv preset {spec!r}; known: {sorted(CONV_PRESETS)}"
            ) from None
    return tuple(tuple(int(x) for x in row) for row in spec)


def conv_output_sizes(obs_shape, conv_spec) -> list[tuple[int, int]]:
    """The feature map's (h, w) before and after each VALID conv."""
    h, w = int(obs_shape[0]), int(obs_shape[1])
    sizes = [(h, w)]
    for _, kern, stride in conv_spec:
        h = (h - int(kern)) // int(stride) + 1
        w = (w - int(kern)) // int(stride) + 1
        sizes.append((h, w))
    return sizes


def validate_conv_spec(obs_shape, conv_spec) -> None:
    """Fail fast when a conv stack collapses the feature map to nothing
    (VALID padding): with the Nature trunk anything under ~36 px dies at
    the third layer. Raises with per-layer sizes."""
    sizes = conv_output_sizes(obs_shape, conv_spec)
    for i, (h, w) in enumerate(sizes[1:], start=1):
        if h <= 0 or w <= 0:
            raise ValueError(
                f"conv_spec {tuple(map(tuple, conv_spec))} collapses a "
                f"{obs_shape[0]}x{obs_shape[1]} frame to {h}x{w} (layer "
                f"sizes {sizes[:i + 1]}); use a larger frame (Nature trunk "
                f"needs >= 36 px) or a shallower conv_spec")


class ConvTrunk(nn.Module):
    """``conv_0 .. conv_{n-1}`` (VALID, stride s, ReLU) and ``trunk_dense``
    (ReLU) over pixel observations ``(H, W, C)``."""

    def __init__(self, obs_shape: Sequence[int], conv_spec=NATURE_CONV,
                 dense: int = 512, scale_obs: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.obs_shape = tuple(int(d) for d in obs_shape)
        self.conv_spec = tuple(tuple(int(x) for x in row) for row in conv_spec)
        self.scale_obs = bool(scale_obs)
        self.compute_dtype = compute_dtype
        channels = self.obs_shape[2]
        for i, (feat, kern, stride) in enumerate(self.conv_spec):
            self.add_module(f"conv_{i}", nn.Conv2d(channels, feat, kern, stride))
            channels = feat
        h, w = conv_output_sizes(self.obs_shape, self.conv_spec)[-1]
        self.trunk_dense = nn.Linear(h * w * channels, int(dense))

    def convs(self) -> list[nn.Conv2d]:
        return [getattr(self, f"conv_{i}") for i in range(len(self.conv_spec))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = self.obs_shape
        flat_dim = shape[0] * shape[1] * shape[2]
        if x.shape[-1] == flat_dim:
            batch_shape = x.shape[:-1]
        elif tuple(x.shape[-3:]) == shape:
            batch_shape = x.shape[:-3]
        else:
            raise ValueError(
                f"obs trailing shape {tuple(x.shape)} matches neither "
                f"({flat_dim},) nor {shape}")
        cd = self.compute_dtype
        x = x.reshape((-1,) + shape).to(cd)
        if self.scale_obs:
            x = x / torch.tensor(255.0, dtype=cd, device=x.device)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv in self.convs():
            x = F.conv2d(x, conv.weight.to(cd), stride=conv.stride)
            x = F.relu(x + conv.bias.to(cd)[:, None, None])
        # Flatten in flax's NHWC order: trunk_dense's rows follow it.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(_dense(self.trunk_dense, x, cd))
        return x.reshape(*batch_shape, -1)


class ConvActorCritic(nn.Module):
    """The shared ``trunk``, the ``pi_head`` logits and, with
    ``has_critic``, the ``vf_head`` value."""

    def __init__(self, arch: Mapping[str, Any]):
        super().__init__()
        self.compute_dtype = _compute_dtype(arch)
        dense = int(arch.get("dense", 512))
        self.trunk = ConvTrunk(arch["obs_shape"],
                               resolve_conv_spec(arch.get("conv_spec", NATURE_CONV)),
                               dense, bool(arch.get("scale_obs", True)),
                               self.compute_dtype)
        self.pi_head = nn.Linear(dense, int(arch["act_dim"]))
        self.has_critic = bool(arch.get("has_critic", True))
        if self.has_critic:
            self.vf_head = nn.Linear(dense, 1)

    def forward(self, obs, mask=None):
        feats = self.trunk(obs)
        logits = _dense(self.pi_head, feats, self.compute_dtype).float()
        if mask is not None:
            logits = torch.where(mask > 0, logits, _MASK_FILL)
        if self.has_critic:
            v = _dense(self.vf_head, feats, self.compute_dtype).float().squeeze(-1)
        else:
            v = torch.zeros(logits.shape[:-1], dtype=torch.float32,
                            device=logits.device)
        return logits, v


def cnn_arch(arch: Mapping[str, Any]) -> dict:
    """The arch with ``obs_shape`` checked (H, W, C), its conv spec
    checked against the frame, and ``obs_dim`` set to (or checked against)
    H * W * C, as ``build_cnn_discrete`` in the JAX package does."""
    obs_shape = tuple(int(d) for d in arch["obs_shape"])
    if len(obs_shape) != 3:
        raise ValueError(f"cnn_discrete needs obs_shape (H, W, C), got {obs_shape}")
    validate_conv_spec(obs_shape, resolve_conv_spec(arch.get("conv_spec", NATURE_CONV)))
    obs_dim = math.prod(obs_shape)
    arch = dict(arch)
    arch.setdefault("obs_dim", obs_dim)
    if int(arch["obs_dim"]) != obs_dim:
        raise ValueError(f"obs_dim {arch['obs_dim']} != prod(obs_shape) {obs_dim}")
    return arch


@register_model("cnn_discrete")
def build_cnn_discrete(arch: Mapping[str, Any], device: torch.device) -> Policy:
    arch = cnn_arch(arch)

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

    return _build_mlp_policy(ConvActorCritic, arch, device, step, evaluate, mode)
