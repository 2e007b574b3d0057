"""Model registry + the policy ABI.

Counterpart of :mod:`relayrl_tpu.models.base`. The ABI is an architecture
config (a JSON-able dict) resolved through this registry into a
:class:`Policy`: a bundle of functions over tensors. The policy's "params"
are an ``nn.Module`` holding the weights on the policy's device; the
functions take it as their first argument, so a hot swap installs a new
module and never mutates one in use.

Arch config schema::

    {"kind": "<registry key>", "obs_dim": int, "act_dim": int, ...}
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

_REGISTRY: dict[str, Callable[[Mapping[str, Any], torch.device], "Policy"]] = {}


def register_model(kind: str):
    def deco(builder):
        _REGISTRY[kind] = builder
        return builder
    return deco


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one asked for, else the GPU.
    Without a GPU the caller must ask for the CPU explicitly — the port
    never carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: the port runs on the GPU unless the "
            "caller passes device='cpu'")
    return torch.device("cuda")


def build_policy(arch: Mapping[str, Any], device=None) -> "Policy":
    """Arch config -> :class:`Policy` placed on ``device`` (default: the
    GPU, see :func:`resolve_device`)."""
    kind = arch.get("kind")
    if kind not in _REGISTRY:
        raise ValueError(f"unknown model kind {kind!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[kind](arch, resolve_device(device))


# Model-shape hyperparams that algorithms forward verbatim from their
# hyperparam dict into the arch config when present (the JAX package's
# list), so any policy family is reachable through the algorithm ctor.
ARCH_PASSTHROUGH_KEYS = (
    "d_model", "n_layers", "n_heads", "mlp_ratio", "max_seq_len",
    "attention", "attention_block", "actor_context",
    "moe_experts", "moe_top_k", "pp_microbatches",
)


def apply_arch_overrides(arch: dict, params: Mapping[str, Any]) -> dict:
    """Copy any present :data:`ARCH_PASSTHROUGH_KEYS` from hyperparams into
    ``arch``. Sequence-model keys on an MLP or CNN kind almost always mean
    a forgotten ``model_kind``: warn, as the JAX package does."""
    copied = [k for k in ARCH_PASSTHROUGH_KEYS if k in params]
    for key in copied:
        arch[key] = params[key]
    kind = str(arch.get("kind", ""))
    if copied and (kind.startswith("mlp") or kind.startswith("cnn")):
        import warnings

        warnings.warn(
            f"model overrides {copied} have no effect on model kind "
            f"{kind!r} — did you forget model_kind="
            f"\"transformer_discrete\" (or another sequence kind)?",
            stacklevel=2)
    return arch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Policy bundle; ``params`` below is the module ``init_params`` or
    ``load_params`` returns.

    * ``init_params(generator) -> params`` — random weights drawn from a
      CPU ``torch.Generator``, placed on ``device``.
    * ``load_params(tree) -> params`` — weights from the flax state-dict
      tree of numpy arrays that a :class:`ModelBundle` carries.
    * ``step(params, generator, obs, mask) -> (act, aux)`` — sampling
      forward; ``aux`` holds ``logp_a`` and ``v``.
    * ``evaluate(params, obs, act, mask) -> (logp, entropy, v)``.
    * ``mode(params, obs, mask) -> act`` — greedy action.
    * ``step_window(params, generator, window, t, mask) -> (act, aux)`` and
      ``mode_window(params, window, t, mask)`` — sequence policies only:
      act from right-zero-padded history windows ``[W, obs_dim]`` (or
      stacked ``[N, W, obs_dim]`` with ``t [N]``) whose first ``t`` rows
      are real.
    * ``init_cache(length, batch_size) -> cache``, ``step_cached(params,
      generator, cache, obs, t, mask) -> (act, aux, cache)`` and
      ``prefill_cache(params, cache, window) -> cache`` — the KV-cache
      decode path of the transformer family (None for the others): per-
      layer k/v caches, one decode step at position ``t``, and a rebuild
      of the cache from a padded window.
    """

    arch: dict[str, Any]
    device: torch.device
    init_params: Callable
    load_params: Callable
    step: Callable
    evaluate: Callable
    mode: Callable
    step_window: Callable | None = None
    mode_window: Callable | None = None
    init_cache: Callable | None = None
    step_cached: Callable | None = None
    prefill_cache: Callable | None = None

    @property
    def input_dim(self) -> int:
        return int(self.arch["obs_dim"])

    @property
    def output_dim(self) -> int:
        return int(self.arch["act_dim"])


def validate_policy(policy: Policy, params) -> None:
    """Dummy-forward validation on load: a zero-obs ``step`` (a context of
    one, so T = 1) must return an aux dict with ``logp_a`` and a scalar
    action."""
    obs_shape = policy.arch.get("obs_shape") or (policy.input_dim,)
    obs = torch.zeros(tuple(obs_shape), dtype=torch.float32,
                      device=policy.device)
    mask = torch.ones((policy.output_dim,), dtype=torch.float32,
                      device=policy.device)
    gen = torch.Generator(device=policy.device).manual_seed(0)
    with torch.inference_mode():
        act, aux = policy.step(params, gen, obs, mask)
    if not isinstance(aux, dict) or "logp_a" not in aux:
        raise ValueError("policy step ABI violation: aux dict missing 'logp_a'")
    act_arr = np.asarray(act.cpu())
    if act_arr.ndim > 1:
        raise ValueError(f"policy step returned act of rank {act_arr.ndim} for single obs")


def mlp_sizes(arch: Mapping[str, Any]) -> tuple[int, ...]:
    return tuple(int(h) for h in arch.get("hidden_sizes", (128, 128)))
