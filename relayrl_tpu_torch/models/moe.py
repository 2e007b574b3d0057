"""Mixture-of-experts MLP with per-token top-k routing (the ``ep`` family).

Counterpart of :mod:`relayrl_tpu.models.moe`, with its parameter names
(``moe_gate``, a Dense; ``moe_w_up [E, d, ff]`` and ``moe_w_down [E, ff,
d]``, raw expert stacks that :mod:`relayrl_tpu_torch.weights` carries
untransposed) and its numerics:

* the gate is an f32 Dense over the f32 tokens; each token keeps its top-k
  gates (ties to the lower expert index, as ``jax.lax.top_k`` breaks them:
  a stable descending sort), a softmax over those k values gives its
  combine weights, scattered into a dense ``[N, E]`` matrix;
* dispatch is dense: every expert runs on every token,
  ``h = gelu(tokens @ w_up[e])`` and ``out = h @ w_down[e]``, with the
  operands cast to the compute dtype and the products accumulated and kept
  in f32 (the JAX einsums' ``preferred_element_type=f32``): the bf16
  operands are widened to f32 after the cast, so each product is exact and
  the sum f32, on every device; GELU is the tanh approximation;
* ``y = weights @ out`` combines the experts in f32.

Routing is causal: a token's gate reads its own features alone, so
training batches and single-window actors route alike. The expert
products are plain matmuls in the JAX package (no Pallas kernel) and
``torch.einsum`` here.

Expert parallelism: once :func:`relayrl_tpu_torch.parallel.place_state`
has split the expert stacks over a mesh's ``ep`` axis (each ep device
holds ``E / ep`` experts), each expert group's ``h`` and ``out``, and its
slice of the combine, run on the device that holds the group, reading the
shards in place; the partial ``y``s are summed on the tokens' device in
group order (the ``psum`` over ``ep`` of the JAX layer). Routing is
unchanged.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from relayrl_tpu_torch.models.mlp import _dense
from relayrl_tpu_torch.parallel.sharding import split_blocks


def top_k_stable(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, ties to the lower index."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _widened(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held in f32 for an f32-accumulated
    product."""
    return x.to(dtype).float()


class MoEMLP(nn.Module):
    """Per-token top-k MoE FFN over flattened tokens (dense dispatch)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, top_k: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.n_experts, self.top_k = int(n_experts), int(top_k)
        self.compute_dtype = compute_dtype
        self.moe_gate = nn.Linear(d_model, n_experts)
        self.moe_w_up = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.moe_w_down = nn.Parameter(torch.empty(n_experts, d_ff, d_model))
        # Per-expert combine mass of the last forward, kept only while
        # ``expert_utilization`` asks for it (the JAX layer's sow).
        self.capture_load = False
        self.expert_load: torch.Tensor | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, d = x.shape
        n = B * T
        k = max(1, min(self.top_k, self.n_experts))
        tokens = x.reshape(n, d)
        gate = _dense(self.moe_gate, tokens.float(), torch.float32)
        top_vals, top_idx = top_k_stable(gate, k)                 # [N, k]
        top_w = torch.softmax(top_vals, dim=-1)
        weights = torch.zeros(n, self.n_experts, dtype=torch.float32,
                              device=x.device).scatter(1, top_idx, top_w)
        if self.capture_load:
            self.expert_load = weights.sum(dim=0).detach()
        ups = split_blocks(self, "moe_w_up", "ep")
        downs = split_blocks(self, "moe_w_down", "ep")
        if ups is None or downs is None:
            y = self._experts(tokens, weights, self.moe_w_up, self.moe_w_down)
        else:
            # One expert group per ep device; the partial combines summed
            # on the tokens' device in group order (the psum over ep).
            group = self.n_experts // len(ups)
            y = None
            for g, ((dev, up), (_, down)) in enumerate(zip(ups, downs)):
                part = self._experts(tokens.to(dev),
                                     weights[:, g * group:(g + 1) * group].to(dev),
                                     up, down).to(x.device)
                y = part if y is None else y + part
        return y.reshape(B, T, d).to(x.dtype)

    def _experts(self, tokens, weights, w_up, w_down) -> torch.Tensor:
        """Dense dispatch of ``tokens [N, d]`` to the experts of ``w_up
        [E, d, ff]`` and ``w_down [E, ff, d]``, combined by ``weights [N,
        E]``, in f32."""
        cd = self.compute_dtype
        h = torch.einsum("nd,edf->enf", _widened(tokens, cd), _widened(w_up, cd))
        h = F.gelu(h, approximate="tanh")
        out = torch.einsum("enf,efd->end", _widened(h, cd), _widened(w_down, cd))
        return torch.einsum("ne,end->nd", weights, out)


def init_experts(moe: MoEMLP, generator: torch.Generator) -> None:
    """flax's ``lecun_normal(batch_axis=(0,))`` on the expert stacks: a
    normal truncated at two standard deviations over each expert's fan-in
    (``d`` for ``moe_w_up``, ``ff`` for ``moe_w_down``), not ``E * d``."""
    for stack in (moe.moe_w_up, moe.moe_w_down):
        std = stack.shape[-2] ** -0.5 / 0.87962566103423978
        nn.init.trunc_normal_(stack, std=std, a=-2 * std, b=2 * std,
                              generator=generator)


def expert_utilization(arch: Mapping[str, Any], params: nn.Module, obs,
                       mask=None) -> dict[str, torch.Tensor]:
    """Per-layer routing-mass fraction per expert, the gate-collapse
    monitor (no load-balancing loss is trained, as in the JAX package):
    ``{"block_i": [E] fractions summing to 1}`` for ``params`` (a
    ``transformer_moe_discrete`` core) on ``obs [B, T, obs_dim]``."""
    del arch  # the module carries it
    layers = {f"block_{i}": block.moe for i, block in enumerate(params.layers())
              if hasattr(block, "moe")}
    device = next(params.parameters()).device
    obs = torch.as_tensor(obs, dtype=torch.float32, device=device)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
    for moe in layers.values():
        moe.capture_load = True
    try:
        with torch.no_grad():
            params(obs, mask)
        out = {}
        for name, moe in layers.items():
            load = moe.expert_load
            out[name] = load / load.sum().clamp_min(1e-9)
    finally:
        for moe in layers.values():
            moe.capture_load, moe.expert_load = False, None
    return out
