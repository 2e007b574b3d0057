"""Decoder-only transformer sequence policies (``transformer_discrete``,
``transformer_moe_discrete``, ``transformer_pp_discrete``).

Counterpart of :mod:`relayrl_tpu.models.transformer`: the same causal
transformer over the trajectory time axis, the same parameter names (so
one flax params tree loads into both, see :mod:`relayrl_tpu_torch.weights`)
and the same numerics:

* LayerNorms (epsilon 1e-6, flax's) compute in f32;
* under ``precision: bfloat16`` the ``qkv``, ``attn_out`` and ``mlp_*``
  layers compute in bf16 from f32 params, with the bias added after the
  matmul as flax's Dense does; the embedding and heads stay f32 and so
  does the residual stream;
* GELU is the tanh approximation (flax's ``nn.gelu`` default).

Attention backends by arch ``attention``: ``"dense"``, ``"blockwise"``,
``"flash"`` — the flash kernel (:mod:`relayrl_tpu_torch.ops.flash`) when the
window length tiles by ``flash_block`` (every ``T <= flash_block`` does),
else blockwise or dense, the reference's rule — and ``"ring"``: ring
attention over the ambient mesh's ``sp`` axis
(:func:`relayrl_tpu_torch.parallel.use_mesh`), as the chunk-kernel ring
(:mod:`relayrl_tpu_torch.parallel.ring_flash`) when the local chunk tiles
by 8, else the scan ring (:mod:`relayrl_tpu_torch.parallel.ring`); with no
mesh, or ``sp`` 1, blockwise or dense, so actors serve the arch the
learner trains. On a CUDA device ``"flash"`` and ``"ring"`` take head dims
up to 256, the flash kernels' widest (narrower ones are zero-padded to a
kernel width); building the policy for a CUDA device refuses a wider one.

``transformer_moe_discrete`` replaces each block's dense FFN with the
per-token top-k MoE of :mod:`relayrl_tpu_torch.models.moe` (submodule
``moe``; ``moe_experts``, default 4, and ``moe_top_k``, default 2); its
window readout runs the final block whole and takes the row, as the JAX
family does. ``transformer_pp_discrete`` is ``transformer_discrete``'s
math with the layers under one ``blocks`` scope, which the JAX package
stacks on a leading axis for its pipeline: under an ambient mesh with
``pp`` above 1 the port runs them as the GPipe schedule of
:func:`relayrl_tpu_torch.parallel.pipeline.pipeline_apply`
(``pp_microbatches`` picks the microbatch count, as in the JAX family),
else as a loop over layers (the path every actor host runs); it serves
windows through the full forward (no readout row, no KV cache, as in the
JAX family). Ring attention inside the pipeline (a mesh with ``pp`` and
``sp`` both above 1) raises ``ValueError``: the JAX package cannot run
that mesh either.

KV-cache decode, the actors' default serving path: ``init_cache``,
``step_cached`` and ``prefill_cache`` keep each layer's k and v rows in a
``[B, W, H, hd]`` cache in the compute dtype, so one env step costs one
position's projections and one row of attention against the cache (dense,
with the query's offset, the reference's code path; no flash kernel runs).
The cache is written in place.

Sequence ABI (see :class:`~relayrl_tpu_torch.models.base.Policy`):
``evaluate(params, obs[B,T,D], act[B,T], mask[B,T,A]) -> (logp, ent, v)``;
``step`` treats the second-to-last axis as time and acts at the last
position; the window paths read out one row per window. Actions come back
as int64 tensors; the actors put int32 on the wire, as the JAX actors do.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from relayrl_tpu_torch.models.base import Policy, register_model
from relayrl_tpu_torch.models.mlp import (
    _MASK_FILL,
    _categorical_entropy,
    _categorical_logp,
    _categorical_sample,
    _compute_dtype,
    _dense,
    init_dense,
)
from relayrl_tpu_torch.models.moe import MoEMLP, init_experts
from relayrl_tpu_torch.ops.attention import blockwise_attention, dense_attention
from relayrl_tpu_torch.ops.flash import KERNEL_HEAD_DIMS, flash_attention
from relayrl_tpu_torch.parallel.context import current_mesh
from relayrl_tpu_torch.parallel.pipeline import pipeline_apply
from relayrl_tpu_torch.parallel.ring import make_ring_attention
from relayrl_tpu_torch.parallel.ring_flash import (
    make_ring_flash_attention,
    pick_chunk_block,
)
from relayrl_tpu_torch.weights import params_from_jax

_LN_EPS = 1e-6  # flax nn.LayerNorm's default; torch's is 1e-5


def _resolve_attention(arch: Mapping[str, Any]) -> Callable:
    """Arch config -> [B,T,H,D]x3 -> [B,T,H,D] causal attention callable."""
    kind = arch.get("attention", "dense")
    block = int(arch.get("attention_block", 128))
    if kind == "dense":
        return lambda q, k, v: dense_attention(q, k, v, causal=True)
    if kind == "blockwise":
        return lambda q, k, v: blockwise_attention(q, k, v, block, causal=True)
    if kind == "flash":
        fblock = int(arch.get("flash_block", 1024))

        def flash_or_local(q, k, v):
            T = q.shape[1]
            if T % min(fblock, T) == 0:
                return flash_attention(q, k, v, causal=True)[0]
            if T % block == 0:
                return blockwise_attention(q, k, v, block, causal=True)
            return dense_attention(q, k, v, causal=True)
        return flash_or_local
    if kind == "ring":
        def ring_or_local(q, k, v):
            mesh = current_mesh()
            if mesh is None or mesh.shape.get("sp", 1) <= 1:
                if q.shape[1] % block == 0:
                    return blockwise_attention(q, k, v, block, causal=True)
                return dense_attention(q, k, v, causal=True)
            # The chunk kernels when the local chunk tiles; the scan ring
            # is the portable fallback.
            if pick_chunk_block(q.shape[1] // mesh.shape["sp"]) is not None:
                return make_ring_flash_attention(mesh)(q, k, v)
            return make_ring_attention(mesh)(q, k, v)
        return ring_or_local
    raise ValueError(f"attention kind {kind!r} is unknown or not ported")


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


class TransformerBlock(nn.Module):
    """Pre-LN attention and FFN; ``moe_experts`` > 0 replaces the dense
    ``mlp_up``/``mlp_down`` FFN with a per-token top-k MoE named ``moe``."""

    def __init__(self, d_model: int, n_heads: int, mlp_ratio: int,
                 attn_fn: Callable, compute_dtype: torch.dtype,
                 moe_experts: int = 0, moe_top_k: int = 2):
        super().__init__()
        self.n_heads = n_heads
        self.attn_fn = attn_fn
        self.compute_dtype = compute_dtype
        self.ln_attn = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.attn_out = nn.Linear(d_model, d_model)
        self.ln_mlp = nn.LayerNorm(d_model, eps=_LN_EPS)
        if moe_experts > 0:
            self.moe = MoEMLP(d_model, mlp_ratio * d_model, moe_experts,
                              moe_top_k, compute_dtype)
        else:
            self.mlp_up = nn.Linear(d_model, mlp_ratio * d_model)
            self.mlp_down = nn.Linear(mlp_ratio * d_model, d_model)

    def forward(self, x: torch.Tensor, readout_idx: torch.Tensor | None = None,
                cache: tuple[torch.Tensor, torch.Tensor] | None = None,
                t: int | None = None):
        """Full mode: x ``[B, T, d]`` -> ``[B, T, d]``.

        Readout mode (``readout_idx [B]``, the final layer of the window
        path): k and v project over every row, while the query, output
        projection and MLP run for each lane's one readout row, attended
        densely with that lane's causal offset. Returns ``[B, 1, d]``.

        Decode mode (``cache``, this layer's ``(k_cache, v_cache)`` ``[B,
        W, H, hd]``, and the write index ``t``): x holds positions ``t ..
        t + T - 1`` (T = 1 for a step, T = W for a prefill from ``t = 0``).
        This step's k and v are written into the cache at ``t``, in place
        (the cache takes no gradient), and the queries attend the cache
        with their causal offset, so rows past the last written position
        are never seen. Returns ``[B, T, d]``; the cache is updated."""
        B, T, d = x.shape
        cd = self.compute_dtype
        h = _layer_norm(self.ln_attn, x).to(cd)
        # Column thirds of the fused projection, each [B, T, H, hd]: views
        # that share strides, which the flash kernel reads in place.
        q, k, v = _dense(self.qkv, h, cd).view(
            B, T, 3, self.n_heads, d // self.n_heads).unbind(2)
        if readout_idx is not None:
            lanes = torch.arange(B, device=x.device)
            q_row = q[lanes, readout_idx][:, None]
            attn = dense_attention(q_row, k, v, causal=True,
                                   q_offset=readout_idx).reshape(B, 1, d)
            x = x[lanes, readout_idx][:, None]
        elif cache is not None:
            k_cache, v_cache = cache
            with torch.no_grad():
                k_cache[:, t:t + T] = k
                v_cache[:, t:t + T] = v
            attn = dense_attention(q, k_cache, v_cache, causal=True,
                                   q_offset=t).reshape(B, T, d)
        else:
            attn = self.attn_fn(q, k, v).reshape(B, T, d)
        x = x + _dense(self.attn_out, attn, cd).to(x.dtype)
        h = _layer_norm(self.ln_mlp, x)
        if hasattr(self, "moe"):
            return x + self.moe(h).to(x.dtype)
        h = F.gelu(_dense(self.mlp_up, h.to(cd), cd), approximate="tanh")
        return x + _dense(self.mlp_down, h, cd).to(x.dtype)


class TransformerCore(nn.Module):
    """Obs sequence -> per-step (logits, v). Residual stream stays f32.

    ``moe_experts`` > 0 gives every block the MoE FFN; ``stacked`` puts the
    layers under one ``blocks`` scope (the pipeline family's layout)."""

    def __init__(self, arch: Mapping[str, Any], moe_experts: int = 0,
                 stacked: bool = False):
        super().__init__()
        d_model = int(arch.get("d_model", 128))
        self.n_layers = int(arch.get("n_layers", 2))
        self.has_critic = bool(arch.get("has_critic", True))
        self.stacked = stacked
        self.attention = arch.get("attention", "dense")
        pp_micro = arch.get("pp_microbatches")
        self.pp_microbatches = None if pp_micro is None else int(pp_micro)
        # The window readout runs the final layer for the readout row alone
        # only in the plain family: the MoE family runs the block whole (as
        # the JAX family does) and the pipeline family the whole forward.
        self.row_readout = not (moe_experts or stacked)
        attn_fn = _resolve_attention(arch)
        cd = _compute_dtype(arch)
        self.obs_embed = nn.Linear(int(arch["obs_dim"]), d_model)
        self.pos_embed = nn.Parameter(
            torch.empty(int(arch.get("max_seq_len", 1024)), d_model))
        blocks = [TransformerBlock(d_model, int(arch.get("n_heads", 4)),
                                   int(arch.get("mlp_ratio", 4)), attn_fn, cd,
                                   moe_experts, int(arch.get("moe_top_k", 2)))
                  for _ in range(self.n_layers)]
        if stacked:
            self.blocks = nn.ModuleList(blocks)
        else:
            for i, block in enumerate(blocks):
                self.add_module(f"block_{i}", block)
        self.ln_final = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.pi_head = nn.Linear(d_model, int(arch["act_dim"]))
        if self.has_critic:
            self.vf_head_up = nn.Linear(d_model, d_model)
            self.vf_head = nn.Linear(d_model, 1)

    def layers(self) -> list[TransformerBlock]:
        if self.stacked:
            return list(self.blocks)
        return [getattr(self, f"block_{i}") for i in range(self.n_layers)]

    def _run_blocks(self, blocks, x: torch.Tensor) -> torch.Tensor:
        """``blocks`` (:meth:`layers`) over every row: the pipeline family
        under a mesh with ``pp`` above 1 as the GPipe schedule over
        ``pp``, else in order."""
        mesh = current_mesh()
        if self.stacked and mesh is not None and mesh.shape.get("pp", 1) > 1:
            if self.attention == "ring" and mesh.shape.get("sp", 1) > 1:
                raise ValueError(
                    f"mesh {mesh.shape}: ring attention (sp) inside the pipeline "
                    f"(pp) is not supported, as in the JAX package; use one of "
                    f"the two axes")
            return pipeline_apply(_run_stage, blocks, x, mesh, self.pp_microbatches)
        return _run_stage(blocks, x)

    def _heads(self, x, mask):
        x = _layer_norm(self.ln_final, x)
        logits = _dense(self.pi_head, x, torch.float32)
        if mask is not None:
            logits = torch.where(mask > 0, logits, _MASK_FILL)
        if self.has_critic:
            h = torch.tanh(_dense(self.vf_head_up, x, torch.float32))
            v = _dense(self.vf_head, h, torch.float32).squeeze(-1)
        else:
            v = torch.zeros(logits.shape[:-1], dtype=torch.float32,
                            device=logits.device)
        return logits, v

    def forward(self, obs, mask=None, readout_t=None, cache=None, t=None):
        """Full mode: obs ``[B, T, D]`` -> (logits ``[B, T, A]``, v ``[B, T]``).

        Readout mode (``readout_t [B]``, each lane's row): layers
        ``0..L-2`` run over every row, the final layer and the heads run
        for the one row (in the MoE and pipeline families every layer and
        the heads run over every row, and the row is taken after); returns
        (logits ``[B, A]``, v ``[B]``).

        Decode mode (``cache``, a tuple of per-layer ``(k, v)`` caches, and
        the position ``t`` of obs's first row): returns ``((logits ``[B, T,
        A]``, v ``[B, T]``), cache)`` with the cache written at ``t .. t +
        T - 1``."""
        T = obs.shape[1]
        start = 0 if cache is None else int(t)
        x = (_dense(self.obs_embed, obs, torch.float32)
             + self.pos_embed[start:start + T][None])
        blocks = self.layers()
        if cache is not None:
            for block, layer_cache in zip(blocks, cache):
                x = block(x, cache=layer_cache, t=start)
            return self._heads(x, mask), cache
        if readout_t is None:
            return self._heads(self._run_blocks(blocks, x), mask)
        if not self.row_readout:
            # The whole forward, then each lane's readout row.
            logits, v = self._heads(self._run_blocks(blocks, x), mask)
            lanes = torch.arange(logits.shape[0], device=logits.device)
            return logits[lanes, readout_t], v[lanes, readout_t]
        for block in blocks[:-1]:
            x = block(x)
        x = blocks[-1](x, readout_idx=readout_t)
        if mask is not None:
            # dynamic_slice semantics: the row index clamps into the mask.
            lanes = torch.arange(mask.shape[0], device=mask.device)
            mask = mask[lanes, readout_t.clamp(max=mask.shape[1] - 1)][:, None]
        logits, v = self._heads(x, mask)
        return logits[:, 0], v[:, 0]


def _run_stage(layers, x: torch.Tensor) -> torch.Tensor:
    for block in layers:
        x = block(x)
    return x


def _init_core(core: TransformerCore, generator: torch.Generator) -> None:
    """flax's initializers: Dense kernels lecun-normal (truncated at two
    standard deviations), biases zero, LayerNorm scale one, ``pos_embed``
    normal(0.02), the MoE expert stacks lecun-normal per expert."""
    for module in core.modules():
        if isinstance(module, nn.Linear):
            init_dense(module, generator)
        elif isinstance(module, nn.LayerNorm):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
        elif isinstance(module, MoEMLP):
            init_experts(module, generator)
    nn.init.normal_(core.pos_embed, std=0.02, generator=generator)


def _as_btd(obs, mask, device):
    """Normalize step/evaluate inputs to [B, T, D] (+ mask [B, T, A])."""
    obs = torch.as_tensor(obs, dtype=torch.float32, device=device)
    if obs.ndim == 1:          # [D] -> context of one
        obs, lead = obs[None, None], "scalar"
    elif obs.ndim == 2:        # [T, D]
        obs, lead = obs[None], "seq"
    else:                      # [B, T, D]
        lead = "batch"
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
        while mask.ndim < 3:
            mask = mask[None]
    return obs, mask, lead


def _check_kernel_head_dim(arch: Mapping[str, Any], device: torch.device) -> None:
    """On a CUDA device, ``attention="flash"`` and ``"ring"`` run the flash
    kernels, which take head dims up to the widest of
    :data:`KERNEL_HEAD_DIMS` (narrower ones are padded): refuse a wider one
    here, before anything lands on the device, rather than in the first
    forward. The CPU runs the plain versions, which take any head dim."""
    kind = arch.get("attention", "dense")
    if device.type != "cuda" or kind not in ("flash", "ring"):
        return
    d_model, n_heads = int(arch.get("d_model", 128)), int(arch.get("n_heads", 4))
    head_dim, limit = d_model // n_heads, max(KERNEL_HEAD_DIMS)
    if head_dim > limit:
        raise ValueError(
            f"attention={kind!r} on a CUDA device takes head dims up to {limit} "
            f"(the flash kernels' widest); d_model {d_model} / n_heads {n_heads} "
            f"gives head dim {head_dim}")


def _build_core_policy(arch: Mapping[str, Any], device: torch.device,
                       moe_experts: int = 0, stacked: bool = False) -> Policy:
    _check_kernel_head_dim(arch, device)

    def init_params(generator: torch.Generator) -> TransformerCore:
        with torch.device("meta"):
            core = TransformerCore(arch, moe_experts, stacked)
        core = core.to_empty(device="cpu")
        _init_core(core, generator)
        return core.to(device)

    def load_params(tree) -> TransformerCore:
        with torch.device("meta"):
            core = TransformerCore(arch, moe_experts, stacked)
        core = core.to_empty(device=device)
        core.load_state_dict(params_from_jax(tree))
        return core

    def step(params, generator, obs, mask=None):
        obs, mask, lead = _as_btd(obs, mask, device)
        logits, v = params(obs, mask)
        logits_last, v_last = logits[:, -1], v[:, -1]
        act = _categorical_sample(generator, logits_last)
        logp = _categorical_logp(logits_last, act)
        if lead != "batch":
            act, logp, v_last = act[0], logp[0], v_last[0]
        return act, {"logp_a": logp, "v": v_last}

    def evaluate(params, obs, act, mask=None):
        obs, mask, lead = _as_btd(obs, mask, device)
        act_b = torch.as_tensor(act, device=device)
        while act_b.ndim < 2:  # scalar -> [1,1], [T] -> [1,T]
            act_b = act_b[None]
        logits, v = params(obs, mask)
        logp = _categorical_logp(logits, act_b)
        ent = _categorical_entropy(logits)
        if lead != "batch":
            logp, ent, v = logp[0], ent[0], v[0]
        if lead == "scalar":
            logp, ent, v = logp[0], ent[0], v[0]
        return logp, ent, v

    def mode(params, obs, mask=None):
        obs, mask, lead = _as_btd(obs, mask, device)
        logits, _ = params(obs, mask)
        act = logits[:, -1].argmax(dim=-1)
        return act if lead == "batch" else act[0]

    def _window_logits(params, window, t, mask):
        """Readout logits and v of one window ``[W, D]`` (scalar ``t``) or
        of stacked windows ``[N, W, D]`` (``t [N]``), each read at row
        ``clip(t - 1, 0, W - 1)``."""
        windows = torch.as_tensor(window, dtype=torch.float32, device=device)
        single = windows.ndim == 2
        if single:
            windows = windows[None]
        t = torch.as_tensor(t, device=device).reshape(-1).long()
        idx = (t - 1).clamp(0, windows.shape[1] - 1)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
            if single:
                while mask.ndim < 3:
                    mask = mask[None]
            elif mask.ndim == 2:   # [N, A]: one mask row per lane
                mask = mask[:, None]
        logits, v = params(windows, mask, readout_t=idx)
        return logits, v, single

    def step_window(params, generator, window, t, mask=None):
        """Act from right-zero-padded history windows with ``t`` real rows:
        the readout position t-1 attends only positions < t (causal), so
        the padding is never seen and one shape serves every length."""
        logits, v, single = _window_logits(params, window, t, mask)
        act = _categorical_sample(generator, logits)
        aux = {"logp_a": _categorical_logp(logits, act), "v": v}
        if single:
            return act[0], {k: a[0] for k, a in aux.items()}
        return act, aux

    def mode_window(params, window, t, mask=None):
        """Greedy readout from history windows."""
        logits, _, single = _window_logits(params, window, t, mask)
        act = logits.argmax(dim=-1)
        return act[0] if single else act

    n_layers, n_heads = int(arch.get("n_layers", 2)), int(arch.get("n_heads", 4))
    head_dim = int(arch.get("d_model", 128)) // n_heads
    cache_dtype = _compute_dtype(arch)

    def init_cache(length: int, batch_size: int = 1):
        """Zeroed per-layer ``(k, v)`` caches ``[batch_size, length, H,
        hd]`` in the compute dtype, on the policy's device."""
        shape = (batch_size, int(length), n_heads, head_dim)
        return tuple((torch.zeros(shape, dtype=cache_dtype, device=device),
                      torch.zeros(shape, dtype=cache_dtype, device=device))
                     for _ in range(n_layers))

    def step_cached(params, generator, cache, obs, t, mask=None):
        """One decode step: writes position ``t`` into the cache and
        samples the action there. ``obs`` is ``[D]`` (one episode) or ``[B,
        D]`` (B episodes at the same position, a cache of batch B), not a
        time axis. Returns ``(act, aux, cache)``; the values match
        ``step_window``'s at the same position."""
        obs = torch.as_tensor(obs, dtype=torch.float32, device=device)
        obs = obs[None, None] if obs.ndim == 1 else obs[:, None]
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
            mask = mask[None, None] if mask.ndim == 1 else mask[:, None]
        (logits, v), cache = params(obs, mask, cache=cache, t=t)
        logits_t, v_t = logits[:, 0], v[:, 0]
        act = _categorical_sample(generator, logits_t)
        aux = {"logp_a": _categorical_logp(logits_t, act), "v": v_t}
        if obs.shape[0] == 1:
            return act[0], {k: a[0] for k, a in aux.items()}, cache
        return act, aux, cache

    def prefill_cache(params, cache, window):
        """Rebuilds the whole cache from a padded window ``[W, D]`` (or
        ``[B, W, D]``) in one forward from ``t = 0`` (after a hot swap, the
        cache holds the old params' k and v). The padding rows write k and
        v past the real prefix, which later steps overwrite in order before
        any query attends them."""
        window = torch.as_tensor(window, dtype=torch.float32, device=device)
        if window.ndim == 2:
            window = window[None]
        return params(window, None, cache=cache, t=0)[1]

    decode = {} if stacked else {"init_cache": init_cache, "step_cached": step_cached,
                                 "prefill_cache": prefill_cache}
    return Policy(arch=dict(arch), device=device, init_params=init_params,
                  load_params=load_params, step=step, evaluate=evaluate,
                  mode=mode, step_window=step_window, mode_window=mode_window,
                  **decode)


@register_model("transformer_discrete")
def build_transformer_discrete(arch: Mapping[str, Any],
                               device: torch.device) -> Policy:
    return _build_core_policy(arch, device)


@register_model("transformer_moe_discrete")
def build_transformer_moe_discrete(arch: Mapping[str, Any],
                                   device: torch.device) -> Policy:
    """Transformer whose FFNs are per-token top-k MoE layers
    (:mod:`relayrl_tpu_torch.models.moe`); the same sequence ABI and KV-cache
    decode as ``transformer_discrete``."""
    return _build_core_policy(arch, device,
                              moe_experts=int(arch.get("moe_experts", 4)))


@register_model("transformer_pp_discrete")
def build_transformer_pp_discrete(arch: Mapping[str, Any],
                                  device: torch.device) -> Policy:
    """``transformer_discrete``'s math with the layers under one ``blocks``
    scope (the JAX family stacks them for its pipeline; the flax tree's
    ``blocks`` leaves carry a leading layer axis, which
    :mod:`relayrl_tpu_torch.weights` splits into ``blocks.i``). Runs the
    layers as a GPipe pipeline under a mesh with ``pp`` above 1, else in
    order."""
    return _build_core_policy(arch, device, stacked=True)
