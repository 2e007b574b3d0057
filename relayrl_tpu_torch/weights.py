"""Weights across the two packages: the flax state-dict tree <-> the port's
module state dicts.

A :class:`~relayrl_tpu_torch.types.model_bundle.ModelBundle` carries params
as the flax tree of numpy arrays, ``{"params": {scope: {...}}}``. Names map
one to one, scopes joined by ``"."``:

* a Dense ``kernel [in, out]`` is a ``Linear.weight [out, in]`` (transposed);
* a Conv ``kernel [kh, kw, in, out]`` is a ``Conv2d.weight [out, in, kh,
  kw]``;
* a LayerNorm ``scale`` is a ``LayerNorm.weight``;
* every other leaf (``bias``, a bare param such as ``pos_embed`` or the MoE
  expert stacks ``moe_w_up [E, d, ff]`` and ``moe_w_down [E, ff, d]``, which
  are not Dense kernels) keeps its name and shape;
* the pipeline transformer's top-level ``blocks`` subtree, whose leaves
  stack the layers on a leading axis ``L``, is the port's ``blocks.0 ..
  blocks.{L-1}``, one module per layer (each layer's slice mapped as
  above).

So ``params["params"]["block_0"]["qkv"]["kernel"]`` is
``block_0.qkv.weight.T``, and ``params["params"]["blocks"]["qkv"]["kernel"][i]``
is ``blocks.{i}.qkv.weight.T``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _to_tensor(leaf) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # own, writable copy


# The pipeline transformer's stacked layer subtree (flax scope name).
STACKED_BLOCKS = "blocks"


def _kernel_to_torch(kernel: torch.Tensor) -> torch.Tensor:
    if kernel.ndim == 4:  # Conv [kh, kw, in, out] -> [out, in, kh, kw]
        return kernel.permute(3, 2, 0, 1).contiguous()
    if kernel.ndim != 2:
        raise ValueError(f"a {kernel.ndim}-D Dense kernel {tuple(kernel.shape)}")
    return kernel.T.contiguous()


def _kernel_to_flax(weight: torch.Tensor) -> torch.Tensor:
    return weight.permute(2, 3, 1, 0) if weight.ndim == 4 else weight.T


def _layer(node: Mapping[str, Any], i: int) -> dict:
    """Layer ``i`` of a stacked subtree (every leaf's leading axis)."""
    return {k: _layer(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in node.items()}


def _n_layers(node: Mapping[str, Any]) -> int:
    leaf = next(iter(node.values()))
    return _n_layers(leaf) if isinstance(leaf, Mapping) else len(leaf)


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax params tree (``{"params": {...}}``) -> state dict (CPU tensors)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for name, leaf in node.items():
            if isinstance(leaf, Mapping):
                if not prefix and name == STACKED_BLOCKS:
                    for i in range(_n_layers(leaf)):
                        walk(_layer(leaf, i), f"{name}.{i}.")
                else:
                    walk(leaf, f"{prefix}{name}.")
            elif name == "kernel":
                out[f"{prefix}weight"] = _kernel_to_torch(_to_tensor(leaf))
            elif name == "scale":
                out[f"{prefix}weight"] = _to_tensor(leaf)
            else:
                out[f"{prefix}{name}"] = _to_tensor(leaf)

    walk(tree["params"], "")
    return out


def _sorted_tree(node):
    if isinstance(node, dict):
        return {k: _sorted_tree(node[k]) for k in sorted(node)}
    return node


def flax_path(module: nn.Module, key: str) -> tuple[str, ...]:
    """The flax tree path of state-dict entry ``key`` of ``module``, below
    ``"params"``: ``"block_0.qkv.weight"`` -> ``("block_0", "qkv",
    "kernel")``."""
    owner_path, _, name = key.rpartition(".")
    owner = module.get_submodule(owner_path)
    if name == "weight" and isinstance(owner, (nn.Linear, nn.Conv2d)):
        name = "kernel"
    elif name == "weight" and isinstance(owner, nn.LayerNorm):
        name = "scale"
    return (*filter(None, owner_path.split(".")), name)


def state_to_jax(module: nn.Module,
                 state: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """A state dict of ``module``'s layout (e.g. a host copy of it) ->
    the flax params tree of numpy arrays, keys sorted at every level (the
    order JAX's tree utilities give a params dict)."""
    tree: dict[str, Any] = {}
    for key, tensor in state.items():
        *scopes, name = flax_path(module, key)
        if name == "kernel":
            tensor = _kernel_to_flax(tensor)
        node = tree
        for part in scopes:
            node = node.setdefault(part, {})
        node[name] = _to_numpy(tensor)
    if isinstance(getattr(module, STACKED_BLOCKS, None), nn.ModuleList):
        layers = tree[STACKED_BLOCKS]
        tree[STACKED_BLOCKS] = _stack([layers[str(i)] for i in range(len(layers))])
    return {"params": _sorted_tree(tree)}


def _stack(layers: list) -> Any:
    """Per-layer subtrees -> one subtree whose leaves stack them on a
    leading axis (the flax layout of a ``vmap``-initialised stack)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return np.stack(layers)


def _to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """A host copy that owns its memory (bfloat16 via ``ml_dtypes``)."""
    tensor = tensor.detach().cpu()
    if tensor.dtype == torch.bfloat16:
        import ml_dtypes

        return (tensor.contiguous().view(torch.int16).numpy()
                .view(ml_dtypes.bfloat16).copy())
    return tensor.numpy().copy()


def params_to_jax(module: nn.Module) -> dict[str, Any]:
    """Module -> flax params tree of numpy arrays, keys sorted at every
    level (the order JAX's tree utilities give a params dict)."""
    return state_to_jax(module, module.state_dict())


def load_flat(module: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy a host state dict into ``module``'s tensors through ONE
    host-to-device copy: the host tensors are packed into one byte
    buffer, moved once, and scattered on the device. Bit-exact: only
    bytes move."""
    targets = module.state_dict()
    parts = [state[k].contiguous().reshape(-1).view(torch.uint8)
             for k in targets]
    device = next(iter(targets.values())).device
    flat = torch.cat(parts).to(device)
    off = 0
    with torch.no_grad():
        for (key, dst), part in zip(targets.items(), parts):
            n = part.numel()
            dst.copy_(flat[off:off + n].view(dst.dtype).view(dst.shape))
            off += n
    return module


def tree_digest(tree) -> str:
    """sha256 over a params tree's leaves (manifest order, raw bytes,
    with their paths, dtypes and shapes): equal digests mean bit-equal
    params."""
    import hashlib

    from relayrl_tpu_torch.types.model_bundle import leaf_manifest

    manifest, leaves = leaf_manifest(tree)
    h = hashlib.sha256(repr(manifest).encode())
    for leaf in leaves:
        h.update(np.ascontiguousarray(leaf).view(np.uint8).tobytes())
    return h.hexdigest()
