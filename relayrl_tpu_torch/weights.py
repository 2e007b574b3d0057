"""Weights across the two packages: the flax state-dict tree <-> the port's
module state dicts.

A :class:`~relayrl_tpu_torch.types.model_bundle.ModelBundle` carries params
as the flax tree of numpy arrays, ``{"params": {scope: {...}}}``. Names map
one to one, scopes joined by ``"."``:

* a Dense ``kernel [in, out]`` is a ``Linear.weight [out, in]`` (transposed);
* a LayerNorm ``scale`` is a ``LayerNorm.weight``;
* every other leaf (``bias``, a bare param such as ``pos_embed``) keeps its
  name and shape.

So ``params["params"]["block_0"]["qkv"]["kernel"]`` is
``block_0.qkv.weight.T``.
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


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax params tree (``{"params": {...}}``) -> state dict (CPU tensors)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for name, leaf in node.items():
            if isinstance(leaf, Mapping):
                walk(leaf, f"{prefix}{name}.")
            elif name == "kernel":
                out[f"{prefix}weight"] = _to_tensor(leaf).T.contiguous()
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
    if name == "weight" and isinstance(owner, nn.Linear):
        name = "kernel"
    elif name == "weight" and isinstance(owner, nn.LayerNorm):
        name = "scale"
    return (*filter(None, owner_path.split(".")), name)


def params_to_jax(module: nn.Module) -> dict[str, Any]:
    """Module -> flax params tree of numpy arrays, keys sorted at every
    level (the order JAX's tree utilities give a params dict)."""
    tree: dict[str, Any] = {}
    for key, tensor in module.state_dict().items():
        *scopes, name = flax_path(module, key)
        if name == "kernel":
            tensor = tensor.T
        node = tree
        for part in scopes:
            node = node.setdefault(part, {})
        node[name] = tensor.detach().cpu().numpy().copy()  # owns its memory
    return {"params": _sorted_tree(tree)}
