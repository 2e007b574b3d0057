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


def state_to_jax(module: nn.Module,
                 state: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """A state dict of ``module``'s layout (e.g. a host copy of it) ->
    the flax params tree of numpy arrays, keys sorted at every level (the
    order JAX's tree utilities give a params dict)."""
    tree: dict[str, Any] = {}
    for key, tensor in state.items():
        *scopes, name = flax_path(module, key)
        if name == "kernel":
            tensor = tensor.T
        node = tree
        for part in scopes:
            node = node.setdefault(part, {})
        node[name] = _to_numpy(tensor)
    return {"params": _sorted_tree(tree)}


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
