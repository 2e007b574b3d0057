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

A module placed on a mesh (:func:`relayrl_tpu_torch.parallel.place_state`)
holds a split parameter as shards under ``torch.nn.utils.parametrize``
(``<owner>.parametrizations.<leaf>.original<i>``). Everything here speaks
of the logical leaf, ``<owner>.<leaf>``: :func:`logical_state` gathers
it, :func:`write_logical` splits a whole value into its shards, and
:func:`flax_path` maps a shard's name to its leaf's path, so a placed
module's bundle, checkpoint and freeze mask are the unplaced module's.
Where a split crosses processes (a mesh whose fsdp, ep or tp axis spans
them), a process holds only its shards, and where pp does, only its
pipeline stages' layers (another rank's layer is a ``meta`` tensor:
:class:`~relayrl_tpu_torch.parallel.sharding.Stages`): :func:`logical_state`,
:func:`params_to_jax` and everything that reads a placed parameter whole
are collective then (every rank calls them, in the same order, and each
gets the whole tensors: a stage's from its owner), and
:func:`load_logical` keeps this rank's shards and stages of each whole
value (:func:`gathers_across_processes`).
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


def logical_key(key: str) -> str:
    """A state-dict key with a shard's parametrization path folded back
    into its leaf: ``"a.parametrizations.weight.original1"`` ->
    ``"a.weight"``; other keys pass through."""
    head, sep, tail = key.partition("parametrizations.")
    return head + tail.split(".")[0] if sep else key


def _owner(module: nn.Module, key: str) -> tuple[nn.Module, str]:
    owner_path, _, name = key.rpartition(".")
    return module.get_submodule(owner_path), name


def is_placed(module: nn.Module) -> bool:
    """Whether :func:`relayrl_tpu_torch.parallel.place_state` has placed
    ``module`` on a mesh (it records the unplaced keys on the module)."""
    return getattr(module, "_logical_keys", None) is not None


def gathers_across_processes(module: nn.Module) -> bool:
    """Whether reading ``module``'s parameters whole is a collective: a
    split of one of them crosses processes, or its pipeline stages do."""
    from relayrl_tpu_torch.parallel.sharding import Shards, stages

    return stages(module) is not None or any(
        isinstance(m, Shards) and m.crosses for m in module.modules())


def logical_keys(module: nn.Module) -> list[str]:
    """The state-dict keys ``module`` had before it was placed, in order
    (its own keys when it was never placed)."""
    return list(module._logical_keys if is_placed(module) else module.state_dict())


def logical_state(module: nn.Module) -> dict[str, torch.Tensor]:
    """``module``'s state dict by logical key, in the unplaced order: a
    placed parameter gathered whole (a fresh tensor on its compute
    device; from every rank where its split crosses processes), another
    rank's pipeline stage's from its owner (on this rank's first device),
    every other entry the live tensor, detached."""
    from relayrl_tpu_torch.parallel.sharding import stages

    live = module.state_dict()
    keys = logical_keys(module)
    record = stages(module)
    out = {}
    with torch.no_grad():
        remote = {} if record is None else record.gather(
            keys, live, next(t.device for t in live.values() if not t.is_meta))
        for key in keys:
            if key in remote:
                out[key] = remote[key]
            elif key in live:
                out[key] = live[key]
            else:
                owner, name = _owner(module, key)
                out[key] = getattr(owner, name).detach()
    return out


def logical_shapes(module: nn.Module) -> dict[str, tuple[int, ...]]:
    """Parameter name -> shape, by logical name, without gathering."""
    from torch.nn.utils import parametrize

    params = dict(module.named_parameters())
    out = {}
    for key in logical_keys(module):
        if key in params:
            out[key] = tuple(params[key].shape)
            continue
        owner, name = _owner(module, key)
        if parametrize.is_parametrized(owner, name):
            out[key] = tuple(owner.parametrizations[name][0].shape)
    return out


def _checked(module: nn.Module, live: dict, key: str, value: torch.Tensor) -> None:
    """Raise unless ``value`` has the shape of ``module``'s entry ``key``:
    the live tensor's, or a placed parameter's whole shape."""
    if key in live:
        want = tuple(live[key].shape)
    else:
        owner, name = _owner(module, key)
        want = owner.parametrizations[name][0].shape
    if tuple(value.shape) != want:
        raise ValueError(f"{key}: shape {tuple(value.shape)} does not match {want}")


def _write(module: nn.Module, live: dict, key: str, value: torch.Tensor) -> None:
    with torch.no_grad():
        if key in live:
            if not live[key].is_meta:  # another rank's pipeline stage
                live[key].copy_(value)
            return
        owner, name = _owner(module, key)
        plist = owner.parametrizations[name]
        for i, piece in enumerate(plist[0].right_inverse(value)):
            getattr(plist, f"original{i}").copy_(piece)


def write_logical(module: nn.Module, key: str, value: torch.Tensor) -> None:
    """Copy a whole ``value`` into ``module``'s entry ``key`` (a logical
    key), in place: into the live tensor, or split into a placed
    parameter's shards. A value of another shape raises."""
    live = module.state_dict()
    _checked(module, live, key, value)
    _write(module, live, key, value)


def load_logical(module: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """``load_state_dict`` by logical keys: every key of
    :func:`logical_keys` written in place (:func:`write_logical`). Keys
    and shapes are checked before anything is written."""
    keys = logical_keys(module)
    if set(keys) != set(state):
        raise KeyError(f"state keys differ: missing {sorted(set(keys) - set(state))}, "
                       f"unexpected {sorted(set(state) - set(keys))}")
    live = module.state_dict()
    for key in keys:
        _checked(module, live, key, state[key])
    for key in keys:
        _write(module, live, key, state[key])
    return module


def flax_path(module: nn.Module, key: str) -> tuple[str, ...]:
    """The flax tree path of state-dict entry ``key`` of ``module``, below
    ``"params"``: ``"block_0.qkv.weight"`` -> ``("block_0", "qkv",
    "kernel")``; a placed parameter's shard maps to its leaf's path."""
    owner_path, _, name = logical_key(key).rpartition(".")
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
    return state_to_jax(module, logical_state(module))


def load_flat(module: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy a host state dict into ``module``'s tensors through ONE
    host-to-device copy: the host tensors are packed into one byte
    buffer, moved once, and scattered on the device. Bit-exact: only
    bytes move. A placed module takes each whole value split into its
    shards (:func:`write_logical`)."""
    if is_placed(module):
        return load_logical(module, state)
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
