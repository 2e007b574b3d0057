"""Model distribution format: params + architecture config + version.

The same wire format as the JAX package's bundle, without flax:

* ``arch``    — a JSON-able architecture config consumed by the model
                registry (:mod:`relayrl_tpu_torch.models`),
* ``params``  — the flax state-dict tree of numpy arrays
                (``{"params": {"block_0": {"qkv": {"kernel", "bias"}}}}``):
                the format that crosses between the two packages.
                :mod:`relayrl_tpu_torch.weights` converts it to and from
                the port's modules,
* ``version`` — a monotonically increasing int; actors skip stale updates.

:meth:`ModelBundle.to_bytes` reproduces flax's msgpack state-dict encoding
byte for byte (``flax.serialization.to_bytes``): dicts keep their insertion
order, lists and tuples become ``{"0": ..., "1": ...}`` dicts, and an
ndarray leaf is msgpack ext type 1 holding ``(shape, dtype name, raw C-order
bytes)`` (a numpy scalar is ext type 3 with the same payload). So a bundle
published by a JAX learner installs here, and a bundle published here loads
in the JAX package.

``msgpack`` (and ``ml_dtypes`` for bfloat16 leaves) are imported inside the
functions that encode or decode.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

WIRE_VERSION = 1

# flax.serialization._MsgpackExtType
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
# flax.serialization.MAX_CHUNK_SIZE: flax splits leaves above it into a
# chunked dict form that this codec does not produce.
_MAX_LEAF_BYTES = 2 ** 30


@dataclasses.dataclass
class ModelBundle:
    version: int
    arch: dict[str, Any]
    params: Any  # flax state-dict tree of numpy arrays

    def to_bytes(self) -> bytes:
        import msgpack

        wire = {
            "v": WIRE_VERSION,
            "ver": int(self.version),
            "arch": dict(self.arch),
            "params": _state_dict_to_bytes(self.params),
        }
        return msgpack.packb(wire, use_bin_type=True)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "ModelBundle":
        """Decode a bundle; params come back as nested dicts of numpy
        arrays (flax's ``msgpack_restore``)."""
        import msgpack

        wire = msgpack.unpackb(buf, raw=False, strict_map_key=False)
        if wire.get("v") != WIRE_VERSION:
            raise ValueError(f"unsupported model bundle version: {wire.get('v')}")
        params = msgpack.unpackb(wire["params"], ext_hook=_ext_unpack,
                                 raw=False)
        return cls(version=int(wire["ver"]), arch=dict(wire["arch"]),
                   params=params)

    def save(self, path) -> None:
        """Write :meth:`to_bytes` to ``path`` atomically (temp file, then
        rename), as the JAX package's bundle does."""
        import os

        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            f.write(self.to_bytes())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path) -> "ModelBundle":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())


def _state_dict(tree):
    """flax ``to_state_dict`` for trees of dicts, lists and tuples."""
    if isinstance(tree, Mapping):
        out = {str(k): _state_dict(v) for k, v in tree.items()}
        if len(out) != len(tree):
            raise ValueError(
                f"dict keys do not have a unique string form: {list(tree)}")
        return out
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if not isinstance(tree, (np.ndarray, np.generic)) and hasattr(
            tree, "__array__"):
        return np.array(tree)  # device arrays serialize as host copies
    return tree


def _ndarray_payload(arr: np.ndarray) -> bytes:
    import msgpack

    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no wire form")
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(x):
    import msgpack

    if isinstance(x, np.ndarray):
        if x.size * x.dtype.itemsize > _MAX_LEAF_BYTES:
            raise ValueError(
                f"param leaf of {x.size * x.dtype.itemsize} bytes exceeds "
                f"the unchunked limit {_MAX_LEAF_BYTES}")
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_payload(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    return x


def _state_dict_to_bytes(params) -> bytes:
    import msgpack

    return msgpack.packb(_state_dict(params), default=_ext_pack,
                         strict_types=True)


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        import ml_dtypes

        dtype = np.dtype(ml_dtypes.bfloat16)
    else:
        dtype = np.dtype(dtype_name)
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")


def _ext_unpack(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_payload(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_payload(data)[()]
    return msgpack.ExtType(code, data)


# Arch keys the learner may change between publishes without changing the
# parameter ABI — exploration schedules ride the arch config. Everything
# else is structural: a mismatch means the params won't fit the network.
EXPLORATION_ARCH_KEYS = frozenset({"epsilon", "act_noise"})


def exploration_kwargs(arch: Mapping[str, Any]) -> dict[str, float]:
    """Exploration knobs present in ``arch``, as the float kwargs the
    policy ``step`` takes."""
    return {k: float(arch[k]) for k in EXPLORATION_ARCH_KEYS if k in arch}


def _flatten_with_path(tree, path=()):
    """``jax.tree_util.tree_flatten_with_path`` for trees of dicts, lists
    and tuples: leaves in JAX's order (dict keys sorted, sequences by
    index), each with its path of STRING keys (the flax state-dict
    convention, so a list node and its ``{"0": ...}`` restore agree).
    None is an empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        out = []
        for key in sorted(tree):
            out += _flatten_with_path(tree[key], (*path, str(key)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += _flatten_with_path(sub, (*path, str(i)))
        return out
    return [(list(path), tree)]


def leaf_manifest(params: Any) -> tuple[list[list], list]:
    """Flatten a params tree into ``(manifest, leaves)``:
    ``manifest[i] = [path_keys, dtype_str, shape]`` and ``leaves[i]`` the
    matching C-contiguous host array (the JAX package's manifest for the
    same tree)."""
    manifest, leaves = [], []
    for path, leaf in _flatten_with_path(params):
        arr = np.ascontiguousarray(np.asarray(leaf))
        manifest.append([path, str(arr.dtype), list(arr.shape)])
        leaves.append(arr)
    return manifest, leaves


def tree_from_leaves(manifest: list, leaves: list,
                     params_template: Any | None = None) -> Any:
    """Assemble ``leaves`` back into nested dicts keyed by the manifest
    paths (the structural restore ``ModelBundle.from_bytes`` does).
    ``params_template`` is accepted for the JAX package's signature; the
    port's trees are plain dicts, so it only checks that every template
    leaf is on the wire."""
    if params_template is not None:
        on_wire = {tuple(entry[0]) for entry in manifest}
        for path, _leaf in _flatten_with_path(params_template):
            if tuple(path) not in on_wire:
                raise ValueError(
                    f"params_template has leaf {tuple(path)} absent from "
                    f"the wire manifest — template and published tree "
                    f"diverge")
    root: dict = {}
    for (path, _dtype, _shape), leaf in zip(manifest, leaves):
        if not path:
            return leaf  # single-leaf tree (bare array params)
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return root


def arch_equal(a: Mapping[str, Any], b: Mapping[str, Any]) -> bool:
    """Structural arch-config equality — the actor refuses a hot-swap whose
    arch differs from the one it validated (param-ABI guard).
    Exploration-only keys are exempt."""
    sa = {k: v for k, v in a.items() if k not in EXPLORATION_ARCH_KEYS}
    sb = {k: v for k, v in b.items() if k not in EXPLORATION_ARCH_KEYS}
    return sa == sb
