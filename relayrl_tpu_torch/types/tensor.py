"""Tensor ⇄ bytes wire codec.

Capability parity with the reference's safetensors codec
(reference: relayrl_framework/src/types/action.rs:287-354, 368-418 —
tch::Tensor → contiguous buffer → safetensors bytes and back). The reference
round-trips every tensor through the safetensors container per action; here
the framing is a fixed little-endian header followed by the raw buffer, so
decode is a single `np.frombuffer` view (zero-copy on the receive path) and
the C++ native codec (native/wire.cc) can parse it without a JSON header.

Wire layout (all little-endian):

    u16 magic 0x5254 ("RT") | u8 version | u8 dtype tag | u8 ndim
    | ndim × u32 dims | payload bytes (C-contiguous)
"""

from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np

from relayrl_tpu_torch.types.dtypes import DType, from_numpy_dtype, to_numpy_dtype

_MAGIC = 0x5254
_VERSION = 1
_HEADER = struct.Struct("<HBBB")  # magic, version, dtype, ndim
_MAX_NDIM = 16
# Decode is the server ingest hot path (~2 tensors per ActionRecord at
# fleet rate) — resolve dtype tags through a flat dict instead of the
# enum constructor + mapping lookup, and count elements with math.prod
# (np.prod on a small tuple costs a ufunc reduction per tensor). bfloat16
# is left out of the dict and resolved at decode time, so that importing
# this module never imports ml_dtypes.
_NP_BY_TAG = {int(tag): to_numpy_dtype(tag) for tag in DType
              if tag != DType.BFLOAT16}
_PREPACKED_DIMS = [struct.Struct(f"<{n}I") for n in range(_MAX_NDIM + 1)]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape + dtype of a wire tensor (ref: TensorData sans payload,
    relayrl_framework/src/types/action.rs:196-201)."""

    shape: tuple[int, ...]
    dtype: DType

    @property
    def np_dtype(self) -> np.dtype:
        return to_numpy_dtype(self.dtype)

    @property
    def nbytes(self) -> int:
        n = self.np_dtype.itemsize
        for d in self.shape:
            n *= d
        return n


def encode_tensor(array) -> bytes:
    """ndarray/scalar → wire bytes."""
    arr = np.asarray(array)
    if not arr.flags.c_contiguous:
        # ascontiguousarray would also promote 0-d scalars to 1-d; only copy
        # when the layout actually requires it.
        arr = np.ascontiguousarray(arr)
    tag = from_numpy_dtype(arr.dtype)
    if arr.ndim > _MAX_NDIM:
        raise ValueError(f"tensor rank {arr.ndim} exceeds wire max {_MAX_NDIM}")
    header = _HEADER.pack(_MAGIC, _VERSION, int(tag), arr.ndim)
    dims = _PREPACKED_DIMS[arr.ndim].pack(*arr.shape)
    return header + dims + arr.tobytes()


def decode_tensor(buf: bytes | memoryview) -> np.ndarray:
    """Wire bytes → ndarray (zero-copy view over the input buffer)."""
    view = memoryview(buf)
    if len(view) < _HEADER.size:
        raise ValueError("truncated tensor frame: missing header")
    magic, version, tag, ndim = _HEADER.unpack_from(view, 0)
    if magic != _MAGIC:
        raise ValueError(f"bad tensor frame magic: {magic:#06x}")
    if version != _VERSION:
        raise ValueError(f"unsupported tensor frame version: {version}")
    if ndim > _MAX_NDIM:
        raise ValueError(f"tensor rank {ndim} exceeds wire max {_MAX_NDIM}")
    dims_end = _HEADER.size + 4 * ndim
    if len(view) < dims_end:
        raise ValueError("truncated tensor frame: missing dims")
    shape = _PREPACKED_DIMS[ndim].unpack_from(view, _HEADER.size)
    np_dtype = _NP_BY_TAG.get(tag)
    if np_dtype is None:
        np_dtype = to_numpy_dtype(tag)  # bfloat16, or raises on a bad tag
    expected = math.prod(shape) * np_dtype.itemsize
    payload = view[dims_end:]
    if len(payload) != expected:
        raise ValueError(
            f"tensor frame payload size {len(payload)} != expected {expected} "
            f"for shape {shape} dtype {np_dtype}"
        )
    return np.frombuffer(payload, dtype=np_dtype).reshape(shape)


def spec_of(buf: bytes | memoryview) -> TensorSpec:
    """Parse just the header — used by ingest staging to pre-size batches."""
    view = memoryview(buf)
    if len(view) < _HEADER.size:
        raise ValueError("truncated tensor frame: missing header")
    magic, version, tag, ndim = _HEADER.unpack_from(view, 0)
    if magic != _MAGIC or version != _VERSION:
        raise ValueError("bad tensor frame header")
    if ndim > _MAX_NDIM:
        raise ValueError(f"tensor rank {ndim} exceeds wire max {_MAX_NDIM}")
    if len(view) < _HEADER.size + 4 * ndim:
        raise ValueError("truncated tensor frame: missing dims")
    shape = _PREPACKED_DIMS[ndim].unpack_from(view, _HEADER.size)
    return TensorSpec(shape=tuple(shape), dtype=DType(tag))
