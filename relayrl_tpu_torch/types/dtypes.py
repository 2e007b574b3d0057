"""Dtype system for wire-serialized tensors.

Capability parity with the reference's 7-dtype system
(reference: relayrl_framework/src/types/action.rs:92-191 — Byte/Short/Int/
Long/Float/Double/Bool with conversions to/from safetensors and tch kinds),
re-based on numpy dtypes instead of torch kinds.

The wire tags are stable u8 values — they are part of the framework's wire
ABI and must never be renumbered.
"""

from __future__ import annotations

import enum

import numpy as np


class DType(enum.IntEnum):
    """Wire dtype tags. Values are part of the wire format — append-only."""

    UINT8 = 0  # ref "Byte"
    INT16 = 1  # ref "Short"
    INT32 = 2  # ref "Int"
    INT64 = 3  # ref "Long"
    FLOAT32 = 4  # ref "Float"
    FLOAT64 = 5  # ref "Double"
    BOOL = 6  # ref "Bool"
    # Additions (not in the reference): bf16 is the tensor cores' preferred
    # compute/storage dtype and f16 appears in mixed-precision pipelines.
    BFLOAT16 = 7
    FLOAT16 = 8


_NP_BY_DTYPE: dict[DType, np.dtype] = {
    DType.UINT8: np.dtype(np.uint8),
    DType.INT16: np.dtype(np.int16),
    DType.INT32: np.dtype(np.int32),
    DType.INT64: np.dtype(np.int64),
    DType.FLOAT32: np.dtype(np.float32),
    DType.FLOAT64: np.dtype(np.float64),
    DType.BOOL: np.dtype(np.bool_),
    DType.FLOAT16: np.dtype(np.float16),
}


def _bfloat16_dtype() -> np.dtype:
    """numpy's bfloat16 comes from ``ml_dtypes``, imported here and not at
    module import: hosts that never touch a bf16 wire tensor need not have
    it installed."""
    try:
        import ml_dtypes
    except ImportError:
        raise ValueError(
            "wire dtype bfloat16 needs the ml_dtypes package") from None
    return np.dtype(ml_dtypes.bfloat16)


_DTYPE_BY_NP: dict[np.dtype, DType] = {v: k for k, v in _NP_BY_DTYPE.items()}


def to_numpy_dtype(tag: DType) -> np.dtype:
    """Wire tag → numpy dtype."""
    try:
        tag = DType(tag)
    except ValueError:
        raise ValueError(f"unsupported wire dtype tag: {tag!r}") from None
    if tag == DType.BFLOAT16:
        return _bfloat16_dtype()
    return _NP_BY_DTYPE[tag]


def from_numpy_dtype(dtype) -> DType:
    """numpy dtype → wire tag."""
    np_dtype = np.dtype(dtype)
    if np_dtype.name == "bfloat16":
        return DType.BFLOAT16
    try:
        return _DTYPE_BY_NP[np_dtype]
    except KeyError:
        raise ValueError(
            f"dtype {np_dtype} has no wire encoding; supported: "
            f"{sorted(d.name for d in DType)}"
        ) from None


def itemsize(tag: DType) -> int:
    return to_numpy_dtype(tag).itemsize
