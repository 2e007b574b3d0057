"""Core data types and wire codecs, byte-compatible with the JAX package's."""

from relayrl_tpu_torch.types.dtypes import DType, from_numpy_dtype, to_numpy_dtype
from relayrl_tpu_torch.types.tensor import TensorSpec, decode_tensor, encode_tensor, spec_of
from relayrl_tpu_torch.types.action import ActionRecord, EXT_TENSOR
from relayrl_tpu_torch.types.trajectory import (
    Trajectory,
    deserialize_actions,
    serialize_actions,
)
from relayrl_tpu_torch.types.model_bundle import ModelBundle, arch_equal

__all__ = [
    "DType",
    "from_numpy_dtype",
    "to_numpy_dtype",
    "TensorSpec",
    "encode_tensor",
    "decode_tensor",
    "spec_of",
    "ActionRecord",
    "EXT_TENSOR",
    "Trajectory",
    "serialize_actions",
    "deserialize_actions",
    "ModelBundle",
    "arch_equal",
]
