"""Parallelism: meshes, the ambient mesh, the sharding rules, sharded
learner updates, the GPipe pipeline and sequence-parallel ring attention.

Counterpart of :mod:`relayrl_tpu.parallel`, single-controller inside a
process (one process drives every shard of its sub-mesh). ``compat.py``
there binds the moving ``jax.shard_map`` API; its single-controller
counterparts are :func:`~relayrl_tpu_torch.parallel.ring.run_ring` and
:func:`~relayrl_tpu_torch.parallel.pipeline.pipeline_apply`. Across
processes (:mod:`~relayrl_tpu_torch.parallel.distributed`, a
``torch.distributed`` process group) every axis of a mesh may span them,
``pp`` beside any other (each rank's blocks a sub-grid of the mesh).
"""

from relayrl_tpu_torch.parallel.mesh import (
    AXES,
    CrossProcessAxisError,
    Mesh,
    data_axes,
    make_mesh,
    resolve_mesh_shape,
    single_device_mesh,
)
from relayrl_tpu_torch.parallel.sharding import (
    batch_pspec,
    param_pspec,
    params_shardings,
    replicated,
    sequence_batch_pspec,
    state_shardings,
)
from relayrl_tpu_torch.parallel.learner import (
    batch_shardings,
    make_sharded_update,
    place_batch,
    place_state,
)
from relayrl_tpu_torch.parallel.pipeline import pipeline_apply, resolve_microbatches
from relayrl_tpu_torch.parallel.context import current_mesh, use_mesh
from relayrl_tpu_torch.parallel.distributed import (
    broadcast_from_coordinator,
    initialize_distributed,
    is_coordinator,
    process_index,
    shutdown_distributed,
)
from relayrl_tpu_torch.parallel.ring import (
    make_ring_attention,
    ring_attention_sharded,
)
from relayrl_tpu_torch.parallel.ring_flash import (
    make_ring_flash_attention,
    ring_flash_attention_sharded,
)

__all__ = [
    "AXES",
    "CrossProcessAxisError",
    "Mesh",
    "data_axes",
    "make_mesh",
    "resolve_mesh_shape",
    "single_device_mesh",
    "batch_pspec",
    "param_pspec",
    "params_shardings",
    "replicated",
    "sequence_batch_pspec",
    "state_shardings",
    "pipeline_apply",
    "resolve_microbatches",
    "batch_shardings",
    "make_sharded_update",
    "place_batch",
    "place_state",
    "current_mesh",
    "use_mesh",
    "broadcast_from_coordinator",
    "initialize_distributed",
    "is_coordinator",
    "process_index",
    "shutdown_distributed",
    "make_ring_attention",
    "ring_attention_sharded",
    "make_ring_flash_attention",
    "ring_flash_attention_sharded",
]
