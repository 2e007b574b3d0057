"""Parallelism: meshes, the ambient mesh, sequence-parallel ring attention
and sharded learner updates.

Counterpart of :mod:`relayrl_tpu.parallel`, single-controller (one process
drives every shard). Not ported yet: the param sharding rules
(``sharding.py``), multi-process ``torch.distributed`` (``distributed.py``),
the pipeline (``pipeline.py``) and ``compat.py`` (ROADMAP queue 1 item 11).
"""

from relayrl_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    data_axes,
    make_mesh,
    resolve_mesh_shape,
    single_device_mesh,
)
from relayrl_tpu_torch.parallel.learner import (
    batch_shardings,
    make_sharded_update,
    place_batch,
    place_state,
)
from relayrl_tpu_torch.parallel.context import current_mesh, use_mesh
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
    "Mesh",
    "data_axes",
    "make_mesh",
    "resolve_mesh_shape",
    "single_device_mesh",
    "batch_shardings",
    "make_sharded_update",
    "place_batch",
    "place_state",
    "current_mesh",
    "use_mesh",
    "make_ring_attention",
    "ring_attention_sharded",
    "make_ring_flash_attention",
    "ring_flash_attention_sharded",
]
