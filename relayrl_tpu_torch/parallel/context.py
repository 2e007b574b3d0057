"""Ambient mesh context.

Counterpart of :mod:`relayrl_tpu.parallel.context`. Model arch configs are
JSON-able data (the transportable model ABI — models/base.py), so they
cannot carry a live :class:`~relayrl_tpu_torch.parallel.mesh.Mesh`.
Components that need one when they run (ring attention in the transformer
policy) read it from this context, which the learner sets around each
update::

    with use_mesh(mesh):
        state, metrics = update(state, batch)

Single-device paths (actors) simply never set a mesh and the sequence
models fall back to their local attention implementation.
"""

from __future__ import annotations

import contextlib
import threading

from relayrl_tpu_torch.parallel.mesh import Mesh

_state = threading.local()


def current_mesh() -> Mesh | None:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev
