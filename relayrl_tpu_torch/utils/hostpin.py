"""Process-level CPU pinning for actor hosts and examples.

The JAX package's ``pin_cpu`` forces its process onto the CPU backend. The
port's meaning is "this process uses no card": it hides every card from
CUDA before torch initialises it. Entry points never call it on their own;
a caller that wants a CPU-only worker does, first thing.
"""

from __future__ import annotations

import os
import sys


def pin_cpu(virtual_devices: int | None = None) -> None:
    """Hide every card from this process (``CUDA_VISIBLE_DEVICES=""``).

    Raises ``RuntimeError`` if torch has already initialised CUDA here: the
    variable is read once, at initialisation, so setting it later would
    silently pin nothing. ``virtual_devices`` is accepted for signature
    parity with the JAX package and unused: the port builds CPU meshes
    from device lists (``parallel.make_mesh(shape, [cpu] * n)``), so no
    host-platform device count is needed.
    """
    del virtual_devices
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError(
            "pin_cpu() after CUDA was initialised in this process: call it "
            "before the first CUDA use")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
