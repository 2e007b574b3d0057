"""Fleet telemetry snapshot frames: the magic that marks them.

Counterpart of the frame sniff in :mod:`relayrl_tpu.telemetry.aggregate`.
Fleet aggregation itself is not ported (``ROADMAP.md`` queue 1 item 12);
the JAX package's agents and relays still send ``RLS1`` snapshot frames
on the trajectory plane, so the port's server and relay recognise them
and drop them instead of counting a decode failure.
"""

from __future__ import annotations

SNAP_MAGIC = b"RLS1"


def is_snapshot_frame(payload) -> bool:
    """Cheap magic sniff: the ingest funnels call this on every payload,
    so it is a slice compare."""
    return bytes(payload[:4]) == SNAP_MAGIC


__all__ = ["SNAP_MAGIC", "is_snapshot_frame"]
