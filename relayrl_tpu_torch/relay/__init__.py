"""Hierarchical relay tree.

Counterpart of :mod:`relayrl_tpu.relay`. :class:`RelayNode` is one hop: it
subscribes ONCE upstream (training server or parent relay), re-broadcasts
verbatim model frames to its own fan-out plane, and batch-forwards and
spools the subtree's trajectory envelopes upstream, so the root's publish
cost is O(relays), not O(actors).

``python -m relayrl_tpu_torch.relay`` runs one as a process.
"""

from relayrl_tpu_torch.relay.node import RelayNode  # noqa: F401

__all__ = ["RelayNode"]
