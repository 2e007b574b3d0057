"""Frozen-layer masks (``learner.freeze``).

Counterpart of :mod:`relayrl_tpu.algorithms.freeze`. ``learner.freeze`` is
a regex (or list of regexes) matched against "/"-joined parameter leaf
paths of the flax tree, e.g. ``params/block_0/qkv/kernel``; the port names
each torch parameter by that path (:func:`relayrl_tpu_torch.weights.
flax_path`: a Linear ``weight`` is a ``kernel``, a LayerNorm ``weight`` a
``scale``), so one pattern freezes the same leaves in both packages.
Matching parameters are left out of every optimizer, so they stay
bit-identical across updates.
"""

from __future__ import annotations

import re
from typing import Any, Sequence

from torch import nn

from relayrl_tpu_torch.weights import STACKED_BLOCKS, flax_path


def normalize_freeze_spec(spec) -> tuple[str, ...]:
    """Config value -> tuple of regex source strings. Accepts None/""
    (no freezing), one string, or a list of strings; anything that does
    not compile is rejected here, so a typo'd pattern fails the config
    read, not the Nth training step."""
    if spec is None or spec == "" or spec == []:
        return ()
    patterns = [spec] if isinstance(spec, str) else list(spec)
    out = []
    for p in patterns:
        if not isinstance(p, str) or not p:
            raise ValueError(
                f"learner.freeze entries must be non-empty regex strings; "
                f"got {p!r}")
        try:
            re.compile(p)
        except re.error as e:
            raise ValueError(
                f"learner.freeze pattern {p!r} is not a valid regex: {e}"
            ) from e
        out.append(p)
    return tuple(out)


def leaf_paths(module: nn.Module) -> dict[str, str]:
    """Parameter name -> its flax leaf path (``"params/..."``). The
    pipeline family's per-layer ``blocks.i`` parameters share the path of
    the stacked flax leaf they are a slice of (``params/blocks/qkv/...``),
    so a pattern freezes every layer of a stacked leaf, as in the JAX
    package."""
    stacked = isinstance(getattr(module, STACKED_BLOCKS, None), nn.ModuleList)
    out = {}
    for name, _ in module.named_parameters():
        parts = flax_path(module, name)
        if stacked and parts[0] == STACKED_BLOCKS:
            parts = (parts[0], *parts[2:])
        out[name] = "/".join(("params", *parts))
    return out


def frozen_names(module: nn.Module, patterns: Sequence[str]) -> set[str]:
    """Names of the parameters whose leaf path matches any pattern."""
    compiled = [re.compile(p) for p in patterns]
    return {name for name, path in leaf_paths(module).items()
            if any(c.search(path) for c in compiled)}


def freeze_info(module: nn.Module, patterns: Sequence[str]) -> dict[str, Any]:
    """Accounting for checkpoints and telemetry, equal to the JAX
    function's on the same weights: the patterns, how many leaves and
    bytes they froze, and the frozen paths (sorted)."""
    paths = leaf_paths(module)
    frozen = frozen_names(module, patterns)
    params = dict(module.named_parameters())
    frozen_paths = sorted({paths[n] for n in frozen})
    return {
        "patterns": list(patterns),
        "frozen_leaves": len(frozen_paths),
        "total_leaves": len(set(paths.values())),
        "frozen_bytes": int(sum(params[n].numel() * params[n].element_size()
                                for n in frozen)),
        "frozen_paths": frozen_paths,
    }
