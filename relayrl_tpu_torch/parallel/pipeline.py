"""Pipeline parallelism: a GPipe microbatch schedule over the ``pp`` mesh
axis, on one controller.

Counterpart of :mod:`relayrl_tpu.parallel.pipeline`. Stage ``s`` owns a
contiguous slice of the layers, placed on ``mesh.axis_devices("pp")[s]``
by :func:`relayrl_tpu_torch.parallel.place_state`; each data group (one
coordinate of dp x fsdp) pipelines its own rows through those stages, cut
into microbatches; at tick ``t`` stage ``s`` runs microbatch ``t - s``::

    tick:     0    1    2    3    4        (M=3 microbatches, S=3 stages)
    stage 0:  m0   m1   m2   -    -
    stage 1:  -    m0   m1   m2   -
    stage 2:  -    -    m0   m1   m2   ->  outputs at ticks S-1 .. S+M-2

Each stage is a generator body driven by
:func:`relayrl_tpu_torch.parallel.ring.run_ring`, whose ``yield`` is the
hand-off to the next stage (``ppermute``): ``tensor.to(next stage's
device)``, a no-op where stages share a device. A multi-process pipeline
can answer the same ``yield`` with a send/receive pair. The last stage's
outputs, gathered to the input's device, are the result.

Bubble ticks do no work (the JAX schedule computes on zeros there and
discards the result, so no number changes), and the single controller runs
the data groups one after another on the stages' devices, which hold the
layers once. So each layer runs once per microbatch per data group: a
forward through L layers is ``L x M x groups`` layer calls. Differentiable:
every step is a torch op, so torch autograd runs the backward through the
schedule, each stage's saved tensors on its own device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from relayrl_tpu_torch.parallel.mesh import Mesh, local_data_groups
from relayrl_tpu_torch.parallel.ring import run_ring


def resolve_microbatches(local_batch: int, n_stages: int,
                         requested: int | None = None) -> int:
    """Pick a microbatch count: the requested value when it divides the
    per-data-shard batch, else the largest divisor of ``local_batch`` not
    exceeding ``max(requested, n_stages)`` (more microbatches shrink the
    pipeline bubble — fraction (S-1)/(M+S-1))."""
    if requested is not None and local_batch % requested == 0:
        return requested
    target = max(requested or 0, n_stages)
    best = 1
    for m in range(1, local_batch + 1):
        if local_batch % m == 0 and m <= target:
            best = m
    return best


def _stage_body(stage: int, n_stages: int, n_micro: int, stage_fn: Callable,
                layers, feed: Sequence[torch.Tensor], device: torch.device):
    """One stage (the generator protocol of :func:`run_ring`): runs
    microbatch ``t - stage`` at tick ``t`` (stage 0 from ``feed``, the
    others from what their predecessor handed on), hands its output to the
    next stage, and returns its outputs (the last stage's are the
    pipeline's)."""
    inbox, outs = (), []
    ticks = n_micro + n_stages - 1
    for t in range(ticks):
        m = t - stage
        out = ()
        if 0 <= m < n_micro:
            h = feed[m].to(device) if stage == 0 else inbox[0]
            out = (stage_fn(layers, h),)
            if stage == n_stages - 1:
                outs.append(out[0])
                out = ()          # no successor: nothing to hand on
        if t < ticks - 1:
            inbox = yield out
    return outs


def pipeline_apply(stage_fn: Callable, stage_params: Sequence, x: torch.Tensor,
                   mesh: Mesh, n_microbatches: int | None = None,
                   axis: str = "pp") -> torch.Tensor:
    """Apply a pipelined layer stack to activations ``x``.

    ``stage_params``: the per-layer params in order (a sequence whose
    length ``pp`` divides); stage ``s`` gets its contiguous slice.
    ``stage_fn(local_params, h) -> h`` applies one stage's layers (a loop
    over its slice). ``x``: global ``[B, ...]`` activations, split over the
    dp x fsdp groups by rows."""
    n_stages = mesh.shape[axis]
    if n_stages <= 1:
        return stage_fn(stage_params, x)
    n_layers = len(stage_params)
    if n_layers % n_stages:
        raise ValueError(
            f"layer stack of {n_layers} layers is not divisible by the pp mesh "
            f"axis ({n_stages} stages); pick n_layers as a multiple of pp")
    per = n_layers // n_stages
    layers = [stage_params[s * per:(s + 1) * per] for s in range(n_stages)]
    devices = mesh.axis_devices(axis)
    n_groups = local_data_groups(mesh)
    if x.shape[0] % n_groups:
        raise ValueError(f"batch of {x.shape[0]} rows does not split into "
                         f"{n_groups} data groups")
    local_b = x.shape[0] // n_groups
    n_micro = resolve_microbatches(local_b, n_stages, n_microbatches)
    out = []
    for rows in x.split(local_b, dim=0):
        feed = rows.split(local_b // n_micro, dim=0)
        bodies = [_stage_body(s, n_stages, n_micro, stage_fn, layers[s], feed,
                              devices[s]) for s in range(n_stages)]
        out += [y.to(x.device) for y in run_ring(bodies, devices)[-1]]
    return torch.cat(out, dim=0)
