"""Sharded learner updates on one controller.

Counterpart of :mod:`relayrl_tpu.parallel.learner`. JAX re-jits the
``(state, batch) -> (state, metrics)`` update with in/out shardings and
lets GSPMD insert the collectives; the port runs the same update eagerly,
with the state placed by the rules of :mod:`.sharding` and the mesh
installed as the ambient mesh (:mod:`relayrl_tpu_torch.parallel.context`),
so the layers that split their work read it:

* attention with ``attention="ring"`` cuts its batch over dp x fsdp and its
  time axis over ``sp`` (:mod:`.ring_flash`);
* the pipeline family runs its ``blocks`` as a GPipe schedule over ``pp``
  (:mod:`.pipeline`);
* the MoE layer runs each expert group on the ``ep`` device that holds it;
* an MLP trunk whose ``dense_N`` kernels are split over ``tp`` runs column
  then row parallel.

Placement (:func:`place_state`): every parameter that a rule splits
becomes a :class:`~relayrl_tpu_torch.parallel.sharding.Shards`
parametrization (``torch.nn.utils.parametrize``, chosen so that every
layer keeps reading ``layer.weight`` and autograd carries the gather's
gradient back to the shards), whose originals are the shards, leaf tensors
on their mesh devices; a pipeline stage's layers are plain leaf tensors
moved to the stage's device. The optimizers of the state are rebuilt over
those leaves, each shard's Adam moments split from its parameter's (or
made at the first step on the shard's device), as JAX's
``state_shardings`` places optax's moments. Layers that no rule splits
compute on the mesh's first device, as does every gathered parameter
outside a pipeline stage; there GSPMD would shard them over the mesh, and
they compute the same function.

A placed optimizer's state reads and loads whole
(:func:`whole_optimizer_state`, :func:`load_whole_optimizer_state`), in
the unplaced optimizer's layout, so checkpoints do not depend on the mesh.

On a mesh whose ``dp`` or ``fsdp`` axis spans processes
(:mod:`relayrl_tpu_torch.parallel.distributed`), every process receives
the whole batch (the server broadcasts it), takes the rows of its dp x
fsdp cells (:attr:`Mesh.data_block`, dp outermost), and runs the update
above on its local sub-mesh (:attr:`Mesh.local`) with the data-parallel
group installed beside the ambient mesh
(:func:`~relayrl_tpu_torch.parallel.context.use_dp_group`): every
gradient is summed over the group before its optimizer step and every
batch statistic is a global sum (:mod:`relayrl_tpu_torch.parallel.
context`). dp replicates the state, so the same optimizer steps keep it
bit-equal across the dp ranks. Where ``fsdp``, ``ep`` or ``tp`` crosses
processes, each process holds and steps only the shards at its own
coordinates, with their Adam moments; reading a split parameter whole is
then a collective (a gather over the axis's ranks, :class:`Shards`), and
so are :func:`whole_optimizer_state` and every reader of whole parameters
(the publish, the checkpoint, the guard probes): every rank reaches them
in the same order. A shard's gradient that the fsdp gather's
reduce-scatter summed over the fsdp ranks is summed over the dp ranks
alone. Where ``sp`` spans processes too, the local sub-mesh keeps the
other ranks' shards of the ring: the ring attends this rank's time chunks
and gathers the outputs, so the rest of the model runs replicated on
every rank of a ring, its gradients equal there with no sum (:mod:`.ring`).
Where ``pp`` spans processes, each process places and steps only its own
stages' layers, with their Adam moments: another rank's layer stays a
``meta`` tensor of its shape (no bytes), left out of the optimizers, and
:class:`~relayrl_tpu_torch.parallel.sharding.Stages` reads it whole from
its owner in the rank's pp group (:func:`whole_optimizer_state` its
moments); the pipeline hops activations between the ranks of that group
(:mod:`.pipeline`), and the ends compute on every rank of the pp group,
their gradients equal there with no sum. Beside a crossing fsdp axis
(``{"dp": 1, "fsdp": 2, "pp": 2}`` over 4 ranks) a stage has one holder
per fsdp coordinate and the ends are split over fsdp: each rank holds
its stage and its shards of the ends, the stage's gradients sum over the
data group at its pp coordinate, the ends' reduce-scatter over its fsdp
group (after the hops, :func:`~relayrl_tpu_torch.parallel.context.
dp_gradients`). A crossing ep, tp or sp axis beside it splits no leaf of
the pipeline family: its ranks hold and compute replicas. Where process
blocks straddle the mesh's lines (``{"dp": 3, "sp": 2}`` over 2
processes of 3), each process keeps the rows of every data cell it holds
an entry of, and a cell two processes of one data group share counts on
its lowest holder only (the other computes it with a zero ``valid``
mask, :attr:`~relayrl_tpu_torch.parallel.mesh.Mesh.accountable_cells`);
the data group is then every process.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from relayrl_tpu_torch.parallel.context import use_dp_group, use_mesh
from relayrl_tpu_torch.parallel.mesh import Mesh
from relayrl_tpu_torch.parallel.sharding import (
    Shards,
    Stages,
    _axes,
    _coords,
    _flax_layout,
    batch_pspec,
    install_gather_buckets,
    logical_leaves,
    mesh_device,
    param_pspec,
    sequence_batch_pspec,
    shard_tensors,
)


def make_sharded_update(update_fn: Callable, mesh: Mesh, state_template,
                        donate_state: bool = True,
                        shard_time: bool = False) -> Callable:
    """Run ``update_fn`` over ``mesh``.

    The returned callable expects state already placed (use
    :func:`place_state` once) and takes a host or device batch dict, which
    it checks against the mesh (:func:`batch_shardings`) and places; any
    further arguments pass through to ``update_fn``. The mesh is the
    ambient mesh around each call; ``shard_time=True`` also holds the
    time axis of rank>=2 batch arrays to the ``sp`` split. On a mesh over
    several processes each call takes this process's rows of the (whole)
    batch and runs on the local sub-mesh, the data-parallel group ambient
    when dp or fsdp crosses processes.

    ``state_template`` and ``donate_state`` keep the JAX signature: the
    placement is :func:`place_state`'s, and the torch update moves the
    params in place, so the state is always donated."""
    del state_template, donate_state
    from relayrl_tpu_torch.parallel.distributed import data_parallel_group

    group = data_parallel_group(mesh) if mesh.process_count > 1 else None

    def sharded_update(state, batch, *args):
        batch = place_batch(batch, mesh, shard_time)
        with use_mesh(mesh.local), use_dp_group(group):
            return update_fn(state, batch, *args)

    return sharded_update


def batch_shardings(mesh: Mesh, batch: dict, shard_time: bool = False) -> dict:
    """Per-key split of a batch dict, as tuples of mesh axes per leading
    dim (JAX's PartitionSpecs): batch axis over dp x fsdp, plus
    (``shard_time=True``) the time axis of rank>=2 arrays over ``sp``."""
    if shard_time:
        return {k: sequence_batch_pspec(mesh, v.ndim) for k, v in batch.items()}
    return {k: batch_pspec(mesh) for k in batch}


def _check_splits(mesh: Mesh, batch: dict, specs: dict) -> None:
    for key, spec in specs.items():
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            parts = 1
            for ax in (axes,) if isinstance(axes, str) else axes:
                parts *= mesh.shape[ax]
            if batch[key].shape[dim] % parts:
                raise ValueError(
                    f"batch[{key!r}] dim {dim} of size {batch[key].shape[dim]} "
                    f"does not split over mesh axes {axes} ({parts} parts)")


class _Placed:
    """What became of one parameter: the leaves that hold it now, and how
    a tensor of its shape (a moment) splits onto them and joins back. A
    layer of a pipeline stage where pp crosses processes carries its
    ``stage`` and the module's :class:`Stages`; another rank's stage
    holds no leaf here."""

    def __init__(self, params: list, shards: Shards | None, device,
                 stage: int | None = None, stages: Stages | None = None):
        self.params, self.shards, self.device = params, shards, device
        self.stage, self.stages = stage, stages

    def split(self, t: torch.Tensor) -> list[torch.Tensor]:
        if not self.params:
            return []
        return self.shards.split(t) if self.shards else [t.to(self.device, copy=True)]

    def join(self, pieces, device="cpu") -> torch.Tensor:
        return self.shards.join(pieces, device) if self.shards else pieces[0].to(device)


def place_module(module: nn.Module, mesh: Mesh) -> dict:
    """Place ``module``'s parameters by the rules, in place; returns each
    old parameter's :class:`_Placed`. A stacked ``blocks`` leaf's layer
    axis entry fixes each layer's coordinates (layer ``i`` of ``L`` at
    block ``i // (L / parts)``); its other dims split the layer's tensor.
    A layer placed over ``pp`` computes on its stage's device, every other
    parameter on the first device."""
    from relayrl_tpu_torch.weights import _owner, is_placed

    if is_placed(module):
        raise ValueError("module is already placed on a mesh")
    keys = list(module.state_dict())
    old = dict(module.named_parameters())
    plan = {}
    record = None
    if "pp" in mesh.cross_axes:
        from relayrl_tpu_torch.parallel.distributed import axis_comm

        comm = axis_comm(mesh, "pp")
        record = Stages(comm, [comm.ranks.index(int(r)) for r in mesh.axis_owners("pp")], {})
    for path, leaf in logical_leaves(module).items():
        spec = param_pspec(path, leaf["shape"], mesh)
        names = leaf["names"]
        for i, name in enumerate(names):
            fixed, layer_spec = {}, spec
            if leaf["stacked"]:
                axes0, layer_spec = _axes(spec[0]), spec[1:]
                parts = 1
                for ax in axes0:
                    parts *= mesh.shape[ax]
                fixed = _coords(mesh, axes0, i // (len(names) // parts))
            param = old[name]
            if record is not None and "pp" in fixed:
                stage = int(fixed["pp"])
                record.stage_of[name] = stage
                if not record.mine(stage):
                    # Another rank's stage: its shape and dtype, no bytes.
                    owner, attr = _owner(module, name)
                    setattr(owner, attr, nn.Parameter(torch.empty_like(param, device="meta"),
                                                      requires_grad=param.requires_grad))
                    plan[param] = _Placed([], None, None, stage, record)
                    continue
                with torch.no_grad():
                    param.data = param.data.to(mesh_device(mesh, pp=stage))
                # Read by context.grad_sq_norm: a part of the model.
                param.split_comms = (("pp", record.comm),)
                plan[param] = _Placed([param], None, param.device, stage, record)
                continue
            layout = _flax_layout(path[-1], param.ndim)
            torch_spec = tuple(layer_spec[layout[d]] for d in range(param.ndim))
            compute = (mesh_device(mesh, pp=int(fixed["pp"])) if "pp" in fixed
                       else mesh_device(mesh))
            home = mesh_device(mesh, **fixed)
            if all(e is None for e in torch_spec) and home == compute:
                with torch.no_grad():
                    param.data = param.data.to(home)
                plan[param] = _Placed([param], None, home)
                continue
            owner, attr = _owner(module, name)
            shards = Shards(param.shape, torch_spec, mesh, fixed, compute)
            parametrize.register_parametrization(owner, attr, shards)
            leaves = shard_tensors(owner, attr)
            split = shards.split_comms
            for t in leaves:
                if shards.summed_over_fsdp:
                    # Read by context.dp_gradients: summed over dp alone.
                    t.summed_over_fsdp = True
                if split:
                    # Read by context.grad_sq_norm: a part of the model.
                    t.split_comms = split
            plan[param] = _Placed(leaves, shards, home)
    module._logical_keys = keys
    if record is not None:
        module._pp_stages = record
    install_gather_buckets(module)
    return plan


def _rebuild_optimizer(opt: torch.optim.Optimizer, plan: dict) -> torch.optim.Optimizer:
    """``opt`` over the placed leaves, its per-parameter state split as
    the parameters were; records the plan for the whole form."""
    groups, layout = [], []
    for group in opt.param_groups:
        placed = [plan.get(p) or _Placed([p], None, p.device) for p in group["params"]]
        groups.append({**{k: v for k, v in group.items() if k != "params"},
                       "params": [q for pl in placed for q in pl.params]})
        layout.append(placed)
    new = type(opt)(groups, **opt.defaults)
    for group, placed in zip(opt.param_groups, layout):
        for p, pl in zip(group["params"], placed):
            for key, value in opt.state.get(p, {}).items():
                if torch.is_tensor(value) and value.ndim and value.shape == p.shape:
                    pieces = pl.split(value)
                else:
                    pieces = [value.clone() if torch.is_tensor(value) else value
                              for _ in pl.params]
                for q, piece in zip(pl.params, pieces):
                    new.state[q][key] = piece
    new._shard_layout = layout
    return new


def place_state(state, mesh: Mesh):
    """Place a train state on ``mesh``, in place: every ``nn.Module`` field
    by :func:`place_module`, every optimizer field rebuilt over the placed
    leaves with its moments split (an optimizer that has not stepped gets
    its moments at its first step, on each shard's device). On a mesh over
    several processes the state goes on this process's devices of its
    sub-mesh. Returns the state."""
    mesh = mesh.local
    plan = {}
    fields = vars(state)
    for value in fields.values():
        if isinstance(value, nn.Module):
            plan.update(place_module(value, mesh))
    for name, value in fields.items():
        if isinstance(value, torch.optim.Optimizer):
            setattr(state, name, _rebuild_optimizer(value, plan))
    return state


def place_batch(batch: dict, mesh: Mesh, shard_time: bool = False) -> dict:
    """Host batch -> tensors on the mesh's first device, after checking
    that each array splits over the mesh as :func:`batch_shardings` says.
    ``shard_time`` must match the :func:`make_sharded_update` flag. On a
    mesh over several processes ``batch`` is the whole batch and this
    process keeps the rows (dim 0) of its dp x fsdp cells
    (:attr:`Mesh.data_block`): all of them when neither dp nor fsdp
    crosses processes. The rows of a cell that another process of its
    data group accounts for (where process blocks straddle the mesh's
    lines) keep a zero ``valid`` mask (:func:`_account`)."""
    _check_splits(mesh, batch, batch_shardings(mesh, batch, shard_time))
    if mesh.process_count > 1:
        rows = {len(v) for v in batch.values()}
        if len(rows) != 1:
            raise ValueError(f"batch arrays disagree on their rows: {sorted(rows)}")
        per = rows.pop() // (mesh.shape["dp"] * mesh.shape["fsdp"])
        start, stop = mesh.data_block
        batch = _account({k: v[start * per:stop * per] for k, v in batch.items()},
                         mesh, start, per)
    return {k: torch.as_tensor(v, device=mesh.first_device)
            for k, v in batch.items()}


def _account(batch: dict, mesh: Mesh, start: int, per: int) -> dict:
    """This process's rows (its cells from ``start``, ``per`` rows a cell)
    with the ``valid`` mask zeroed on the cells it holds but does not
    account for (:attr:`Mesh.accountable_cells`): it computes them, as
    another process's partner on their lines, but their losses and
    statistics count on that process. An update that reads no ``valid``
    mask cannot hold a cell two processes share."""
    others = sorted(set(mesh.cells) - set(mesh.accountable_cells))
    if not others:
        return batch
    if "valid" not in batch:
        raise ValueError(f"mesh {mesh.shape}: rank {mesh.process_index} shares data cells "
                         f"{others} with another process, and a batch without a 'valid' "
                         "mask cannot count their rows once")
    valid = batch["valid"]
    valid = valid.clone() if torch.is_tensor(valid) else np.array(valid, copy=True)
    for cell in others:
        valid[(cell - start) * per:(cell - start + 1) * per] = 0
    return {**batch, "valid": valid}


def _is_moment(value) -> bool:
    return torch.is_tensor(value) and value.ndim > 0


def whole_optimizer_state(opt: torch.optim.Optimizer) -> dict:
    """``opt.state_dict()`` in the unplaced optimizer's layout: one entry
    per logical parameter, its moments joined on the CPU (gathered from
    every rank where a split crosses processes, and a pipeline stage's
    from its owner where pp does: a collective then)."""
    layout = getattr(opt, "_shard_layout", None)
    sd = opt.state_dict()
    if layout is None:
        return sd
    state, groups, k, i = {}, [], 0, 0
    for group, placed in zip(sd["param_groups"], layout):
        logical = []
        for pl in placed:
            parts = [sd["state"][j] for j in range(k, k + len(pl.params))
                     if j in sd["state"]]
            k += len(pl.params)
            if parts:
                state[i] = {key: pl.join([p[key] for p in parts]) if _is_moment(v) else v
                            for key, v in parts[0].items()}
            logical.append(i)
            i += 1
        groups.append({**group, "params": logical})
    placed = [pl for group in layout for pl in group]
    record = next((pl.stages for pl in placed if pl.stages is not None), None)
    if record is not None:
        # Each stage's moments from its owner, in stage order.
        for stage in range(len(record.owners)):
            ids = [j for j, pl in enumerate(placed) if pl.stage == stage]
            if ids:
                mine = ({j: state[j] for j in ids if j in state}
                        if record.mine(stage) else None)
                state.update(record.comm.broadcast_object(mine, record.owners[stage]))
        state = dict(sorted(state.items()))
    return {"state": state, "param_groups": groups}


def load_whole_optimizer_state(opt: torch.optim.Optimizer, saved: dict) -> None:
    """Load :func:`whole_optimizer_state`'s form into ``opt``, splitting
    each moment onto the shards (this process's, where a split crosses
    processes; only this process's pipeline stages', where pp does)."""
    layout = getattr(opt, "_shard_layout", None)
    if layout is None:
        opt.load_state_dict(saved)
        return
    state, groups, k, i = {}, [], 0, 0
    for group, placed in zip(saved["param_groups"], layout):
        if len(group["params"]) != len(placed):
            raise ValueError("optimizer state does not match the placed optimizer")
        shard_ids = []
        for pl in placed:
            ids = list(range(k, k + len(pl.params)))
            k += len(pl.params)
            shard_ids += ids
            if i in saved["state"]:
                entry = saved["state"][i]
                split = {key: pl.split(v) if _is_moment(v) else None
                         for key, v in entry.items()}
                for n, j in enumerate(ids):
                    state[j] = {key: split[key][n] if split[key] is not None
                                else v.clone() if torch.is_tensor(v) else v
                                for key, v in entry.items()}
            i += 1
        groups.append({**group, "params": shard_ids})
    opt.load_state_dict({"state": state, "param_groups": groups})
