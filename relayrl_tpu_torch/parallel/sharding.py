"""Sharding rules: per-leaf specs for a mesh, and the port's sharded tensor.

Counterpart of :mod:`relayrl_tpu.parallel.sharding`, with its rules in its
order. A spec is a tuple with one entry per dimension of a leaf: ``None``
(replicated), a mesh axis name, or a tuple of names (the dimension splits
over their product, the first axis outermost), the form
:func:`relayrl_tpu_torch.parallel.learner.batch_shardings` uses for
batches. The rules read the flax tree path and the flax shape of a leaf
(:func:`logical_leaves`), so both packages shard the same leaf the same
way:

* **pp**   — a leaf of the pipeline family's stacked ``blocks`` subtree
             splits its layer axis over ``pp`` (each stage owns a
             contiguous slice of layers);
* **ep**   — an MoE expert stack (rank >= 3, under ``moe``) splits its
             expert axis over ``ep``; the gate stays replicated;
* **tp**   — MLP trunks alternate column/row parallel: ``dense_{2i}``
             kernels split output features ``(None, "tp")`` (with a fsdp
             split of the input features layered under it when it fits),
             their biases ``("tp",)``; ``dense_{2i+1}`` kernels split input
             features ``("tp", None)``;
* **fsdp** — any other leaf splits its first axis that ``fsdp`` divides.

Where JAX hands these specs to GSPMD, the single-controller port holds the
split itself: :class:`Shards` is the parametrization
(``torch.nn.utils.parametrize``) that :func:`relayrl_tpu_torch.parallel.
learner.place_state` registers on a split parameter. Its originals are the
shards this process holds, one leaf tensor per distinct coordinate of the
split axes, on that coordinate's mesh device (the other axes at this
process's first coordinate: a single controller holds replicas once).
Reading the parameter runs :meth:`Shards.forward`, a ``torch.cat`` of the
shards moved to the compute device — the all-gather; autograd's backward
of that gather slices the gradient back onto the shards — the
reduce-scatter. Where a split axis crosses processes, each process holds
only the shards at its own coordinates, and the gather joins its block
with the other ranks' over the axis's process group
(:class:`~relayrl_tpu_torch.parallel.distributed.AxisGroup`): an
all-gather whose backward reduce-scatters the gradient of the whole back
onto each rank's shards, summed over the group where the axis consumes
batch (fsdp: each rank's gradient is its rows' part), sliced where it
does not (ep, tp: every rank of the group computed the same gradient).
Layers that read shards in place (the tp MLP trunk, the ep MoE layer) take
their blocks from :func:`split_blocks`, this process's blocks along the
axis with the group over which they sum their partial results. A layer of
a pipeline stage is never split: where ``pp`` crosses processes a process
holds its own stages' layers whole and none of the others'
(:class:`Stages`).
"""

from __future__ import annotations

import itertools
import math
import re
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from relayrl_tpu_torch.parallel.mesh import AXES, Mesh, data_axes

Spec = tuple


def batch_pspec(mesh: Mesh) -> Spec:
    """Leading (batch) axis sharded over dp x fsdp; rest replicated."""
    axes = data_axes(mesh)
    return (axes if axes else None,)


def sequence_batch_pspec(mesh: Mesh, ndim: int) -> Spec:
    """Spec for a ``[B, T, ...]`` batch array: batch over dp x fsdp and
    time over ``sp``; rank-1 arrays (per-episode scalars such as
    ``last_val``) shard batch only."""
    b = batch_pspec(mesh)[0]
    if ndim >= 2 and mesh.shape.get("sp", 1) > 1:
        return (b, "sp")
    return (b,)


def replicated(mesh: Mesh) -> Spec:
    """The spec of a leaf every device holds whole (JAX's ``P()``)."""
    del mesh
    return ()


_DENSE_LAYER = re.compile(r"dense_(\d+)$")


def _full(spec: Sequence, ndim: int) -> Spec:
    return tuple(spec) + (None,) * (ndim - len(spec))


def param_pspec(path: Sequence[str], shape: Sequence[int], mesh: Mesh) -> Spec:
    """Spec of one param leaf by its flax tree path and flax shape, one
    entry per dimension."""
    tp = mesh.shape.get("tp", 1)
    fsdp = mesh.shape.get("fsdp", 1)
    pp = mesh.shape.get("pp", 1)
    ep = mesh.shape.get("ep", 1)
    names = [str(n) for n in path]
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)

    # pp first, so neither ep nor fsdp takes the layer axis.
    if pp > 1 and "blocks" in names and ndim >= 1 and shape[0] % pp == 0:
        return _full(("pp",), ndim)
    if ep > 1 and "moe" in names and ndim >= 3 and shape[0] % ep == 0:
        return _full(("ep",), ndim)
    if tp > 1 and ndim == 2:
        for name in names:
            m = _DENSE_LAYER.search(name)
            if m and "kernel" in names:
                layer = int(m.group(1))
                if layer % 2 == 0 and shape[1] % tp == 0:
                    if fsdp > 1 and shape[0] % fsdp == 0:
                        return ("fsdp", "tp")
                    return (None, "tp")
                if layer % 2 == 1 and shape[0] % tp == 0:
                    return ("tp", None)
    if tp > 1 and ndim == 1 and "bias" in names:
        for name in names:
            m = _DENSE_LAYER.search(name)
            if m and int(m.group(1)) % 2 == 0 and shape[0] % tp == 0:
                return ("tp",)
    if fsdp > 1:
        for axis, dim in enumerate(shape):
            if dim % fsdp == 0 and dim >= fsdp:
                return _full((None,) * axis + ("fsdp",), ndim)
    return (None,) * ndim


# -- logical leaves ------------------------------------------------------------

# The pipeline transformer's stacked layer subtree (weights.STACKED_BLOCKS).
_BLOCKS = "blocks"


def _flax_layout(name: str, ndim: int) -> tuple[int, ...]:
    """Flax dim of each torch dim of a leaf named ``name`` (the last flax
    path part): a Dense kernel is transposed, a Conv kernel ``[kh, kw,
    in, out]`` is torch's ``[out, in, kh, kw]``; other leaves keep theirs."""
    if name == "kernel" and ndim == 2:
        return (1, 0)
    if name == "kernel" and ndim == 4:
        return (3, 2, 0, 1)
    return tuple(range(ndim))


def logical_leaves(module: nn.Module) -> dict[tuple[str, ...], dict]:
    """The flax leaves of ``module``'s parameters: path below ``"params"``
    -> ``{"shape": flax shape, "names": torch parameter names, "stacked":
    bool}``. A leaf of the pipeline family's stacked ``blocks`` subtree
    holds one name per layer (``blocks.i...``) and the layer axis leads
    its shape; every other leaf holds one name. Placed modules answer with their logical
    (whole) parameters."""
    from relayrl_tpu_torch.weights import flax_path, logical_shapes

    stacked = isinstance(getattr(module, _BLOCKS, None), nn.ModuleList)
    leaves: dict[tuple[str, ...], dict] = {}
    for name, shape in logical_shapes(module).items():
        path = flax_path(module, name)
        layout = _flax_layout(path[-1], len(shape))
        flax_shape = tuple(shape[d] for d in np.argsort(layout))
        if stacked and path[0] == _BLOCKS:
            path = (path[0], *path[2:])
            leaf = leaves.setdefault(path, {"shape": None, "names": [],
                                            "stacked": True})
            leaf["names"].append(name)
            leaf["shape"] = (len(leaf["names"]), *flax_shape)
        else:
            leaves[path] = {"shape": flax_shape, "names": [name], "stacked": False}
    return leaves


def params_shardings(module: nn.Module, mesh: Mesh) -> dict[str, Spec]:
    """``{"params/<flax path>": spec}`` for every leaf of ``module``."""
    return {"/".join(("params", *path)): param_pspec(path, leaf["shape"], mesh)
            for path, leaf in logical_leaves(module).items()}


def state_shardings(state, mesh: Mesh) -> dict[str, dict[str, Spec]]:
    """The specs of every params module of a train state, by field. The
    optimizers' moments follow their parameters (:func:`relayrl_tpu_torch.
    parallel.learner.place_state` splits them as it splits the
    parameter); scalars such as step counts are replicated."""
    return {name: params_shardings(value, mesh)
            for name, value in vars(state).items() if isinstance(value, nn.Module)}


# -- placement -----------------------------------------------------------------

def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_device(mesh: Mesh, **coords: int) -> torch.device:
    """The device at ``coords``, every other axis at this process's first
    coordinate (0 on a mesh of one process). A coordinate another process
    owns raises: its device is not this process's to use."""
    index = tuple(coords.get(ax, h) for ax, h in zip(AXES, mesh.home))
    device = mesh.devices[index]
    if device is None:
        raise ValueError(f"mesh coordinates {coords} belong to rank "
                         f"{int(mesh.owners[index])}, not to rank {mesh.process_index}")
    return device


def _owner_at(mesh: Mesh, coords: dict) -> int:
    return int(mesh.owners[tuple(coords.get(ax, h) for ax, h in zip(AXES, mesh.home))])


def _coords(mesh: Mesh, axes: tuple[str, ...], block: int) -> dict[str, int]:
    """Block ``block`` of a dim split over ``axes`` (first axis outermost)
    -> each axis's coordinate."""
    sizes = [mesh.shape[ax] for ax in axes]
    return dict(zip(axes, np.unravel_index(block, sizes))) if axes else {}


# A gather over these axes sums its backward over their ranks (they
# consume batch); over any other axis every rank computed the same
# gradient, and the backward takes its slice.
_SUMMED_AXES = ("fsdp",)


class Blocks(list):
    """A split parameter's blocks along one mesh axis that this process
    holds: ``(device, tensor)`` pairs in coordinate order, the first at
    coordinate ``first`` of the axis's ``parts``; ``group`` is the axis's
    :class:`~relayrl_tpu_torch.parallel.distributed.AxisGroup` when it
    crosses processes (the caller sums its partial results over it), else
    None."""

    def __init__(self, items, first: int = 0, parts: int | None = None, group=None):
        super().__init__(items)
        self.first = first
        self.parts = len(self) if parts is None else parts
        self.group = group


class _Gather(torch.autograd.Function):
    """This rank's block of a tensor -> the whole along ``dim``, joined
    with the other ranks' blocks over ``comm`` in its order; the backward
    reduce-scatters the whole's gradient back (``summed``) or takes this
    rank's slice of it."""

    @staticmethod
    def forward(ctx, x, dim, comm, summed):
        ctx.dim, ctx.comm, ctx.summed = dim, comm, summed
        return torch.cat(comm.all_gather(x), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        chunks = list(grad.chunk(ctx.comm.size, dim=ctx.dim))
        if ctx.summed:
            out = ctx.comm.reduce_scatter(chunks)
        else:
            out = chunks[ctx.comm.rank].contiguous()
        return out, None, None, None


class _Gathered(_Gather):
    """A :class:`_Gather` whose forward was taken with others in one
    all-gather (``whole``, a one-element list: the whole tensor, gathered
    without autograd); the backward is this parameter's own, so a
    backward reaches only the parameters its loss depends on."""

    @staticmethod
    def forward(ctx, x, dim, comm, summed, whole):
        ctx.dim, ctx.comm, ctx.summed = dim, comm, summed
        return whole[0]

    @staticmethod
    def backward(ctx, grad):
        return (*_Gather.backward(ctx, grad), None)


def _gather_bucket(comm, members) -> list[torch.Tensor]:
    """``members`` (``(Shards, dim, block)``: each this rank's block of a
    parameter split along ``dim`` over the ranks of ``comm``, one dtype)
    -> each parameter whole, differentiable, from one all-gather."""
    with torch.no_grad():
        parts = comm.all_gather(torch.cat([b.reshape(-1) for _, _, b in members]))
    out, offset = [], 0
    for spec, dim, block in members:
        n = block.numel()
        whole = torch.cat([p[offset:offset + n].view(block.shape) for p in parts], dim=dim)
        out.append(_Gathered.apply(block, dim, comm, spec.spec[dim] in _SUMMED_AXES, [whole]))
        offset += n
    return out


def install_gather_buckets(module: nn.Module) -> None:
    """Gather ``module``'s bucketed parameters (:attr:`Shards.bucketed`)
    whole as each of its forwards starts, one all-gather per group of
    ranks and dtype instead of one per parameter, and drop them when it
    ends (hooks; also on an exception). The backward stays one
    reduce-scatter per parameter: a loss reaches only the parameters it
    depends on. A no-op for a module with none."""
    members = [(owner, leaf, placement(owner, leaf)) for owner in module.modules()
               for leaf in list(getattr(owner, "parametrizations", None) or {})]
    members = [m for m in members if m[2] is not None and m[2].bucketed]
    if not members:
        return

    def gather(_module, _args) -> None:
        buckets: dict = {}
        for owner, leaf, spec in members:
            shards = shard_tensors(owner, leaf)
            home = shards[0].device
            block = _cat([t.to(home) for t in shards], spec._local_parts())
            k = next(k for k, c in enumerate(spec.comms) if c is not None)
            comm = spec.comms[k]
            key = (id(comm.group), comm.rank, comm.size, block.dtype, home)
            buckets.setdefault(key, (comm, []))[1].append((spec, spec.dims[k], block))
        for comm, bucket in buckets.values():
            for (spec, _, _), whole in zip(bucket, _gather_bucket(comm, bucket)):
                spec.gathered = whole.to(spec.compute)

    def drop(_module, _args, _output) -> None:
        for _, _, spec in members:
            spec.gathered = None

    module.register_forward_pre_hook(gather)
    module.register_forward_hook(drop, always_call=True)


class Shards(nn.Module):
    """A parameter held as shards (see the module docstring).

    ``spec`` is in the torch layout of the tensor; ``fixed`` are mesh
    coordinates every shard shares (a stacked layer's slot on the layer
    axis); ``compute`` is the device the gathered tensor lands on. The
    shards are this process's, ordered row-major over the split dims;
    ``devices`` holds each one's device and ``coords`` its mesh
    coordinates. Along a split dim whose axis crosses processes this
    process holds the blocks ``local[k]`` (``[lo, hi)``) of ``parts[k]``
    and gathers the rest over ``comms[k]``."""

    def __init__(self, shape: Sequence[int], spec: Spec, mesh: Mesh,
                 fixed: dict[str, int], compute: torch.device):
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        self.spec = _full(spec, len(self.shape))
        self.compute = compute
        self.mesh = mesh
        self.dims = [d for d, e in enumerate(self.spec) if e is not None]
        self.parts = [math.prod(mesh.shape[a] for a in _axes(self.spec[d]))
                      for d in self.dims]
        self.local, self.comms = [], []
        for d, parts in zip(self.dims, self.parts):
            if self.shape[d] % parts:
                raise ValueError(f"dim {d} of {self.shape} does not split in {parts}")
            axes = _axes(self.spec[d])
            mine = [b for b in range(parts)
                    if _owner_at(mesh, {**fixed, **_coords(mesh, axes, b)})
                    == mesh.process_index]
            lo, hi = mine[0], mine[-1] + 1
            if mine != list(range(lo, hi)) or parts % (hi - lo):
                raise ValueError(f"rank {mesh.process_index} holds blocks {mine} of "
                                 f"{parts} along {axes}: not an equal contiguous block")
            comm = None
            if hi - lo < parts:
                if len(axes) != 1:
                    raise ValueError(f"dim {d} split over {axes} crosses processes: "
                                     "only a dim split over one axis may")
                from relayrl_tpu_torch.parallel.distributed import axis_comm

                comm = axis_comm(mesh, axes[0])
                if comm is None or comm.size != parts // (hi - lo):
                    raise ValueError(f"no process group of {parts // (hi - lo)} "
                                     f"ranks over {axes[0]}")
            self.local.append((lo, hi))
            self.comms.append(comm)
        # The whole tensor while a forward of the placed module runs, when
        # it was gathered in a bucket (install_gather_buckets).
        self.gathered = None
        self.coords = []
        self.devices = []
        for block in itertools.product(*(range(lo, hi) for lo, hi in self.local)):
            coords = dict(fixed)
            for d, b in zip(self.dims, block):
                coords.update(_coords(mesh, _axes(self.spec[d]), b))
            self.coords.append(coords)
            self.devices.append(mesh_device(mesh, **coords))

    @property
    def crosses(self) -> bool:
        """Whether a split axis crosses processes (reading the whole
        tensor is then a collective)."""
        return any(c is not None for c in self.comms)

    @property
    def bucketed(self) -> bool:
        """Whether one dim alone crosses processes, over an axis whose
        gather sums its backward (fsdp): the parameters a forward gathers
        in buckets (:func:`install_gather_buckets`)."""
        crossing = [d for d, c in zip(self.dims, self.comms) if c is not None]
        return len(crossing) == 1 and self.spec[crossing[0]] in _SUMMED_AXES

    @property
    def summed_over_fsdp(self) -> bool:
        """Whether the gather's backward sums the shards' gradients over
        the fsdp ranks (an fsdp split that crosses processes)."""
        return any(c is not None and self.spec[d] in _SUMMED_AXES
                   for d, c in zip(self.dims, self.comms))

    @property
    def split_comms(self) -> tuple:
        """``(axis, AxisGroup)`` of each split dim that crosses processes:
        the ranks over which the shards' squares sum to the whole's."""
        return tuple((self.spec[d], c) for d, c in zip(self.dims, self.comms)
                     if c is not None)

    def split(self, whole: torch.Tensor) -> list[torch.Tensor]:
        """``whole`` -> this process's shards, each a copy on its device."""
        pieces = [whole]
        for d, parts, (lo, hi) in zip(self.dims, self.parts, self.local):
            pieces = [c for p in pieces for c in p.chunk(parts, dim=d)[lo:hi]]
        return [p.to(dev, copy=True).contiguous() for p, dev in zip(pieces, self.devices)]

    def _gather(self, block: torch.Tensor, skip: int | None = None) -> torch.Tensor:
        """This process's block -> whole over every crossing split dim
        (but the ``skip``-th): one differentiable gather each, in dim
        order, so every rank issues them in the same order."""
        for k, (d, comm) in enumerate(zip(self.dims, self.comms)):
            if comm is not None and k != skip:
                block = _Gather.apply(block, d, comm, self.spec[d] in _SUMMED_AXES)
        return block

    def join(self, shards: Sequence[torch.Tensor], device) -> torch.Tensor:
        """This process's shards (in order) -> the whole tensor on
        ``device``; collective where a split crosses processes (gathered on
        the shards' device, then moved)."""
        home = shards[0].device if self.crosses else device
        return self._gather(_cat([s.to(home) for s in shards], self._local_parts())).to(device)

    def _local_parts(self, skip: int | None = None) -> list[tuple[int, int]]:
        return [(d, hi - lo) for k, (d, (lo, hi)) in enumerate(zip(self.dims, self.local))
                if k != skip]

    def forward(self, *shards: torch.Tensor) -> torch.Tensor:
        if self.gathered is not None:
            return self.gathered
        return self.join(shards, self.compute)

    def right_inverse(self, whole: torch.Tensor) -> list[torch.Tensor]:
        return self.split(whole)

    def blocks(self, shards: Sequence[torch.Tensor], axis: str) -> Blocks | None:
        """The blocks along mesh ``axis`` (a dim split over ``axis`` alone)
        that this process holds: one ``(device, tensor)`` per coordinate,
        each whole over the other split dims (gathered where they cross
        processes) and on the device at that coordinate; None when no dim
        splits over ``axis``."""
        if axis not in self.spec:
            return None
        k = self.dims.index(self.spec.index(axis))
        lo, hi = self.local[k]
        grid = np.arange(len(shards)).reshape([h - l for l, h in self.local])
        rest = self._local_parts(skip=k)
        out = []
        for c in range(lo, hi):
            dev = mesh_device(self.mesh, **{axis: c})
            block = _cat([shards[int(i)].to(dev)
                          for i in np.take(grid, c - lo, axis=k).reshape(-1)], rest)
            out.append((dev, self._gather(block, skip=k)))
        return Blocks(out, lo, self.parts[k], self.comms[k])


class Stages:
    """A pipeline module's stages where ``pp`` crosses processes: ``comm``
    is the pp group (:class:`~relayrl_tpu_torch.parallel.distributed.
    AxisGroup`), ``owners`` each stage's member of it, ``stage_of`` each
    stacked parameter's stage by name. This rank holds its own stages'
    layers on their devices; another rank's stage is a ``meta`` tensor of
    the layer's shape and dtype (no bytes), read whole from its owner by
    :meth:`gather`."""

    def __init__(self, comm, owners: Sequence[int], stage_of: dict[str, int]):
        self.comm, self.owners, self.stage_of = comm, list(owners), dict(stage_of)

    def __deepcopy__(self, memo):
        # The pp group is the process's own: a copied module shares it.
        return self

    def mine(self, stage: int) -> bool:
        return self.owners[stage] == self.comm.rank

    def keys(self, keys: Sequence[str], stage: int) -> list[str]:
        """``keys``' entries of ``stage``, in their order."""
        return [k for k in keys if self.stage_of.get(k) == stage]

    def gather(self, keys: Sequence[str], live: dict, device) -> dict[str, torch.Tensor]:
        """Every other rank's stages' entries among ``keys``, whole on
        ``device``: one broadcast of each stage's bytes from its owner, in
        stage order (a collective of the pp group: every member calls it
        with the same keys; counted as gathers on :data:`~relayrl_tpu_torch.
        parallel.distributed.COMM`)."""
        import time

        from relayrl_tpu_torch.parallel.distributed import COMM
        from relayrl_tpu_torch.parallel.ring import _nbytes, _pack, _unpack

        out = {}
        for stage in range(len(self.owners)):
            names = self.keys(keys, stage)
            if not names:
                continue
            like = [live[k] for k in names]
            if self.mine(stage):
                flat = _pack(like).to(device)
            else:
                flat = torch.empty(_nbytes(like), dtype=torch.uint8, device=device)
            t0 = time.perf_counter()
            flat = self.comm.broadcast(flat, self.owners[stage])
            COMM.gathers += 1
            COMM.gather_bytes += flat.numel()
            COMM.gather_seconds += time.perf_counter() - t0
            if not self.mine(stage):
                out.update(zip(names, _unpack(flat, like)))
        return out


def stages(module: nn.Module) -> Stages | None:
    """``module``'s :class:`Stages`, None unless it was placed on a mesh
    whose pp axis crosses processes."""
    return getattr(module, "_pp_stages", None)


def _cat(pieces: list[torch.Tensor], dims_parts) -> torch.Tensor:
    """Row-major pieces of a split over ``(dim, parts)`` pairs -> the
    tensor they tile, innermost split first."""
    for d, parts in reversed(list(dims_parts)):
        pieces = [torch.cat(pieces[i:i + parts], dim=d)
                  for i in range(0, len(pieces), parts)]
    return pieces[0]


def placement(owner: nn.Module, leaf: str) -> Shards | None:
    """The :class:`Shards` of ``owner.<leaf>``, or None when it is a plain
    parameter."""
    if not parametrize.is_parametrized(owner, leaf):
        return None
    param = owner.parametrizations[leaf][0]
    return param if isinstance(param, Shards) else None


def shard_tensors(owner: nn.Module, leaf: str) -> list[torch.Tensor]:
    """The shard leaves of a placed ``owner.<leaf>``, in order."""
    plist = owner.parametrizations[leaf]
    return [getattr(plist, f"original{i}") for i in range(len(placement(owner, leaf).devices))]


def split_blocks(owner: nn.Module, leaf: str, axis: str) -> Blocks | None:
    """``owner.<leaf>``'s blocks along ``axis`` as :meth:`Shards.blocks`
    gives them (differentiable: the moves, cats and gathers are torch ops
    or autograd functions), or None when the parameter is not split over
    ``axis``."""
    shards = placement(owner, leaf)
    if shards is None or axis not in shards.spec:
        return None
    return shards.blocks(shard_tensors(owner, leaf), axis)


__all__ = [
    "Blocks",
    "Shards",
    "Stages",
    "install_gather_buckets",
    "batch_pspec",
    "logical_leaves",
    "mesh_device",
    "param_pspec",
    "params_shardings",
    "placement",
    "replicated",
    "sequence_batch_pspec",
    "shard_tensors",
    "split_blocks",
    "stages",
    "state_shardings",
]
