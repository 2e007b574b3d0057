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
shards, one leaf tensor per distinct coordinate of the split axes, on that
coordinate's mesh device (the other axes at 0: a single controller holds
replicas once). Reading the parameter runs :meth:`Shards.forward`, a
``torch.cat`` of the shards moved to the compute device — the all-gather;
autograd's backward of that gather slices the gradient back onto the
shards — the reduce-scatter. Layers that read shards in place (the tp MLP
trunk, the ep MoE layer) take them from :func:`split_blocks`.
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
    """The device at ``coords``, every other axis at 0."""
    return mesh.devices[tuple(coords.get(ax, 0) for ax in AXES)]


def _coords(mesh: Mesh, axes: tuple[str, ...], block: int) -> dict[str, int]:
    """Block ``block`` of a dim split over ``axes`` (first axis outermost)
    -> each axis's coordinate."""
    sizes = [mesh.shape[ax] for ax in axes]
    return dict(zip(axes, np.unravel_index(block, sizes))) if axes else {}


class Shards(nn.Module):
    """A parameter held as shards (see the module docstring).

    ``spec`` is in the torch layout of the tensor; ``fixed`` are mesh
    coordinates every shard shares (a stacked layer's slot on the layer
    axis); ``compute`` is the device the gathered tensor lands on. The
    shards are ordered row-major over the split dims, and ``devices``
    holds each one's device."""

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
        for d, parts in zip(self.dims, self.parts):
            if self.shape[d] % parts:
                raise ValueError(f"dim {d} of {self.shape} does not split in {parts}")
        self.coords = []
        self.devices = []
        for block in itertools.product(*(range(p) for p in self.parts)):
            coords = dict(fixed)
            for d, b in zip(self.dims, block):
                coords.update(_coords(mesh, _axes(self.spec[d]), b))
            self.coords.append(coords)
            self.devices.append(mesh_device(mesh, **coords))

    def split(self, whole: torch.Tensor) -> list[torch.Tensor]:
        """``whole`` -> its shards, each a copy on its device."""
        pieces = [whole]
        for d, parts in zip(self.dims, self.parts):
            pieces = [c for p in pieces for c in p.chunk(parts, dim=d)]
        return [p.to(dev, copy=True).contiguous() for p, dev in zip(pieces, self.devices)]

    def join(self, shards: Sequence[torch.Tensor], device) -> torch.Tensor:
        """Shards (in order) -> the whole tensor on ``device``."""
        return _cat([s.to(device) for s in shards], zip(self.dims, self.parts))

    def forward(self, *shards: torch.Tensor) -> torch.Tensor:
        return self.join(shards, self.compute)

    def right_inverse(self, whole: torch.Tensor) -> list[torch.Tensor]:
        return self.split(whole)

    def blocks(self, shards: Sequence[torch.Tensor],
               axis: str) -> list[tuple[torch.device, torch.Tensor]] | None:
        """The blocks along mesh ``axis`` (a dim split over ``axis`` alone):
        one ``(device, tensor)`` per coordinate, each whole over the other
        split dims and on the device at that coordinate; None when no dim
        splits over ``axis``."""
        if axis not in self.spec:
            return None
        k = self.dims.index(self.spec.index(axis))
        grid = np.arange(len(shards)).reshape(self.parts)
        rest = [(d, p) for j, (d, p) in enumerate(zip(self.dims, self.parts)) if j != k]
        out = []
        for c in range(self.parts[k]):
            dev = mesh_device(self.mesh, **{axis: c})
            out.append((dev, _cat([shards[int(i)].to(dev)
                                   for i in np.take(grid, c, axis=k).reshape(-1)], rest)))
        return out


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


def split_blocks(owner: nn.Module, leaf: str,
                 axis: str) -> list[tuple[torch.device, torch.Tensor]] | None:
    """``owner.<leaf>``'s blocks along ``axis`` as :meth:`Shards.blocks`
    gives them (differentiable: the moves and cats are torch ops), or None
    when the parameter is not split over ``axis``."""
    shards = placement(owner, leaf)
    if shards is None or axis not in shards.spec:
        return None
    return shards.blocks(shard_tensors(owner, leaf), axis)


__all__ = [
    "Shards",
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
    "state_shardings",
]
