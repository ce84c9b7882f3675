"""Multi-axis meshes over ``torch.distributed.device_mesh``.

Counterpart of ``horovod_tpu/parallel/mesh.py``. Each parallelism
strategy binds to a named axis ('dp' data, 'fsdp', 'tp', 'pp', 'sp',
'ep'); ``create_mesh`` lays the ranks out row-major over the axes, so
leading axes step across nodes and trailing axes stay inside one.

One process drives one device, so a mesh's entries are ranks. An axis
is ``"dcn"`` (it crosses nodes) when stepping along it changes a rank's
node, ``rank // local_size``, and ``"ici"`` (it stays on the node's
interconnect) otherwise. ``HOROVOD_TPU_DCN_AXES`` (comma-separated axis
names) forces axes to ``"dcn"``.

Creating a mesh creates its process groups: every rank calls
``create_mesh`` with the same arguments.

A partition spec is a tuple with one entry per dimension of a tensor:
None (not split), an axis name, or a tuple of axis names (split over
their product, the first the slowest), as JAX's ``PartitionSpec``;
``()`` replicates. :func:`shard_tensor` and :func:`shard_tree` cut a
global tensor or tree into the shard that a mesh coordinate holds, as
``NamedSharding`` places it.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis-name → size spec. size -1 means "absorb remaining devices"."""

    axes: Tuple[Tuple[str, int], ...]

    @classmethod
    def of(cls, **sizes: int) -> "MeshSpec":
        return cls(tuple(sizes.items()))

    def resolve(self, n_devices: int) -> Dict[str, int]:
        fixed = math.prod(s for _, s in self.axes if s > 0)
        wild = [a for a, s in self.axes if s <= 0]
        if len(wild) > 1:
            raise ValueError("at most one axis may have size -1")
        out = dict(self.axes)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"{fixed}")
            out[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh axes {dict(self.axes)} multiply to {fixed}, but "
                f"{n_devices} devices are available")
        return out


def axis_kinds(mesh: DeviceMesh,
               local_size: Optional[int] = None) -> Dict[str, str]:
    """``{axis: "ici" | "dcn"}`` for every axis of ``mesh``.
    ``local_size`` (ranks per node) defaults to the topology's."""
    if local_size is None:
        from .. import topology as _topo
        local_size = _topo.local_size()
    forced = {a.strip()
              for a in os.environ.get("HOROVOD_TPU_DCN_AXES", "").split(",")
              if a.strip()}
    nodes = mesh.mesh // local_size
    kinds: Dict[str, str] = {}
    for k, name in enumerate(mesh.mesh_dim_names):
        crosses = bool((torch.roll(nodes, -1, dims=k) != nodes).any())
        kinds[name] = "dcn" if name in forced or crosses else "ici"
    return kinds


def dcn_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Mesh axes that cross nodes (see :func:`axis_kinds`)."""
    return tuple(a for a, k in axis_kinds(mesh).items() if k == "dcn")


def ici_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Mesh axes that stay inside a node."""
    return tuple(a for a, k in axis_kinds(mesh).items() if k == "ici")


def create_mesh(spec: Optional[MeshSpec] = None,
                **axis_sizes: int) -> DeviceMesh:
    """A named mesh over every rank, on the topology's device type.

    ``create_mesh(dp=-1)`` — flat data parallel.
    ``create_mesh(dp=2, tp=2, sp=2)`` — 3-axis hybrid on 8 ranks.
    """
    from .. import topology as _topo
    if spec is None:
        spec = MeshSpec.of(**(axis_sizes or {"dp": -1}))
    sizes = spec.resolve(_topo.size())
    return init_device_mesh(_topo.device().type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes.keys()))


Spec = Tuple[Any, ...]


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The axis names a partition spec splits over, in order."""
    out = []
    for entry in spec:
        if entry is None:
            continue
        out.extend((entry,) if isinstance(entry, str) else entry)
    return tuple(out)


def place(mesh: DeviceMesh) -> Tuple[Dict[str, int], Dict[str, int]]:
    """``(sizes, coords)``: every axis's size and this rank's coordinate
    along it."""
    names = mesh.mesh_dim_names
    return ({a: mesh.size(k) for k, a in enumerate(names)},
            {a: mesh.get_local_rank(a) for a in names})


def shard_tensor(x: torch.Tensor, spec: Spec, sizes: Dict[str, int],
                 coords: Dict[str, int]) -> torch.Tensor:
    """The block of global ``x`` that the mesh coordinate ``coords``
    holds under ``spec``, as a contiguous copy."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes[a], i * sizes[a] + coords[a]
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does "
                             f"not split over {axes} of size {n}")
        x = x.chunk(n, dim=dim)[i]
    return x.contiguous().clone()


def shard_tree(tree, specs, sizes: Dict[str, int],
               coords: Dict[str, int]):
    """:func:`shard_tensor` leaf by leaf over matching dict/list trees."""
    if isinstance(tree, dict):
        return {k: shard_tree(tree[k], specs[k], sizes, coords)
                for k in tree}
    if isinstance(tree, list):
        return [shard_tree(t, s, sizes, coords)
                for t, s in zip(tree, specs)]
    return shard_tensor(tree, specs, sizes, coords)


def spec_of(specs, name: str) -> Spec:
    """The spec of the parameter ``name`` (dotted, as in a state_dict:
    ``layers.1.moe.wi``) in a spec tree of dicts and lists."""
    node = specs
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def spec_layout(shape, dtype: str, spec: Spec, mesh: DeviceMesh):
    """The checkpoint layout of a leaf of global ``shape`` split by
    ``spec`` over ``mesh`` (``checkpoint.LeafLayout``): one shard per
    distinct block, written by the lowest rank holding it, and ``held``
    this rank's block, as JAX derives a layout from a ``NamedSharding``.
    A spec that splits nothing (or only over axes of size 1) gives the
    replicated layout of process 0."""
    from ..checkpoint.layout import (LeafLayout, Shard, full_index,
                                     sharded_layout)
    shape = tuple(int(d) for d in shape)
    names = mesh.mesh_dim_names
    grid = mesh.mesh.cpu().numpy()
    sizes = dict(zip(names, grid.shape))
    dims = [spec_axes((entry,)) for entry in spec]
    dims += [()] * (len(shape) - len(dims))
    factors = [math.prod(sizes[a] for a in axes) for axes in dims]
    if math.prod(factors) == 1:
        return LeafLayout(shape=shape, dtype=dtype,
                          shards=(Shard(full_index(shape), 0),),
                          replicated=True)
    me = dist.get_rank()
    blocks, held = [], None
    for coord in np.ndindex(*grid.shape):
        at = dict(zip(names, coord))
        index = []
        for d, axes in enumerate(dims):
            k = 0
            for a in axes:
                k = k * sizes[a] + at[a]
            w = shape[d] // factors[d]
            index.append((k * w, (k + 1) * w))
        rank = int(grid[coord])
        blocks.append((tuple(index), rank))
        if rank == me:
            held = tuple(index)
    return sharded_layout(shape, dtype, blocks, held)
