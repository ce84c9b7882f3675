"""Leaf->shard layouts: who writes which spans of which leaf.

Counterpart of ``horovod_tpu/checkpoint/layout.py``. A tree is nested
dicts, lists and tuples (a ``state_dict`` tree) whose leaves are
tensors, numpy arrays or Python scalars. Every leaf is addressed by the
key string ``jax.tree_util.keystr`` gives its path, in JAX's flatten
order (:func:`tree_keys`): a dict's keys sorted (an ``OrderedDict``'s in
insertion order), ``['a']`` for a str key and ``[0]`` for an int key or
a list or tuple index, ``.field`` for a named tuple's field, ``None`` an
empty subtree. The shard file names and the manifest number the leaves
in that order, so a tree saved here and the same tree saved by the JAX
engine give the same files.

A leaf's layout is one replicated full-extent shard owned by process 0,
as for a host array in JAX, unless the caller gives one: a leaf sharded
across processes (a ZeRO-1 moment, a tensor-parallel weight) has a
:class:`LeafLayout` built from the port's own sharding
(``parallel.mesh.spec_layout``, ``Zero1Optimizer.checkpoint_layouts``)
with :func:`sharded_layout`. Such a leaf's value in the tree is this
process's block, ``LeafLayout.held``.

Index blocks are half-open per-dimension spans ``((start, stop), ...)``;
:func:`intersect_spans` is the one piece of geometry the resharded
restore needs.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

Span = Tuple[int, int]
Index = Tuple[Span, ...]


@dataclasses.dataclass(frozen=True)
class Shard:
    """One index block of a leaf and the process that writes it."""

    index: Index
    process: int

    @property
    def slices(self) -> Tuple[slice, ...]:
        return tuple(slice(a, b) for a, b in self.index)

    def nelems(self) -> int:
        n = 1
        for a, b in self.index:
            n *= b - a
        return n


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """Global shape/dtype of a leaf plus its deduped shard map.
    ``held`` is the block this process holds of a leaf sharded across
    processes (None for a replicated leaf: the whole of it)."""

    shape: Tuple[int, ...]
    dtype: str
    shards: Tuple[Shard, ...]
    replicated: bool
    held: Optional[Index] = dataclasses.field(default=None, compare=False)

    def shards_of(self, process: int) -> Tuple[Shard, ...]:
        return tuple(s for s in self.shards if s.process == process)


def normalize_index(slices: Sequence[slice], shape: Sequence[int]) -> Index:
    """Half-open per-dim spans from a slice tuple (fills None bounds)."""
    out: List[Span] = []
    for sl, dim in zip(slices, shape):
        start, stop, step = sl.indices(int(dim))
        if step != 1:
            raise ValueError(f"non-unit-stride shard slice {sl!r}")
        out.append((start, stop))
    # 0-d leaves (step counters) get an empty index: one block.
    return tuple(out)


def full_index(shape: Sequence[int]) -> Index:
    return tuple((0, int(d)) for d in shape)


def intersect_spans(a: Index, b: Index) -> Optional[Index]:
    """Per-dim intersection of two blocks; None when they are disjoint."""
    out: List[Span] = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def relative_slices(outer: Index, inner: Index) -> Tuple[slice, ...]:
    """``inner`` re-based into the coordinates of the ``outer`` block."""
    return tuple(slice(i0 - o0, i1 - o0)
                 for (o0, _), (i0, i1) in zip(outer, inner))


def dtype_name(x: Any) -> str:
    """The numpy name of a leaf's dtype (``float32``, ``bfloat16``...)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def leaf_shape(x: Any) -> Tuple[int, ...]:
    return tuple(int(d) for d in (x.shape if isinstance(x, torch.Tensor)
                                  else np.shape(x)))


def leaf_layout(x: Any) -> LeafLayout:
    """A replicated leaf's layout: one full-extent shard of process 0."""
    shape = leaf_shape(x)
    return LeafLayout(shape=shape, dtype=dtype_name(x),
                      shards=(Shard(index=full_index(shape), process=0),),
                      replicated=True)


def sharded_layout(shape: Sequence[int], dtype: str,
                   blocks: Iterable[Tuple[Index, int]],
                   held: Optional[Index] = None) -> LeafLayout:
    """The layout of a leaf split into ``blocks`` of ``(index, process
    holding it)``: replicas of a block dedupe to the lowest process, so
    every block is written exactly once (as JAX dedupes a sharding's
    ``devices_indices_map``). ``held`` is this process's block."""
    owners: Dict[Index, int] = {}
    for index, proc in blocks:
        index = tuple((int(a), int(b)) for a, b in index)
        prev = owners.get(index)
        if prev is None or proc < prev:
            owners[index] = int(proc)
    shards = tuple(Shard(index=idx, process=proc)
                   for idx, proc in sorted(owners.items()))
    return LeafLayout(shape=tuple(int(d) for d in shape), dtype=dtype,
                      shards=shards, replicated=False, held=held)


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """``[(key part, child)]`` of a tree node, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, collections.OrderedDict):
        return [(f"[{k!r}]", v) for k, v in node.items()]
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(type(node), "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def tree_keys(tree: Any) -> Tuple[Tuple[str, Any], ...]:
    """Stable ``(keystr, leaf)`` pairs in JAX's flatten order: the leaf
    addressing scheme shared by layouts, shard file names and the
    manifest."""
    out: List[Tuple[str, Any]] = []

    def walk(node, key):
        kids = _children(node)
        if kids is None:
            out.append((key, node))
            return
        for part, child in kids:
            walk(child, key + part)

    walk(tree, "")
    return tuple(out)


def tree_layout(tree: Any, layouts: Optional[Dict[str, LeafLayout]] = None
                ) -> Dict[str, LeafLayout]:
    """``{leaf keystr: LeafLayout}`` for every leaf of ``tree``, in
    flatten order: ``layouts`` gives those of the sharded leaves, every
    other leaf is replicated."""
    given = dict(layouts or {})
    out = {key: given.pop(key, None) or leaf_layout(leaf)
           for key, leaf in tree_keys(tree)}
    if given:
        raise ValueError(f"layouts for keys the tree does not hold: "
                         f"{sorted(given)[:8]}")
    return out


def process_count(layouts: Dict[str, LeafLayout]) -> int:
    """Number of distinct writing processes a layout set implies."""
    procs = {s.process for ll in layouts.values() for s in ll.shards}
    return max(procs) + 1 if procs else 1


def shard_data(x: Any, shard: Shard, ll: Optional[LeafLayout] = None):
    """Host copy of one shard's block (the device->host snapshot unit):
    a CPU tensor for a tensor leaf, a numpy array otherwise.

    A replicated leaf is sliced to the block; a sharded leaf's value is
    this process's block already (``ll.held``), which must be the
    shard's. Always a real copy, finished when this returns: the next
    optimizer step overwrites parameters and moments in place while the
    writer thread serializes."""
    slices = shard.slices
    if ll is not None and not ll.replicated:
        if ll.held != shard.index:
            raise ValueError(f"this process holds block {ll.held} of the "
                             f"leaf, not the shard {shard.index} it owns")
        if leaf_shape(x) != tuple(b - a for a, b in shard.index):
            raise ValueError(f"a block of shape {leaf_shape(x)} for the "
                             f"shard {shard.index}")
        slices = ()
    if isinstance(x, torch.Tensor):
        block = x.detach()[slices] if slices else x.detach()
        return block.to("cpu", copy=True)
    return np.array(np.asarray(x)[slices], copy=True)
