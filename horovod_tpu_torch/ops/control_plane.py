"""The collective engine's decisions: cross-rank validation and fusion.

Counterpart of the coordinator half of ``horovod_tpu/ops/control_plane.py``
(``_validate``) and of the engine's planner in
``horovod_tpu/ops/collective.py`` (``_fusion_key``, ``_plan_fusion``), in
plain Python with no I/O. Every rank announces the metadata of its
requests (:class:`Meta`); the :class:`Coordinator` (rank 0's, or the
process's own at world size 1) collects them per name until every rank
has announced it, validates the entry and plans the ready entries into
ordered groups. The engine (``ops/collective.py``) carries the
announcements and the plan between ranks.
"""

from __future__ import annotations

import dataclasses
import math
import time
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import quantization as _quant

ALLREDUCE, ALLGATHER, BROADCAST = 0, 1, 2
OP_NAMES = {ALLREDUCE: "allreduce", ALLGATHER: "allgather",
            BROADCAST: "broadcast"}

# Execution modes the coordinator stamps into every group (the JAX wire's
# Response flags), so that every rank runs a group the same way whatever
# its own environment says.
FLAG_HIERARCHICAL_ALLREDUCE = 1 << 0
FLAG_HIERARCHICAL_ALLGATHER = 1 << 1


_DTYPE_NAMES: Dict[torch.dtype, str] = {}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", "bool")."""
    name = _DTYPE_NAMES.get(dtype)
    if name is None:
        name = _DTYPE_NAMES[dtype] = str(dtype)[6:]
    return name


_ITEMSIZE: Dict[str, int] = {}


def itemsize(name: str) -> int:
    """Bytes per element of the dtype ``name`` (see :func:`dtype_name`)."""
    size = _ITEMSIZE.get(name)
    if size is None:
        size = _ITEMSIZE[name] = getattr(torch, name).itemsize
    return size


def plan_dtype(name: str) -> str:
    """The dtype fusion keys on: bfloat16 plans as float16 and fp8 as
    uint8 (only the item size and same-key grouping matter; a group
    reduces each real dtype on its own)."""
    if name == "bfloat16":
        return "float16"
    if name.startswith("float8"):
        return "uint8"
    return name


def semantics_fingerprint(average: bool, prescale: float, postscale: float,
                          wire: Optional[str] = None) -> int:
    """The execution attributes that must agree across ranks, as one
    number (the JAX engine's ``_semantics_fingerprint`` of an unsharded,
    single-tensor request)."""
    key = f"{int(average)}|{prescale!r}|{postscale!r}|0|1|{wire or ''}"
    return zlib.crc32(key.encode()) & 0x7FFFFFFF


class Meta(NamedTuple):
    """What a rank announces about one request."""

    name: str
    op: int
    dtype: str
    shape: Tuple[int, ...]
    root_rank: int = 0
    average: bool = False
    prescale: float = 1.0
    postscale: float = 1.0
    wire: Optional[str] = None   # encoded blockwise wire ("int8x256")

    @property
    def nbytes(self) -> int:
        """Bytes on the wire: the quantized payload and its scales under a
        wire, else the tensor's own bytes. The planner counts these."""
        if self.wire is not None:
            return _quant.wire_nbytes(self.wire, math.prod(self.shape))
        return itemsize(self.dtype) * math.prod(self.shape)

    @property
    def attrs(self) -> tuple:
        """The execution attributes (see :func:`semantics_fingerprint`)."""
        return (self.average, self.prescale, self.postscale, self.wire)


def fusion_key(op: int, dtype: str, wire: Optional[str], root_rank: int,
               average: bool, prescale: float, postscale: float) -> tuple:
    """Attributes two requests must share to fuse into one group."""
    return (op, plan_dtype(dtype), wire, root_rank, average, prescale,
            postscale)


@dataclasses.dataclass
class Ready:
    """An entry every rank announced, as the planner sees it."""

    name: str
    key: tuple
    nbytes: int
    ragged: bool = False     # an allgather whose first dims differ


def plan_fusion(batch: Sequence[Ready], threshold: int) -> List[List[Ready]]:
    """Single-pass first-fit fusion (the JAX engine's ``_plan_fusion``).

    Requests bucket by fusion key; within a key a request joins the
    first open group it fits (bytes within ``threshold``) or opens a new
    group at its position. This is the reference's greedy look-ahead
    (operations.cc:2149-2265) without its rescans. Groups come out in the
    order of their first member. Ragged allgathers never fuse."""
    groups: List[List[Ready]] = []
    open_groups: Dict[tuple, List[list]] = {}   # key -> [[group, bytes]]
    for item in batch:
        if item.ragged:
            groups.append([item])
            continue
        buckets = open_groups.setdefault(item.key, [])
        for entry in buckets:
            if entry[1] + item.nbytes <= threshold:
                entry[0].append(item)
                entry[1] += item.nbytes
                break
        else:
            group = [item]
            groups.append(group)
            buckets.append([group, item.nbytes])
    return groups


class Entry:
    """One name's announcements, by rank (in the order they came)."""

    __slots__ = ("by_rank", "first", "nbytes", "first_seen")

    def __init__(self):
        self.by_rank: Dict[int, Meta] = {}
        self.first: Optional[Meta] = None     # rank 0's, else the first
        self.nbytes = 0                       # the largest rank's
        self.first_seen = time.monotonic()    # its first announcement

    def add(self, rank: int, m: Meta) -> None:
        self.by_rank[rank] = m
        self.nbytes = max(self.nbytes, m.nbytes)
        if self.first is None or rank == 0:
            self.first = m

    @property
    def op(self) -> int:
        return self.first.op


def validate(name: str, e: Entry) -> str:
    """The cross-rank checks of ConstructMPIResponse
    (operations.cc:321-523), with the JAX coordinator's wording; "" when
    the entry is consistent."""
    metas = list(e.by_rank.values())
    if len(metas) == 1:      # one rank: only a scalar can be wrong
        shape = tuple(e.first.shape)
        if e.op == ALLGATHER and not shape:
            return (f"Mismatched allgather tensor shapes: tensor {name} "
                    "must agree on every dimension except the first "
                    f"across ranks; got {[shape]}")
        return ""
    if len({m.op for m in metas}) > 1:
        ops = sorted({OP_NAMES.get(m.op, str(m.op)) for m in metas})
        return (f"Mismatched collective operations for tensor {name}: "
                f"ranks requested {ops} (operations.cc:354-360)")
    dtypes = {m.dtype for m in metas}
    if len(dtypes) > 1:
        return (f"Mismatched data types for tensor {name}: "
                f"{sorted(dtypes)} (operations.cc:341-352)")
    shapes = [tuple(m.shape) for m in metas]
    op_name = OP_NAMES.get(e.op, str(e.op))
    if e.op in (ALLREDUCE, BROADCAST):
        if any(s != shapes[0] for s in shapes):
            return (f"Mismatched {op_name} tensor shapes: tensor {name} "
                    f"has different shapes on different ranks: "
                    f"{sorted(set(shapes))}")
    if e.op == ALLGATHER:
        rests = {s[1:] for s in shapes}
        if len(rests) > 1 or any(len(s) == 0 for s in shapes):
            return (f"Mismatched allgather tensor shapes: tensor {name} "
                    "must agree on every dimension except the first "
                    f"across ranks; got {sorted(set(shapes))}")
    if e.op == BROADCAST:
        roots = sorted({m.root_rank for m in metas})
        if len(roots) > 1:
            return (f"Mismatched root ranks: One rank specified root "
                    f"rank {roots[0]}, but another rank specified "
                    f"root rank {roots[1]}.")
    attrs = {m.attrs for m in metas}
    if len(attrs) > 1:
        devs = sorted({semantics_fingerprint(*a) for a in attrs})
        return (f"Mismatched execution attributes for tensor {name}: "
                "ranks passed different average/prescale/postscale/"
                f"sharded arguments (fingerprints {devs}).")
    return ""


@dataclasses.dataclass
class Group:
    """One step of the agreed order: names every rank executes together,
    or an error every rank raises for them."""

    op: int
    names: List[str]
    error: str = ""
    # Allgather: each name's first dim on every rank.
    rows: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    flags: int = 0      # FLAG_HIERARCHICAL_*


class Coordinator:
    """Collects announcements per name and, once every rank announced a
    name, validates and plans it. Entries complete in the order their
    names were first announced. ``flags`` go into every group."""

    def __init__(self, size: int, flags: int = 0):
        self.size = size
        self.flags = flags
        self._table: Dict[str, Entry] = {}

    def pending(self) -> int:
        return len(self._table)

    def stalled(self, older_than: float) -> Dict[str, List[int]]:
        """The ranks that have not announced each name announced by the
        others more than ``older_than`` seconds ago (the reference
        coordinator's stall report, operations.cc:1644-1668)."""
        now = time.monotonic()
        return {nm: [r for r in range(self.size) if r not in e.by_rank]
                for nm, e in self._table.items()
                if now - e.first_seen > older_than}

    def cycle(self, announcements: Sequence[Sequence[Meta]],
              threshold: int) -> List[Group]:
        """``announcements[r]``: rank r's new requests this cycle. Returns
        the groups to execute, in order."""
        for rank, metas in enumerate(announcements):
            for m in metas:
                self._table.setdefault(m.name, Entry()).add(rank, m)
        done = [(nm, e) for nm, e in self._table.items()
                if len(e.by_rank) == self.size]
        for nm, _ in done:
            del self._table[nm]
        # Error groups and ragged allgathers stand alone at their position;
        # the rest go through the planner, whose groups keep the position
        # of their first member.
        slots: List = []
        batch: List[Ready] = []
        rows: Dict[str, List[int]] = {}
        for nm, e in done:
            err = validate(nm, e)
            if err:
                slots.append(Group(e.op, [nm], err))
                continue
            m = e.first
            ragged = False
            if m.op == ALLGATHER:
                rows[nm] = [e.by_rank[r].shape[0] for r in range(self.size)]
                ragged = len(set(rows[nm])) > 1
            item = Ready(nm, fusion_key(m.op, m.dtype, m.wire, m.root_rank,
                                        m.average, m.prescale, m.postscale),
                         e.nbytes, ragged)
            batch.append(item)
            slots.append(item)
        first_of = {id(g[0]): g for g in plan_fusion(batch, threshold)}
        groups = []
        for s in slots:
            if isinstance(s, Group):
                groups.append(s)
            elif id(s) in first_of:
                names = [r.name for r in first_of[id(s)]]
                groups.append(Group(s.key[0], names, "",
                                    {n: rows[n] for n in names if n in rows},
                                    self.flags))
        return groups
