"""The collective engine's decisions: cross-rank validation and fusion.

Counterpart of the coordinator half of ``horovod_tpu/ops/control_plane.py``
(``_validate``, ``CoordinatorService``'s skew tracker, wire-epoch
arbiter, stall blame, failure events and adaptation glue) and of the
engine's planner in ``horovod_tpu/ops/collective.py`` (``_fusion_key``,
``_plan_fusion``), in plain Python with no I/O. Every rank announces the
metadata of its requests (:class:`Meta`); the :class:`Coordinator`
(rank 0's, or the process's own at world size 1) collects them per name
until every rank has announced it, validates the entry and plans the
ready entries into ordered groups. The engine (``ops/collective.py``)
carries the announcements, the ranks' alert notes and the plan between
ranks in its negotiation rounds; the plan also carries the failure
events and the params (the wire epochs) that JAX's coordinator ships in
its fetch responses.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import quantization as _quant
from ..observability import registry as _obs
from ..utils import env as _env

_log = logging.getLogger(__name__)

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




class _SkewTracker:
    """Per-rank negotiate-lateness accounting from the coordinator's
    announce ticks (the live half of the cross-rank tracing subsystem,
    docs/tracing.md): the coordinator is the one place that sees WHEN
    each rank announced each tensor, so it can quantify skew without any
    trace files. For every tensor that reaches quorum, each rank's
    lateness is its announce tick minus the first rank's; the per-rank
    distribution goes to ``hvdtpu_negotiate_lateness_seconds{rank=}``
    and an exponentially-decayed accumulator elects the current
    straggler (``hvdtpu_straggler_rank``). The MLPerf pod study (arxiv
    1909.09756) attributes most scaling loss to exactly this skew; this
    makes it a scrapeable number instead of a "ranks N,M not ready"
    log line."""

    # Decay per completed tensor: ~0.99^400 ≈ 0.02, so the straggler
    # election follows the last few hundred collectives (a few training
    # steps), not the whole job history.
    DECAY = 0.99

    def __init__(self, nproc: int):
        self._nproc = nproc
        self._pending: Dict[str, Dict[int, float]] = {}
        r = _obs.registry()
        self._m_lateness = r.histogram(
            "hvdtpu_negotiate_lateness_seconds",
            "Per-rank announce lateness behind the first-announcing rank, "
            "per fully-announced tensor (rank-0 coordinator view)",
            buckets=_obs.LATENCY_BUCKETS)
        self._m_lateness_total = r.counter(
            "hvdtpu_negotiate_lateness_seconds_total",
            "Cumulative announce-lateness seconds by rank")
        # Re-key on (re-)rendezvous: these families are labeled by rank
        # under the CURRENT world size. A new tracker means a new world
        # (elastic shrink/grow, or a reset coordinator in tests) — an
        # evicted rank's per-rank children lingering in the export would
        # keep naming it as the straggler forever, so the rank-keyed
        # series are dropped and rebuilt rather than accumulated across
        # worlds (unlike the world-agnostic totals elsewhere).
        self._m_lateness.clear()
        self._m_lateness_total.clear()
        self._m_straggler = r.gauge(
            "hvdtpu_straggler_rank",
            "Rank with the highest recent negotiate lateness "
            "(exponentially decayed; -1 until any skew is observed)"
        ).labels()
        self._m_straggler_lateness = r.gauge(
            "hvdtpu_straggler_lateness_seconds",
            "Decay-weighted mean negotiate lateness of the current "
            "straggler rank").labels()
        self._m_straggler_lateness.set(0.0)
        self._hist_children = {
            rk: self._m_lateness.labels(rank=str(rk))
            for rk in range(nproc)}
        self._total_children = {
            rk: self._m_lateness_total.labels(rank=str(rk))
            for rk in range(nproc)}
        self._acc = [0.0] * nproc
        self._weight = [0.0] * nproc
        self._m_straggler.set(-1)

    def note(self, rank: int, names, now: float) -> None:
        """Record ``rank``'s announce tick for each tensor name; on
        quorum, fold the per-rank lateness into the metrics."""
        for name in names:
            entry = self._pending.setdefault(name, {})
            if rank in entry:
                continue  # duplicate announce (client retry)
            entry[rank] = now
            if len(entry) < self._nproc:
                continue
            del self._pending[name]
            t0 = min(entry.values())
            for rk, t in entry.items():
                late = t - t0
                self._hist_children[rk].observe(late)
                self._total_children[rk].inc(late)
                self._acc[rk] = self._acc[rk] * self.DECAY + late
                self._weight[rk] = self._weight[rk] * self.DECAY + 1.0
            worst = max(range(self._nproc), key=lambda rk: self._acc[rk])
            if self._acc[worst] > 0.0:
                self._m_straggler.set(worst)
                self._m_straggler_lateness.set(
                    self._acc[worst] / self._weight[worst])

    def recent_lateness_by_rank(self) -> Dict[int, float]:
        """Decay-weighted mean lateness per rank — the quantitative tail
        for the stall warning."""
        return {rk: self._acc[rk] / self._weight[rk]
                for rk in range(self._nproc) if self._weight[rk] > 0.0}

    def prune(self, older_than: float) -> None:
        """Drop partially-announced entries whose newest tick is older
        than ``older_than`` (monotonic seconds): tensors stuck past the
        stall window are the stall detector's story; keeping their ticks
        forever would grow coordinator memory on misbehaving jobs."""
        stale = [n for n, e in self._pending.items()
                 if max(e.values()) < older_than]
        for n in stale:
            del self._pending[n]


class WireEpochArbiter:
    """The one place epochs are stamped (JAX's ``WireEpochArbiter``,
    ``control_plane.py:372``): an epoch ``(from_seq, value)`` declares
    that the groups planned from ``from_seq`` on use ``value``: a wire
    spec ("" raw) or a fusion threshold in bytes. The coordinator stamps
    it at the next group it plans, before planning it, and ships the
    whole lists in every plan, so every rank maps each group's sequence
    to the same value. Two producers propose: the adaptation ladder
    (``"ladder"``) and the global tuner (``"tuner"``), with JAX's
    precedence when both land in one planning gap:

      - a proposal equal to the current value is rejected (``noop``);
      - one producer restamping its pending seq appends (later entries
        win on every rank);
      - the ladder replaces a pending tuner move at the same seq (a
        health reaction outranks an optimization);
      - a tuner move against a pending ladder epoch is rejected.

    The fusion list is independent of the wire list."""

    def __init__(self, mu, next_seq):
        self._mu = mu                # held while reading the seq and appending
        self._next_seq = next_seq    # () -> the next group's sequence
        self.wire_epochs: List[Tuple[int, str]] = []
        self.fusion_epochs: List[Tuple[int, int]] = []
        self._wire_src: List[str] = []
        self._fusion_src: List[str] = []

    def _propose(self, epochs, srcs, source: str, value, initial) -> dict:
        seq = int(self._next_seq())
        current = epochs[-1][1] if epochs else initial
        if value == current:
            return {"accepted": False, "from_seq": seq, "reason": "noop"}
        if epochs and epochs[-1][0] == seq:
            pending = {s for (fs, _), s in zip(epochs, srcs) if fs == seq}
            if source == "tuner" and "ladder" in pending:
                return {"accepted": False, "from_seq": seq,
                        "reason": "conflict_with_ladder"}
            if source == "ladder" and "tuner" in pending:
                # No group at ``seq`` is planned yet, so no rank has seen
                # the tuner's entries: drop them, stamp the ladder's.
                kept = [(e, s) for e, s in zip(epochs, srcs)
                        if not (e[0] == seq and s == "tuner")]
                epochs[:] = [e for e, _ in kept]
                srcs[:] = [s for _, s in kept]
                epochs.append((seq, value))
                srcs.append(source)
                return {"accepted": True, "from_seq": seq,
                        "reason": "replaced_tuner"}
        epochs.append((seq, value))
        srcs.append(source)
        return {"accepted": True, "from_seq": seq, "reason": "ok"}

    def propose_wire(self, source: str, spec: Optional[str]) -> dict:
        with self._mu:
            return self._propose(self.wire_epochs, self._wire_src, source,
                                 spec or "", "")

    def propose_fusion(self, source: str, threshold_bytes: int) -> dict:
        with self._mu:
            return self._propose(self.fusion_epochs, self._fusion_src,
                                 source, int(threshold_bytes), None)


class Coordinator:
    """Collects announcements per name and, once every rank announced a
    name, validates and plans it. Entries complete in the order their
    names were first announced. ``flags`` go into every group.

    Rank 0's coordinator also does what JAX's ``CoordinatorService``
    does beside planning: the skew tracker (each rank's announce
    lateness, from the round each rank's announcement of a name came
    in), the heartbeat (the last round each rank joined), the stall
    report's blame ledger, the failure events past
    ``HOROVOD_TPU_FAILURE_TIMEOUT``, and with
    ``HOROVOD_TPU_ADAPTATION=1`` the adaptation policy, whose knobs
    (the shrunk fusion threshold, the wire epochs keyed on the group
    sequence) reach every rank in the plan's params. The other ranks'
    coordinators (``primary=False``) hold the flags only and register no
    metrics, as JAX's workers host no coordinator service."""

    def __init__(self, size: int, flags: int = 0,
                 stall_warning_s: Optional[float] = None,
                 primary: bool = True):
        self.size = size
        self.flags = flags
        self._table: Dict[str, Entry] = {}
        self._planned_bytes = 0       # since the legacy tuner's last cycle
        self.next_seq = 0             # the sequence of the next group
        self.stall_warning_s = (stall_warning_s if stall_warning_s
                                is not None else _env.stall_warning_secs())
        self.failure_timeout_s = _env.failure_timeout_secs()
        self._last_seen: Dict[int, float] = {}
        self._last_stall_check = time.monotonic()
        self._stall_blame: Dict[int, float] = {}
        self._escalated_stalls: Dict[int, str] = {}
        self._failures_reported: set = set()
        self._arbiter = WireEpochArbiter(threading.Lock(),
                                         lambda: self.next_seq)
        # The global tuner's live cycle time (None until a move lands);
        # its fusion cap is the arbiter's last fusion epoch.
        self._tuner_cycle_ms: Optional[float] = None
        self._pm = None
        self._policy = None
        self._policy_failures: List[dict] = []
        self._skew = _SkewTracker(size) if primary and size > 1 else None
        if not primary:
            return
        r = _obs.registry()
        self._m_stalled_count = r.gauge(
            "hvdtpu_coordinator_stalled_tensors",
            "Tensors announced by only a subset of ranks past the stall "
            "warning window (rank-0 coordinator view)").labels()
        self._m_stalled_info = r.gauge(
            "hvdtpu_coordinator_stalled_tensor_seconds",
            "Per stalled tensor: seconds since first announce, labeled "
            "with the ranks that have not announced it")
        self._m_failures = r.counter(
            "hvdtpu_coordinator_failure_events_total",
            "Escalated worker-failure events, by kind")
        self._m_alert_notes = r.counter(
            "hvdtpu_coordinator_alert_notes_total",
            "Health alerts forwarded by remote ranks as adaptation "
            "ladder inputs, by alert kind (docs/health.md#adaptation)")
        self._m_tuner_moves = r.counter(
            "hvdtpu_autotune_coord_moves_total",
            "Global-autotuner move proposals arbitrated by the "
            "coordinator, by knob and verdict (docs/autotune.md)")
        if _env.adaptation_enabled():
            from ..adaptation.policy import (AdaptationConfig,
                                             AdaptationPolicy)
            self._policy = AdaptationPolicy(
                AdaptationConfig.from_env(),
                allow_evict=self.failure_timeout_s > 0)
            self._last_policy_tick = time.monotonic()
        if _env.autotune_engine():
            from ..autotune.parameter_manager import ParameterManager
            self._pm = ParameterManager(
                _env.fusion_threshold_bytes() / (1 << 20),
                _env.cycle_time_ms(), _env.autotune_log())
            self._base_flags = flags
            self._last_plan_t = time.monotonic()

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

    # ------------------------------------------------------------ rounds

    def announce(self, rank: int, metas: Sequence[Meta],
                 now: Optional[float] = None,
                 sent: Optional[float] = None) -> None:
        """Rank ``rank`` joined a round (its heartbeat) with ``metas``,
        received at ``now``, sent at ``sent`` (on this clock; default
        ``now``): the skew tracker takes each rank's lateness from it."""
        now = time.monotonic() if now is None else now
        self._last_seen[rank] = now
        for m in metas:
            self._table.setdefault(m.name, Entry()).add(rank, m)
        if self._skew is not None and metas:
            self._skew.note(rank, [m.name for m in metas],
                            now if sent is None else sent)

    def threshold(self, base: int) -> int:
        """The fusion threshold the planner cuts with: the legacy tuner's
        point or the global tuner's last fusion epoch in place of
        ``base`` when one is set, divided by the policy's
        ``shrink_factor`` while its ``shrink`` tier is active. Only rank
        0 plans, so this one value cuts every rank's groups."""
        if self._pm is not None:
            base = self._pm.fusion_bytes
        elif self._arbiter.fusion_epochs:
            base = self._arbiter.fusion_epochs[-1][1]
        if self._policy is not None and self._policy.shrink_active():
            return base // self._policy.config.shrink_factor
        return base

    def plan(self, threshold: int) -> List[Group]:
        """Plan every name all ranks have announced; groups are numbered
        from :attr:`next_seq` on, as every rank executes them. With the
        legacy tuner armed, each plan is one of its cycles: the bytes
        planned over the seconds since the last plan."""
        groups = self._plan(self.threshold(threshold))
        self.next_seq += len(groups)
        nbytes, self._planned_bytes = self._planned_bytes, 0
        if self._pm is not None:
            now = time.monotonic()
            if self._pm.update(nbytes, now - self._last_plan_t):
                self.flags = self._base_flags & ~(
                    FLAG_HIERARCHICAL_ALLREDUCE | FLAG_HIERARCHICAL_ALLGATHER
                ) | self._pm.flags()
            self._last_plan_t = now
        return groups

    def _plan(self, threshold: int) -> List[Group]:
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
            self._planned_bytes += e.nbytes
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

    # ------------------------------------------------- stalls and failures

    def check_stalls(self, now: Optional[float] = None
                     ) -> Dict[str, List[int]]:
        """At most once every ``stall_warning_s``: export the stall report
        as the coordinator's gauges and keep the blame ledger, so that a
        rank named missing by stall reports for more than
        ``failure_timeout_s`` becomes a ``stall`` failure event (the
        ``drop_announce`` fault's shape: the rank keeps joining rounds,
        so only the stall report names it). A rank the report no longer
        names is cleared. Returns the report, or {} between checks."""
        now = time.monotonic() if now is None else now
        if (self.stall_warning_s <= 0
                or now - self._last_stall_check < self.stall_warning_s):
            return {}
        self._last_stall_check = now
        if self._skew is not None:
            self._skew.prune(now - 2.0 * self.stall_warning_s)
        report = {nm: [r for r in range(self.size) if r not in e.by_rank]
                  for nm, e in sorted(self._table.items())
                  if now - e.first_seen > self.stall_warning_s}
        if self.failure_timeout_s > 0:
            named = {r for missing in report.values() for r in missing}
            for rk in named:
                first = self._stall_blame.setdefault(rk, now)
                if now - first > self.failure_timeout_s \
                        and rk not in self._escalated_stalls:
                    self._escalated_stalls[rk] = (
                        f"rank {rk} named missing by stall reports for "
                        f"{now - first:.1f}s (> failure timeout "
                        f"{self.failure_timeout_s:.1f}s)")
            for rk in list(self._stall_blame):
                if rk not in named:
                    del self._stall_blame[rk]
        self._m_stalled_info.clear()
        self._m_stalled_count.set(len(report))
        for nm, missing in report.items():
            self._m_stalled_info.labels(
                tensor=nm, missing_ranks=",".join(map(str, missing))).set(
                now - self._table[nm].first_seen)
        return report

    def check_failures(self, now: Optional[float] = None) -> List[dict]:
        """Failure events past ``failure_timeout_s`` (none when it is 0,
        the default): the policy's evictions (kept until the world
        re-forms, so an idle rank still learns of them), the stall
        blame's escalations, ranks that joined a round once and have
        been silent since past the timeout (``heartbeat_timeout``; a rank
        never seen is not flagged: a rendezvous may take longer), and
        names stuck partially announced past it, blamed on their first
        missing rank. Each (rank, kind) is counted once."""
        if self.failure_timeout_s <= 0:
            return []
        now = time.monotonic() if now is None else now
        failures = list(self._policy_failures)
        for rank, detail in sorted(self._escalated_stalls.items()):
            failures.append({"rank": rank, "kind": "stall",
                             "detail": detail})
        for rank, t in sorted(self._last_seen.items()):
            if now - t > self.failure_timeout_s:
                failures.append({
                    "rank": rank, "kind": "heartbeat_timeout",
                    "detail": (f"rank {rank} last joined a negotiation "
                               f"round {now - t:.1f}s ago (failure "
                               f"timeout {self.failure_timeout_s:.1f}s)")})
        for nm, e in sorted(self._table.items()):
            age = now - e.first_seen
            if age > self.failure_timeout_s:
                missing = [r for r in range(self.size) if r not in e.by_rank]
                failures.append({
                    "rank": missing[0] if missing else -1, "kind": "stall",
                    "detail": (f"tensor {nm} waited {age:.1f}s (> failure "
                               f"timeout) for ranks {missing}")})
        for f in failures:
            key = (f["rank"], f["kind"])
            if key not in self._failures_reported:
                self._failures_reported.add(key)
                self._m_failures.labels(kind=f["kind"]).inc()
        return failures

    # ---------------------------------------------------------- adaptation

    def note_alert(self, kind: str, rank: int,
                   now: Optional[float] = None) -> None:
        """A remote rank's health alert, carried in its round: counted,
        and pressure on the policy's ladder when one is armed."""
        self._m_alert_notes.labels(kind=str(kind)).inc()
        if self._policy is not None:
            self._policy.note_alert(kind, int(rank), time.monotonic()
                                    if now is None else now)

    @property
    def wire_epochs(self) -> List[Tuple[int, str]]:
        return self._arbiter.wire_epochs

    def maybe_adapt(self, now: Optional[float] = None) -> None:
        """One policy evaluation (every ``interval_s``), applied as JAX's
        coordinator applies it (``control_plane.py:1006-1051``): the
        planner's threshold (:meth:`threshold`), a wire epoch from the
        next group on when the wire tier changed, and a ``slow_rank``
        failure event at the top of the ladder. Rank 0's own health
        alerts come from the local queue; the others' through
        :meth:`note_alert`."""
        if self._policy is None:
            return
        now = time.monotonic() if now is None else now
        if now - self._last_policy_tick < self._policy.config.interval_s:
            return
        self._last_policy_tick = now
        from ..observability import health as _health
        for a in _health.drain_policy_alerts():
            self._policy.note_alert(a["kind"], a["rank"], now)
        prev_wire = self._policy.wire_spec()
        events = self._policy.observe(
            self._skew.recent_lateness_by_rank()
            if self._skew is not None else {}, now)
        if not events:
            return
        wire = self._policy.wire_spec()
        if wire != prev_wire:
            self._arbiter.propose_wire("ladder", wire)
        for ev in events:
            if ev["name"] == "evict" and ev["action"] == "escalate":
                self._policy_failures.append({
                    "rank": ev["rank"], "kind": "slow_rank",
                    "detail": (
                        f"rank {ev['rank']} evicted by the adaptation "
                        f"policy: negotiate lateness "
                        f"{ev['lateness_s'] * 1e3:.1f} ms sustained above "
                        f"{self._policy.config.threshold_s * 1e3:.1f} ms "
                        "through every degradation tier "
                        f"({', '.join(self._policy.config.tiers[:-1])})")})

    def tuner_move(self, knob: str, value) -> dict:
        """Arbitrate one global-tuner move (JAX's ``_tuner_move``): the
        wire spec and the fusion threshold stamp epochs through the
        arbiter the ladder uses, the cycle time applies live. While the
        legacy tuner is armed it owns the fusion threshold and the cycle
        time, and a move of either is rejected (``legacy_tuner_active``).
        A rejected move (the ladder holds the seq, a no-op, an unknown
        knob) is a verdict, never an error."""
        knob = str(knob)
        if self._pm is not None and knob in ("fusion_threshold_mb",
                                             "cycle_time_ms"):
            res = {"accepted": False, "from_seq": -1,
                   "reason": "legacy_tuner_active"}
        elif knob == "dcn_wire_spec":
            res = self._arbiter.propose_wire("tuner", str(value or ""))
        elif knob == "fusion_threshold_mb":
            # The planner cuts the groups from ``from_seq`` on with it;
            # the ladder's shrink still scales it (threshold()).
            res = self._arbiter.propose_fusion(
                "tuner", int(float(value) * (1 << 20)))
        elif knob == "cycle_time_ms":
            self._tuner_cycle_ms = float(value)
            res = {"accepted": True, "from_seq": -1, "reason": "live"}
        else:
            res = {"accepted": False, "from_seq": -1,
                   "reason": "unknown_knob"}
        self._m_tuner_moves.labels(
            knob=knob, verdict=("accepted" if res["accepted"]
                                else res["reason"])).inc()
        from ..observability import flight_recorder as _flight
        _flight.recorder().note("autotune", (
            "coord_move", knob, str(value), None, None,
            f"{res['reason']} from_seq={res['from_seq']}"))
        return res

    def params(self) -> dict:
        """What every engine needs beside the groups (JAX's
        ``_adapted_params``): the wire epochs, the cycle time every
        rank waits (the global tuner's move or the legacy tuner's
        point) and, with the legacy tuner armed,
        ``autotune_active``/``autotune_done``. Empty while none of them
        exists. The fusion threshold and the hierarchical flags are not
        here: rank 0's planner cuts every rank's groups, and each group
        carries its flags."""
        out = {}
        if self._arbiter.wire_epochs:
            out["wire_epochs"] = [list(e) for e in self._arbiter.wire_epochs]
        if self._pm is not None:
            out.update(self._pm.params())
        if self._tuner_cycle_ms is not None:
            out["cycle_time_ms"] = self._tuner_cycle_ms
        return out
