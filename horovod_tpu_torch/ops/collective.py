"""Eager collectives through the negotiated collective engine.

Counterpart of ``horovod_tpu/ops/collective.py``: ``allreduce[_async]``
(with ``average``, pre/post scaling and ``compression``),
``grouped_allreduce``, ``allgather[_async]``, ``broadcast[_async]``,
``poll``, ``synchronize`` and ``Handle``, and the in-place forms of the
torch shim (``allreduce_[async_]``, ``broadcast_[async_]``,
``synchronize_many``, ``horovod_tpu/torch/mpi_ops.py``). An op returns a
new tensor and leaves its input untouched; an in-place op's result is
its input, which the engine overwrites. Names must be unique among
in-flight ops, as in Horovod.

A blockwise compressor (``Compression.int8_blockwise``/``fp8_blockwise``)
sets a floating tensor's request's wire: the planner fuses only
requests of one wire and counts their wire bytes, and the executor runs
the dual block-quantized allreduce (``quantization.py``) over
``all_to_all_single`` and ``all_gather``. A cast compressor transforms
the tensor before the request (``allreduce``).

One :class:`CollectiveEngine` per process runs a background thread,
Horovod's ``RunLoopOnce``. An op is queued, not issued. Each cycle
(``HOROVOD_CYCLE_TIME``, cut short by a blocking ``Handle.wait``) the
thread takes the queue and negotiates: every rank sends the metadata of
its new requests to rank 0 over a gloo control group (at world size 1
the process is rank 0 and sends nothing); rank 0 holds each name until
every rank has announced it, validates it (a ``Mismatched ...`` error
for every rank otherwise) and plans the ready names into fused groups
(``ops/control_plane.py``); it broadcasts the ordered groups, and every
rank executes them in that order on the default group (NCCL on the
card, gloo on the CPU). A rank's ``shutdown`` rides the same
announcement: every rank then fails its pending ops and stops.

Rank 0 also tells every rank whether the world is idle: no name is
waiting for a rank's announcement. An idle rank skips the cycles until
it has new work, a stop or, at the latest, ``IDLE_CYCLE_S`` later, so an
idle world runs a round every ``IDLE_CYCLE_S``, not every cycle. A rank
with new work enters the round at once and waits there for the others:
they announce the same names as soon as they submit them, and a name
some ranks announced keeps every rank at the normal cycle until it runs.

Only the engine thread issues collectives, in the agreed order. On
CUDA it works on a stream of its own: it waits on an event recorded on
the submitter's stream at enqueue (for a gradient hook, the backward's
stream on autograd's thread), copies in-place results home on that
stream, and ``Handle.wait`` makes the caller's stream wait on the event
recorded after the group.

On gloo at world size > 1 a sum gathers every rank's buffer and adds
them in rank order, as XLA's CPU all-reduce does (gloo's ring adds each
chunk in another order, so its float sums depend on the tensor's size);
NCCL sums with ``all_reduce``.

Rank 0's coordinator stamps its ``HOROVOD_HIERARCHICAL_ALLREDUCE`` and
``_ALLGATHER`` into every group, and every rank runs the group so: the
sum within each node's ``ici`` ranks, across nodes, and back
(``executor.hier_reduce``), the gather within the node and then across
(``executor.hier_gather``), on the groups of
``topology.hierarchical_mesh()`` (ranks per node from
``LOCAL_WORLD_SIZE``). On gloo each stage adds in rank order, as XLA's
``psum_scatter('ici')`` and ``psum('dcn')`` do; on NCCL the stages are
``reduce_scatter_tensor``, ``all_reduce`` and ``all_gather_into_tensor``.

The stall inspector (``HOROVOD_STALL_WARNING``, 60 s) warns about ops
in flight past the warning time, each with its op and age and, at more
than one rank, the ranks that have not announced it, from rank 0's
coordinator (shipped in the plan); past ``HOROVOD_TPU_FAILURE_TIMEOUT``
(0, the default, disables it) it fails them with a typed
``elastic.WorkerFailure``. ``HOROVOD_TIMELINE`` writes a Chrome
trace (``ops/timeline_py.py``): a ``NEGOTIATE_<OP>`` span per op from its
enqueue to the plan's arrival, then the op's activity span
(``NCCL_ALLREDUCE``, ``GLOO_ALLGATHER``, ...) over its group's execution,
and with ``HOROVOD_TIMELINE_MARK_CYCLES`` a ``CYCLE_START`` per cycle.

A round's messages are point to point on the control group: each rank
sends rank 0 its announcements (and the health alerts it forwards to
the adaptation policy), rank 0 sends each rank the plan. So rank 0 can
wait for a rank with a deadline: past ``HOROVOD_TPU_FAILURE_TIMEOUT``
since the rank's last round, the rank is lost and the plan carries a
``heartbeat_timeout`` event (JAX's coordinator: a rank whose fetches
stopped). Beside the groups the plan carries rank 0's failure events,
which every rank raises on its pending handles as a typed
``elastic.WorkerFailure`` (a policy eviction as ``SlowRankFailure``),
skipping that round's groups, and the params: the policy's wire epochs
``[(from_seq, spec)]``, by which every rank moves the eligible fused
allreduces of group ``seq`` on the same wire (``bf16`` a cast, the
blockwise specs the quantized wire).

The engine's metric families are JAX's (``_EngineMetrics``): the op
phases negotiate (enqueue to the plan's arrival), queue (arrival to the
group's dispatch) and execute (the group's wall time; on CUDA its
seconds on the card, between events recorded around it on the engine's
stream, read once the card has passed them: ``collect_timings``), ops, wire bytes by spec, fused group sizes and
bytes, cycles and their busy and idle seconds, stalled tensors, and
groups run under a policy wire. The flight recorder gets each group's
``group_deliver`` and ``group_done`` or ``group_error``. The fault
injector (``adaptation/faults.py``) sees every enqueue and each round's
announcement.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import datetime
import itertools
import logging
import pickle
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from .. import executor as _exec
from .. import quantization as _quant
from .. import topology as _topo
from ..observability import flight_recorder as _flight
from ..observability import registry as _obs
from ..utils import env as _env
from .control_plane import (ALLGATHER, ALLREDUCE, BROADCAST,
                            FLAG_HIERARCHICAL_ALLGATHER,
                            FLAG_HIERARCHICAL_ALLREDUCE, OP_NAMES,
                            Coordinator, Group, Meta, dtype_name)
from .timeline_py import PyTimeline, write_clock_sidecar

_log = logging.getLogger(__name__)

# The longest an idle rank stays out of the negotiation rounds: it bounds
# how long a rank's shutdown, or an op only some ranks have submitted,
# waits for the idle ranks to join a round.
IDLE_CYCLE_S = 0.1

# Pings of the clock handshake each nonzero rank runs with rank 0 when
# the engine starts (the shortest round trip's estimate wins).
CLOCK_PINGS = 8



class HorovodInternalError(RuntimeError):
    pass


class _EngineMetrics:
    """Registry handles of the engine's hot paths, JAX's families
    (``horovod_tpu/ops/collective.py:57-170``), resolved once at engine
    construction: the enqueue and dispatch paths do dictionary lookups
    only. The families are process-global, so they outlive
    ``stop_engine()``."""

    _OPS = (ALLREDUCE, ALLGATHER, BROADCAST)

    def __init__(self):
        r = _obs.registry()
        phase = r.histogram(
            "hvdtpu_op_phase_seconds",
            "Per-collective latency by lifecycle phase (negotiate = "
            "enqueue until the group is agreed/delivered; queue = "
            "delivery until XLA dispatch; execute = fused program wall "
            "time)", buckets=_obs.LATENCY_BUCKETS)
        ops = r.counter("hvdtpu_ops_total", "Collective requests enqueued")
        exec_total = r.counter(
            "hvdtpu_op_execute_seconds_total",
            "Cumulative wall seconds executing fused collective groups")
        self.phase = {
            (op, ph): phase.labels(op=OP_NAMES[op], phase=ph)
            for op in self._OPS
            for ph in ("negotiate", "queue", "execute")}
        self.ops = {op: ops.labels(op=OP_NAMES[op]) for op in self._OPS}
        self.exec_total = {op: exec_total.labels(op=OP_NAMES[op])
                           for op in self._OPS}
        self.group_size = r.histogram(
            "hvdtpu_fused_group_size",
            "Tensors per executed fusion group",
            buckets=_obs.SIZE_BUCKETS).labels()
        self.group_bytes = r.histogram(
            "hvdtpu_fused_group_bytes",
            "Wire bytes per executed fusion group",
            buckets=_obs.BYTE_BUCKETS).labels()
        self._wire = r.counter(
            "hvdtpu_wire_bytes_enqueued_total",
            "Bytes-on-wire enqueued, by compression wire spec ('raw' = "
            "the tensor's own dtype); matches _Request accounting")
        self._wire_children = {None: self._wire.labels(spec="raw")}
        self.cycles = r.counter(
            "hvdtpu_cycles_total",
            "Background dispatcher cycles (Python fallback loop)").labels()
        self.cycle_busy = r.counter(
            "hvdtpu_cycle_busy_seconds_total",
            "Dispatcher seconds spent draining/planning/executing").labels()
        self.cycle_idle = r.counter(
            "hvdtpu_cycle_idle_seconds_total",
            "Dispatcher seconds spent waiting for work").labels()
        self.stalled_count = r.gauge(
            "hvdtpu_engine_stalled_tensors",
            "In-flight collectives currently past the stall warning "
            "window (engine view)").labels()
        self.stalled_info = r.gauge(
            "hvdtpu_engine_stalled_tensor_seconds",
            "Seconds each stalled tensor has waited, labeled with the "
            "coordinator's missing-ranks report when available")
        self._adapted = r.counter(
            "hvdtpu_adaptation_applied_groups_total",
            "Fused allreduce groups executed under a policy wire "
            "override, by spec (docs/adaptation.md)")
        self._adapted_children: Dict[str, object] = {}

    def adapted_group(self, spec: str) -> None:
        child = self._adapted_children.get(spec)
        if child is None:
            child = self._adapted_children[spec] = \
                self._adapted.labels(spec=spec)
        child.inc()

    def wire_bytes(self, spec: Optional[str], nbytes: int) -> None:
        child = self._wire_children.get(spec)
        if child is None:
            child = self._wire_children[spec] = self._wire.labels(spec=spec)
        child.inc(nbytes)

    def group_delivered(self, op: int, reqs, t_deliver: float) -> None:
        """Close the negotiate phase of every request of a delivered
        group and record the group's shape."""
        ph = self.phase[(op, "negotiate")]
        for r in reqs:
            ph.observe(t_deliver - r.enqueued_at)
        self.group_size.observe(len(reqs))
        self.group_bytes.observe(sum(r.meta.nbytes for r in reqs))

    def group_executed(self, op: int, t_deliver: float, t_start: float,
                       t_end: float) -> None:
        self.phase[(op, "queue")].observe(t_start - t_deliver)
        self.phase[(op, "execute")].observe(t_end - t_start)
        self.exec_total[op].inc(t_end - t_start)

    def set_stalls(self, entries) -> None:
        """Replace the stalled-tensor gauges with the current episode,
        ``entries`` [(tensor, age_s, missing_ranks)]; cleared first, so a
        resolved stall leaves the export."""
        self.stalled_info.clear()
        self.stalled_count.set(len(entries))
        for tensor, age, missing in entries:
            self.stalled_info.labels(
                tensor=tensor, missing_ranks=missing).set(age)


class _Plan(NamedTuple):
    """What rank 0 sends every rank after a round."""

    groups: list
    stopping: bool
    idle: bool           # no name awaits a rank's announcement
    stalls: dict         # name -> ranks that have not announced it
    failures: list       # failure events (``check_failures``)
    params: dict         # wire epochs


def _send_obj(obj, dst: int, group) -> None:
    data = bytearray(pickle.dumps(obj))
    dist.send(torch.tensor([len(data)], dtype=torch.int64), dst, group=group)
    dist.send(torch.frombuffer(data, dtype=torch.uint8), dst, group=group)


def _recv_payload(n: torch.Tensor, src: int, group):
    buf = torch.empty(int(n), dtype=torch.uint8)
    dist.recv(buf, src, group=group)
    return pickle.loads(buf.numpy().tobytes())


def _recv_obj(src: int, group):
    n = torch.empty(1, dtype=torch.int64)
    dist.recv(n, src, group=group)
    return _recv_payload(n, src, group)


DUPLICATE_NAME_ERROR = (
    "Requested to {op} a tensor with the same name as another tensor that is "
    "currently being processed. If you want to request another tensor, use a "
    "different tensor name.")

SHUT_DOWN_ERROR = (
    "Horovod has been shut down. This was caused by an exception on one of "
    "the ranks or an attempt to {op} a tensor after one of the ranks "
    "finished execution.")


class _Done(NamedTuple):
    """How a group finished on CUDA: the event recorded after it on the
    engine's stream, and the distinct buffers its results are views of."""

    event: torch.cuda.Event
    buffers: tuple


class _Ran(NamedTuple):
    """A group the engine ran: what its execute phase is recorded with.
    On CUDA ``start`` and ``end`` are the events recorded around it on
    the engine's stream (its seconds on the card); on the CPU they are
    None, and the group is recorded as it returns."""

    op: int
    seq: int
    activity: str
    t_deliver: float
    t_start: float
    outs: list          # [(name, result shape)]
    start: Optional[torch.cuda.Event]
    end: Optional[torch.cuda.Event]


class Handle:
    """An async op, set once by the engine with a result or an error
    (``_state``: result, error, :class:`_Done` or None). ``group`` names
    the requests it was fused with, ``wire`` the adaptation policy's wire
    the group moved on (None: its own). Waiters sleep on the engine's
    condition, which the engine notifies once per group."""

    __slots__ = ("name", "group", "wire", "_cv", "_state")

    def __init__(self, name: str, cv: threading.Condition):
        self.name = name
        self.group: tuple = ()
        self.wire: Optional[str] = None
        self._cv = cv
        self._state: Optional[tuple] = None

    def poll(self) -> bool:
        """Non-blocking completion check."""
        return self._state is not None

    def wait(self, timeout: Optional[float] = None):
        """Block until done and return the op's output, or raise its
        error; ``TimeoutError`` after ``timeout`` seconds."""
        return _wait_all([self], timeout)[0]


def _wait_all(handles: Sequence[Handle],
              timeout: Optional[float]) -> List[torch.Tensor]:
    """Wait for every handle (``timeout`` in all), raise the first error
    in order, make the caller's CUDA stream wait for each group that
    computed a result (once per group) and mark the group's buffers as
    used on that stream; return the results."""
    i, n = 0, len(handles)

    def done() -> bool:
        nonlocal i
        while i < n and handles[i]._state is not None:
            i += 1
        return i == n

    if not done():
        _flush_hint()
        with handles[i]._cv:
            if not handles[i]._cv.wait_for(done, timeout):
                raise TimeoutError(f"collective '{handles[i].name}' did not "
                                   f"complete within {timeout}s")
    stream, seen = None, set()
    for h in handles:
        error, group_done = h._state[1], h._state[2]
        if error is not None:
            raise error
        if group_done is None or id(group_done) in seen:
            continue
        seen.add(id(group_done))
        if stream is None:
            stream = torch.cuda.current_stream(group_done.buffers[0].device)
        stream.wait_event(group_done.event)
        for b in group_done.buffers:
            b.record_stream(stream)
    return [h._state[0] for h in handles]


class GroupedHandle:
    """The handle of a list of ops submitted together; its result is the
    list of their results."""

    def __init__(self, handles: Sequence[Handle]):
        self.handles = list(handles)

    @property
    def groups(self) -> List[tuple]:
        """The distinct fused groups the ops ran in, in order."""
        return list(dict.fromkeys(h.group for h in self.handles))

    def poll(self) -> bool:
        return all(h.poll() for h in self.handles)

    def wait(self, timeout: Optional[float] = None) -> List[torch.Tensor]:
        return _wait_all(self.handles, timeout)


class _Request:
    __slots__ = ("meta", "tensor", "handle", "ready", "target",
                 "enqueued_at")

    def __init__(self, meta: Meta, tensor: torch.Tensor, handle: Handle,
                 ready, target: Optional[torch.Tensor] = None):
        self.meta, self.tensor, self.handle, self.ready = (meta, tensor,
                                                           handle, ready)
        self.target = target    # an in-place op's input, else None
        self.enqueued_at = time.monotonic()


class CollectiveEngine:
    """The background thread of one process: negotiate, plan, execute."""

    def __init__(self, topo: _topo.Topology):
        self.size, self.rank = topo.size, topo.rank
        self.device = topo.device
        self._ctrl = topo.control_group
        self._ordered_sum = topo.size > 1 and topo.backend == "gloo"
        self._nccl = topo.backend == "nccl"
        self._activity = "NCCL_" if self._nccl else "GLOO_"
        # Rank 0's environment decides how every group runs.
        flags = ((FLAG_HIERARCHICAL_ALLREDUCE
                  if _env.hierarchical_allreduce() else 0)
                 | (FLAG_HIERARCHICAL_ALLGATHER
                    if _env.hierarchical_allgather() else 0))
        # Rank 0's coordinator plans for every rank; the others keep the
        # flags only.
        self._coord = Coordinator(topo.size, flags,
                                  primary=self.rank == 0)
        self._init_hierarchy(topo)
        self.stall_warning_s = _env.stall_warning_secs()
        self.failure_timeout_s = _env.failure_timeout_secs()
        self._last_stall_check = time.monotonic()
        self._missing = {}      # name -> ranks rank 0 still awaits
        self._mark_cycles = _env.timeline_mark_cycles()
        self._trace_path: Optional[str] = None
        self._clock_offset = 0.0    # rank 0's clock minus ours
        self.timeline = self._ensure_timeline()
        self._group_seq = 0     # groups delivered: the same on every rank
        self._t_deliver = 0.0   # when this cycle's plan arrived
        self._lock = threading.Lock()
        self._cv = threading.Condition()    # handles' results are set
        self._queue: List[_Request] = []
        self._announced = {}            # name -> _Request, awaiting a plan
        self._names = set()             # in flight: queued or announced
        self._counter = itertools.count()
        self._wake = threading.Event()      # a waiter: start the cycle now
        self._arrived = threading.Event()   # new work or a stop: end idling
        self._stop = False
        self._closed = False
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._clock_handshake()
        self.groups_executed = 0
        self.rounds = 0                 # negotiation rounds run
        # CUDA groups whose execute phase waits for the card's events.
        self._ran: collections.deque = collections.deque()
        self._ran_lock = threading.Lock()
        self._metrics = _EngineMetrics()
        # The fault harness, resolved at the first enqueue (None without
        # HOROVOD_TPU_FAULT_SPEC: one attribute check per enqueue).
        self._faults = None
        self._faults_tried = False
        self._notes: List[tuple] = []   # alerts for rank 0's policy
        self._wire_epochs: List[tuple] = []     # [(from_seq, spec)]
        self._fatal: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hvd-collective-engine")
        self._thread.start()

    # ---------------------------------------------------------- submitting

    def enqueue(self, op: int, tensors: Sequence[torch.Tensor],
                names: Sequence[Optional[str]], *, root_rank: int = 0,
                average: bool = False, prescale: float = 1.0,
                postscale: float = 1.0,
                wires: Optional[Sequence[Optional[str]]] = None,
                inplace: bool = False) -> List[Handle]:
        """Queue one request per tensor (a name of None draws
        ``<op>.noname.<n>``), ``wires[i]`` its encoded wire. ``inplace``:
        each result is written into its input tensor, which is the
        handle's result. On CUDA one event, recorded on the caller's
        stream after the call's tensors were produced, fences them all."""
        if not self._faults_tried:
            self._faults_tried = True
            from ..adaptation import faults as _faults_mod
            self._faults = _faults_mod.injector()
        if self._faults is not None:
            for _ in tensors:
                self._faults.on_enqueue()
        reqs = []
        attrs = (root_rank, bool(average), float(prescale), float(postscale))
        if wires is None:
            wires = [None] * len(tensors)
        for tensor, name, wire in zip(tensors, names, wires):
            t = tensor.detach()
            if t.device != self.device:
                raise ValueError(f"{OP_NAMES[op]}: the tensor is on "
                                 f"{t.device}; this process's collectives "
                                 f"run on {self.device}")
            nm = name if name is not None else \
                f"{OP_NAMES[op]}.noname.{next(self._counter)}"
            meta = Meta(nm, op, dtype_name(t.dtype), tuple(t.shape), *attrs,
                        wire)
            reqs.append(_Request(meta, t, Handle(nm, self._cv), None,
                                 tensor if inplace else None))
        m = self._metrics
        for r in reqs:
            m.wire_bytes(r.meta.wire, r.meta.nbytes)
            m.ops[op].inc()
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            for r in reqs:
                r.ready = ready
        new = [r.meta.name for r in reqs]
        with self._lock:
            if self._closed:
                if self._fatal is not None:
                    raise self._fatal
                raise HorovodInternalError(
                    SHUT_DOWN_ERROR.format(op=OP_NAMES[op]))
            if len(set(new)) < len(new) or not self._names.isdisjoint(new):
                raise ValueError(DUPLICATE_NAME_ERROR.format(op=OP_NAMES[op]))
            self._names.update(new)
            self._queue.extend(reqs)
            self._arrived.set()
        return [r.handle for r in reqs]

    def note_alert(self, kind: str, rank: int) -> None:
        """Forward one health alert to rank 0's adaptation policy in the
        next round (JAX's ``AlertNoteRequest``; the health monitor's
        coordinator sink calls it). Fire and forget."""
        with self._lock:
            self._notes.append((str(kind), int(rank)))

    def flush_hint(self) -> None:
        """A submitter is about to block: start the next cycle now."""
        self._wake.set()

    def shutdown(self, timeout: float = 60.0) -> None:
        """Ask every rank's engine to stop and wait for this one's thread."""
        self._stop = True
        self._arrived.set()
        self._wake.set()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout)
            if self._thread.is_alive():
                _log.warning("collective engine did not stop within %.0f s",
                             timeout)

    # -------------------------------------------------------------- cycle

    def _run(self) -> None:
        if self._stream is not None:
            torch.cuda.set_device(self.device)
        error: Optional[BaseException] = None
        m = self._metrics
        t_end = time.monotonic()
        try:
            stopping = idle = False
            while not stopping:
                if idle:
                    self._arrived.wait(IDLE_CYCLE_S)
                self._wake.wait(_env.cycle_time_ms() / 1e3)
                self._wake.clear()
                # Utilization: busy is the round and its groups, idle the
                # waits above.
                t_wake = time.monotonic()
                m.cycles.inc()
                m.cycle_idle.inc(t_wake - t_end)
                if self._mark_cycles and self.timeline is not None:
                    self.timeline.mark_cycle()
                with self._lock:
                    batch, self._queue = self._queue, []
                    notes, self._notes = self._notes, []
                    self._arrived.clear()
                    for r in batch:
                        self._announced[r.meta.name] = r
                plan = self._negotiate(
                    [r.meta for r in batch], self._stop,
                    _env.fusion_threshold_bytes(), notes)
                self._t_deliver = time.monotonic()
                stopping, idle = plan.stopping, plan.idle
                if plan.failures:
                    # Every rank fails its pending ops and skips the
                    # round's groups alike; a lost rank stops the world.
                    self._on_failures(plan.failures, plan.stopping)
                else:
                    for g in plan.groups:
                        self._execute(g)
                self.collect_timings()
                self._maybe_check_stalls()
                t_end = time.monotonic()
                m.cycle_busy.inc(t_end - t_wake)
            self.collect_timings(block=True)
        except Exception as e:   # the thread's boundary: fail every handle
            _log.exception("collective engine failed")
            error = HorovodInternalError(f"collective engine failed: {e}")
        self._close(error or self._fatal)
        if self.timeline is not None:
            self.timeline.close()

    def _negotiate(self, metas: List[Meta], stop: bool, threshold: int,
                   notes: Sequence[tuple] = ()) -> _Plan:
        """One round with rank 0: every rank sends its announcements
        (none while a ``drop_announce`` fault is active) and the alerts
        it forwards; rank 0 feeds its coordinator, runs the policy, and
        sends every rank the plan: the ordered groups, whether any rank
        is stopping, whether the world is idle (no name awaits an
        announcement), the stall report, the failure events and the
        params. At world size 1 the round sends nothing."""
        self.rounds += 1
        if metas and self._faults is not None \
                and self._faults.drop_announce_active():
            metas = []
        t_sent = time.monotonic()
        if self.rank != 0:
            # The send time on rank 0's clock.
            _send_obj((stop, metas, list(notes), t_sent + self._clock_offset),
                      0, self._ctrl)
            plan = _recv_obj(0, self._ctrl)
        else:
            plan = self._plan_round((stop, metas, list(notes), t_sent),
                                    threshold)
        self._missing = plan.stalls
        if plan.params:
            self._apply_params(plan.params)
        return plan

    def _plan_round(self, msg: tuple, threshold: int) -> _Plan:
        """Rank 0's half of a round: gather, coordinate, send the plan to
        every rank heard from."""
        got = self._gather_round(msg)
        now = time.monotonic()
        coord = self._coord
        for r in sorted(got):
            (stop, metas, notes, t_sent), t_in = got[r]
            # Lateness from when the rank sent its round (on rank 0's
            # clock), the heartbeat from when it came in.
            coord.announce(r, metas, t_in, sent=t_sent)
            for kind, rank in notes:
                coord.note_alert(kind, rank, now)
        coord.maybe_adapt(now)
        coord.check_stalls(now)
        stalls = (coord.stalled(self.stall_warning_s)
                  if self.stall_warning_s > 0 else {})
        failures = coord.check_failures(now)
        lost = len(got) < self.size
        groups = [] if failures else coord.plan(threshold)
        plan = _Plan(groups, lost or any(m[0][0] for m in got.values()),
                     coord.pending() == 0, stalls, failures, coord.params())
        if self.size > 1:
            data = bytearray(pickle.dumps(plan))
            n = torch.tensor([len(data)], dtype=torch.int64)
            payload = torch.frombuffer(data, dtype=torch.uint8)
            for r in sorted(got):
                if r:
                    dist.send(n, r, group=self._ctrl)
                    dist.send(payload, r, group=self._ctrl)
        return plan

    def _gather_round(self, msg: tuple):
        """Every rank's round message, ``{rank: (msg, t)}`` with ``t`` rank
        0's clock when it came in. With ``failure_timeout_s`` set, rank 0
        waits for a rank at most that long after the rank's last round;
        a rank not heard from by then is left out (its coordinator then
        reports ``heartbeat_timeout``). A rank never heard from is waited
        for: a rendezvous may take longer."""
        if self.size == 1:
            return {0: (msg, time.monotonic())}
        got = {}
        sizes = [torch.empty(1, dtype=torch.int64) for _ in range(self.size)]
        works = [(r, dist.irecv(sizes[r], r, group=self._ctrl))
                 for r in range(1, self.size)]
        seen = self._coord._last_seen
        for r, work in works:
            last = seen.get(r)
            if self.failure_timeout_s <= 0 or last is None:
                work.wait()
            else:
                left = last + self.failure_timeout_s - time.monotonic()
                try:
                    work.wait(datetime.timedelta(seconds=max(left, 1e-3)))
                except RuntimeError as e:
                    _log.error("rank %d sent no round message within the "
                               "failure timeout (%.1f s): %s", r,
                               self.failure_timeout_s, e)
                    continue
            got[r] = (_recv_payload(sizes[r], r, self._ctrl),
                      time.monotonic())
        got[0] = (msg, time.monotonic())     # rank 0 is here now
        return got

    def _apply_params(self, params: dict) -> None:
        """The plan's params (JAX's fetch side channel): the wire epochs
        replace this rank's list whole."""
        we = params.get("wire_epochs")
        if we:
            epochs = [(int(fs), str(sp)) for fs, sp in we]
            if epochs != self._wire_epochs:
                _flight.recorder().note("wire_epoch", (";".join(
                    f"{fs}:{sp or 'raw'}" for fs, sp in epochs),))
            self._wire_epochs = epochs

    def _on_failures(self, failures: List[dict], fatal: bool) -> None:
        """Rank 0's failure events: note each, then fail every pending op
        with the typed event (a ``slow_rank`` one a ``SlowRankFailure``);
        ``fatal`` (a rank is lost) also closes the engine with it."""
        from ..elastic.failure import failure_from_event
        for f in failures:
            _flight.recorder().note("failure", (
                int(f.get("rank", -1)), str(f.get("kind", "")),
                str(f.get("detail", ""))[:300]))
        f = dict(failures[0])
        f["detail"] = "; ".join(str(x.get("detail", "")) for x in failures)
        err = failure_from_event(f)
        _log.error("coordinator escalated worker failure: %s", err)
        with self._lock:
            pending = self._queue + list(self._announced.values())
            self._queue, self._announced = [], {}
            self._names.clear()
            if fatal:
                self._fatal = err
        with self._cv:
            for r in pending:
                r.handle._state = (None, err, None)
            self._cv.notify_all()

    # ------------------------------------------------------------ tracing

    def _ensure_timeline(self) -> Optional[PyTimeline]:
        """The timeline writer of this rank, or None: without a
        ``{rank}`` placeholder in ``HOROVOD_TIMELINE`` only rank 0
        writes, with one every rank writes its own file. An unwritable
        path disables the timeline rather than failing the ops. Its clock
        is unsynced until :meth:`_clock_handshake` writes the offset."""
        path = _env.resolved_timeline_path(self.rank)
        if not path:
            return None
        try:
            tl = PyTimeline(path, rank=self.rank, world=self.size)
        except OSError as e:
            _log.warning("timeline disabled: cannot open %s: %s", path, e)
            return None
        self._trace_path = path
        self._write_clock_sidecar(tl, 0.0, 0.0, False)
        return tl

    def _write_clock_sidecar(self, tl: PyTimeline, offset_s: float,
                             rtt_s: float, synced: bool) -> None:
        try:
            write_clock_sidecar(self._trace_path, {
                "rank": self.rank, "world": self.size,
                "start_mono_us": tl.start_monotonic_us,
                "offset_to_rank0_us": offset_s * 1e6, "rtt_us": rtt_s * 1e6,
                "clock_synced": bool(synced)})
        except OSError as e:
            _log.warning("timeline clock sidecar not written: %s", e)

    def _clock_handshake(self) -> None:
        """Each nonzero rank's offset to rank 0's clock, before the first
        round: ``CLOCK_PINGS`` pings, each answered at once with rank 0's
        clock (JAX's ``ClockProbeRequest``); rank 0 read it between the
        ping's send and the reply's arrival, taken as the middle of the
        two, and the shortest round trip's estimate wins. Rank 0 is the
        reference clock. The rounds stamp each rank's send time on rank
        0's clock with the offset (the skew tracker measures lateness from
        those stamps), and the timeline, its sidecar and the flight
        recorder's dump header carry it."""
        best = (0.0, 0.0)       # (rtt, offset)
        if self.size > 1:
            buf = torch.zeros(1, dtype=torch.float64)
            if self.rank == 0:
                for r in range(1, self.size):
                    for _ in range(CLOCK_PINGS):
                        dist.recv(buf, r, group=self._ctrl)
                        buf[0] = time.monotonic()
                        dist.send(buf, r, group=self._ctrl)
            else:
                best = (float("inf"), 0.0)
                for _ in range(CLOCK_PINGS):
                    t0 = time.monotonic()
                    dist.send(buf, 0, group=self._ctrl)
                    dist.recv(buf, 0, group=self._ctrl)
                    t1 = time.monotonic()
                    if t1 - t0 < best[0]:
                        best = (t1 - t0, float(buf[0]) - (t0 + t1) / 2)
                self._clock_offset = best[1]
        rtt, offset = best
        _flight.recorder().set_clock_meta(offset, rtt, True)
        if self.timeline is not None:
            self.timeline.set_clock_meta(offset, rtt)
            self._write_clock_sidecar(self.timeline, offset, rtt, True)

    def _maybe_check_stalls(self) -> None:
        """Warn about ops in flight past ``stall_warning_s``
        (CheckForStalledTensors, operations.cc:1625-1672): each with its
        op type and age and, at more than one rank, the ranks rank 0's
        coordinator has not heard from. At one rank no rank can be
        missing: a stall there is a wedged engine or an op that never
        reached it, and the report says so. At most one report every
        ``stall_warning_s``."""
        if self.stall_warning_s <= 0:
            return
        now = time.monotonic()
        if now - self._last_stall_check < self.stall_warning_s:
            return
        self._last_stall_check = now
        with self._lock:
            stalled = sorted(
                (r.meta.name, OP_NAMES[r.meta.op], now - r.enqueued_at)
                for r in itertools.chain(self._queue,
                                         self._announced.values())
                if now - r.enqueued_at > self.stall_warning_s)
        if not stalled:
            # The episode resolved: no gauge names a finished op.
            self._metrics.set_stalls([])
            return
        lines, entries = [], []
        for name, op, age in stalled:
            missing = self._missing.get(name)
            if missing is not None:
                lines.append(f"{name} [missing ranks: "
                             f"{', '.join(map(str, missing))}] "
                             f"[{op}, waiting {int(age)}s]")
                entries.append((name, age, ",".join(map(str, missing))))
            elif self.size > 1:
                lines.append(f"{name} [{op}, waiting {int(age)}s; "
                             "announced, awaiting the coordinator's "
                             "grouping]")
                entries.append((name, age, "unknown"))
            else:
                lines.append(f"{name} [{op}, waiting {int(age)}s; one "
                             "rank, so no rank is missing: likely a "
                             "wedged engine or an op never announced]")
                entries.append((name, age, "none(single-process)"))
        self._metrics.set_stalls(entries)
        _log.warning(
            "One or more tensors were submitted to be reduced, gathered "
            "or broadcasted by subset of ranks and are waiting for "
            "remainder of ranks for more than %d seconds. This may "
            "indicate that different ranks are trying to submit "
            "different tensors or that only subset of ranks is "
            "submitting tensors, which will cause deadlock.\n"
            "Stalled ops:\n%s",
            int(self.stall_warning_s), "\n".join(lines))
        self._maybe_escalate_stalls(now)

    def _maybe_escalate_stalls(self, now: float) -> None:
        """Past the failure timeout a stalled op will never complete
        (some rank is gone): fail its handle with a typed
        ``WorkerFailure(kind="stall")`` instead of warning forever, so the
        blocked submitter unblocks with an event an elastic loop can act
        on. The op leaves this rank's tables; should the missing rank
        still announce it, rank 0's plan names an op this rank no longer
        holds and the engine fails every handle (``_execute``), rather
        than skip a collective the other ranks enter. Off at
        ``failure_timeout_s == 0``, the default: the stall report only
        warns, as the reference's does."""
        if self.failure_timeout_s <= 0:
            return
        with self._lock:
            overdue = [r for r in itertools.chain(self._queue,
                                                  self._announced.values())
                       if now - r.enqueued_at > self.failure_timeout_s]
            for r in overdue:
                self._announced.pop(r.meta.name, None)
                self._names.discard(r.meta.name)
                if r in self._queue:
                    self._queue.remove(r)
        if not overdue:
            return
        from ..elastic.failure import WorkerFailure
        with self._cv:
            for r in overdue:
                missing = self._missing.get(r.meta.name)
                r.handle._state = (None, WorkerFailure(
                    kind="stall",
                    detail=(f"collective '{r.meta.name}' "
                            f"({OP_NAMES[r.meta.op]}) incomplete after "
                            f"{now - r.enqueued_at:.1f}s (> failure timeout "
                            f"{self.failure_timeout_s:.1f}s)"
                            + (f"; missing ranks: "
                               f"{', '.join(map(str, missing))}"
                               if missing is not None else ""))), None)
            self._cv.notify_all()
        names = ", ".join(sorted(r.meta.name for r in overdue))
        _log.error("escalated %d stalled collectives to WorkerFailure "
                   "after %.1fs: %s", len(overdue), self.failure_timeout_s,
                   names)
        # The evidence, while the engine still remembers the episode.
        _flight.recorder().note("stall", (names, round(max(
            now - r.enqueued_at for r in overdue), 3)))
        _flight.dump_on("stall_escalation")

    def _close(self, error: Optional[BaseException]) -> None:
        """Refuse new ops and fail the pending ones with ``error``, or with
        ``SHUT_DOWN_ERROR`` when the engine was stopped."""
        with self._lock:
            self._closed = True
            pending = self._queue + list(self._announced.values())
            self._queue, self._announced = [], {}
            self._names.clear()
        with self._cv:
            for r in pending:
                r.handle._state = (None, error or HorovodInternalError(
                    SHUT_DOWN_ERROR.format(op=OP_NAMES[r.meta.op])), None)
            self._cv.notify_all()

    def _fulfill(self, reqs: List[_Request], outs=None, error=None,
                 done: Optional[_Done] = None, group: tuple = (),
                 wire: Optional[str] = None) -> None:
        """Set every request's handle, then wake the waiters once."""
        with self._cv:
            for i, r in enumerate(reqs):
                r.handle.group = group
                r.handle.wire = wire
                r.handle._state = (None if outs is None else outs[i], error,
                                   done)
            self._cv.notify_all()

    # ----------------------------------------------------------- execution

    def _execute(self, g: Group) -> None:
        with self._lock:
            missing = [n for n in g.names if n not in self._announced]
            if missing:
                raise HorovodInternalError(
                    f"rank 0's plan names {missing}, which this rank no "
                    "longer holds (failed past the failure timeout); "
                    "failing the engine rather than skipping a collective "
                    "the other ranks enter")
            reqs = [self._announced.pop(n) for n in g.names]
            self._names.difference_update(g.names)
        seq, self._group_seq = self._group_seq, self._group_seq + 1
        op_name = OP_NAMES[g.op]
        self._metrics.group_delivered(g.op, reqs, self._t_deliver)
        _flight.recorder().group_deliver(seq, op_name, len(reqs))
        tl = self.timeline
        if tl is not None:
            for r in reqs:
                tl.negotiate_span(r.meta.name, op_name, r.enqueued_at,
                                  self._t_deliver, group=seq)
        if g.error:
            _flight.recorder().group_error(seq, op_name, len(reqs), g.error)
            self._fulfill(reqs, error=HorovodInternalError(g.error))
            return
        # On CUDA the engine's stream waits on the events the submitters
        # recorded (the host does not), and events recorded on it around
        # the group time it on the card: execute is the group's seconds
        # there, never the enqueue time of an asynchronous NCCL call. The
        # card's figure is read in a later cycle (``collect_timings``).
        t_start = time.monotonic()
        activity = self._activity + op_name.upper()
        wire = (self._wire_override_for(seq, reqs)
                if self._wire_epochs and g.op == ALLREDUCE else None)
        try:
            ctx = (torch.cuda.stream(self._stream) if self._stream is not None
                   else contextlib.nullcontext())
            with ctx:
                done = start = None
                if self._stream is not None:
                    for ev in {id(r.ready): r.ready for r in reqs}.values():
                        self._stream.wait_event(ev)
                    for r in reqs:
                        r.tensor.record_stream(self._stream)
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(self._stream)
                outs = self._run_group(g, reqs, wire)
                for i, r in enumerate(reqs):
                    if r.target is not None:
                        r.target.detach().copy_(outs[i])
                        outs[i] = r.target
                if self._stream is not None:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record(self._stream)
                    # Results are views of a few buffers: one per dtype.
                    bases = {}
                    for o in outs:
                        b = o if o._base is None else o._base
                        bases[id(b)] = b
                    done = _Done(end, tuple(bases.values()))
        except Exception as e:
            t_end = time.monotonic()
            if tl is not None:
                for r in reqs:
                    tl.execute_span(r.meta.name, activity, t_start, t_end)
            _flight.recorder().group_error(seq, op_name, len(reqs), str(e))
            self._fulfill(reqs, error=HorovodInternalError(
                f"{op_name} of {g.names} failed: {e}"))
            return
        ran = _Ran(g.op, seq, activity, self._t_deliver, t_start,
                   [(r.meta.name, tuple(o.shape)) for r, o in zip(reqs, outs)],
                   start, None if done is None else done.event)
        if done is None:
            self._record_executed(ran, time.monotonic())
        else:
            with self._ran_lock:
                self._ran.append(ran)
        self.groups_executed += 1
        self._fulfill(reqs, outs, done=done, group=tuple(g.names),
                      wire=wire)

    def collect_timings(self, block: bool = False) -> None:
        """Record the execute phase of the CUDA groups the card has
        finished, oldest first (with ``block``, of every group run so
        far, waiting for the card): the seconds between the events
        recorded before and after each on the engine's stream, from the
        group's dispatch on the host clock. The engine calls it every
        cycle, ``StepTimer`` at a step's end; a group the card has not
        finished by then counts in a later step."""
        with self._ran_lock:
            while self._ran:
                ran = self._ran[0]
                if block:
                    ran.end.synchronize()
                elif not ran.end.query():
                    return
                self._ran.popleft()
                self._record_executed(
                    ran, ran.t_start + ran.start.elapsed_time(ran.end) / 1e3)

    def _record_executed(self, ran: "_Ran", t_end: float) -> None:
        """A group's queue and execute phases, its ``group_done`` and its
        activity spans."""
        op_name = OP_NAMES[ran.op]
        self._metrics.group_executed(ran.op, ran.t_deliver, ran.t_start,
                                     t_end)
        _flight.recorder().group_done(ran.seq, op_name, len(ran.outs),
                                      ran.t_deliver, ran.t_start, t_end)
        tl = self.timeline
        if tl is not None:
            for name, shape in ran.outs:
                tl.execute_span(name, ran.activity, ran.t_start, t_end, shape)

    def _wire_override_for(self, seq: int, reqs: List[_Request]
                           ) -> Optional[str]:
        """The wire the policy's epochs put on fused allreduce group
        ``seq``, or None: the last epoch at or below ``seq`` wins ("" is
        raw again). Only groups of floating tensors with no wire of their
        own are eligible."""
        spec = None
        for fs, sp in self._wire_epochs:
            if seq >= fs:
                spec = sp
            else:
                break
        if not spec:
            return None
        for r in reqs:
            if r.meta.wire is not None or not r.tensor.is_floating_point():
                return None
        self._metrics.adapted_group(spec)
        return spec

    def _run_group(self, g: Group, reqs: List[_Request],
                   override: Optional[str] = None):
        m = reqs[0].meta
        ts = [r.tensor for r in reqs]
        if g.op == ALLREDUCE:
            post = m.postscale / self.size if m.average else m.postscale
            wire = _quant.parse(m.wire)
            restore = None
            # The policy's wire: "bf16" moves a cast, the blockwise specs
            # ride the quantized wire.
            if override == "bf16":
                restore = [t.dtype for t in ts]
                ts = [t.to(torch.bfloat16) for t in ts]
            elif override:
                wire = _quant.parse(override)
            hier = g.flags & FLAG_HIERARCHICAL_ALLREDUCE and wire is None \
                and restore is None
            outs = _exec.fused_allreduce(ts,
                                         self._hier_sum if hier else self._sum,
                                         m.prescale, post, wire, self.size,
                                         self._all_to_all, self._all_gather)
            if restore is not None:
                outs = [o.to(dt) for o, dt in zip(outs, restore)]
            return outs
        if g.op == BROADCAST:
            return _exec.fused_broadcast(
                ts, lambda b: self._broadcast(b, m.root_rank))
        hier = g.flags & FLAG_HIERARCHICAL_ALLGATHER
        return _exec.fused_allgather(ts, [g.rows[n] for n in g.names],
                                     self._hier_gather if hier
                                     else self._gather)

    # The two-level layout: ``ici`` ranks to a node, ``dcn`` nodes, rank
    # d * ici + i. A level of one rank is the identity; a level of every
    # rank is the default group.

    def _init_hierarchy(self, topo: _topo.Topology) -> None:
        ici = topo.local_size if self.size % topo.local_size == 0 else 1
        self._ici, self._dcn = ici, self.size // ici
        self._ici_group = self._dcn_group = dist.group.WORLD
        if 1 < ici < self.size:
            mesh = _topo.hierarchical_mesh()
            self._ici_group = mesh.get_group("ici")
            self._dcn_group = mesh.get_group("dcn")

    def _group_gather(self, buf: torch.Tensor, group, n: int) -> torch.Tensor:
        """``[n, *buf.shape]``: every member's ``buf``, in group order."""
        if n == 1:
            return buf[None]
        parts = buf.new_empty((n,) + tuple(buf.shape))
        if self._nccl:
            dist.all_gather_into_tensor(parts, buf, group=group)
        else:
            dist.all_gather(list(parts), buf, group=group)
        return parts

    def _group_sum(self, buf: torch.Tensor, group, n: int) -> torch.Tensor:
        if n == 1:
            return buf
        if self._ordered_sum:
            parts = self._group_gather(buf, group, n)
            out = parts[0]
            for p in parts[1:]:
                out += p
            return out
        dist.all_reduce(buf, group=group)
        return buf

    def _hier_sum(self, buf: torch.Tensor) -> torch.Tensor:
        ici, i = self._ici, self.rank % self._ici

        def scatter(b):
            if ici == 1:
                return b
            if self._nccl:
                out = b.new_empty(b.numel() // ici)
                dist.reduce_scatter_tensor(out, b, group=self._ici_group)
                return out
            return self._group_sum(b, self._ici_group, ici).chunk(ici)[i]

        return _exec.hier_reduce(
            buf, ici, scatter,
            lambda b: self._group_sum(b, self._dcn_group, self._dcn),
            lambda b: self._group_gather(b, self._ici_group, ici).reshape(-1))

    def _hier_gather(self, buf: torch.Tensor) -> torch.Tensor:
        return _exec.hier_gather(
            buf, lambda b: self._group_gather(b, self._ici_group, self._ici),
            lambda b: self._group_gather(b, self._dcn_group, self._dcn))

    def _gather(self, buf: torch.Tensor) -> torch.Tensor:
        parts = buf.new_empty((self.size,) + tuple(buf.shape))
        dist.all_gather(list(parts), buf)
        return parts

    def _all_gather(self, buf: torch.Tensor) -> torch.Tensor:
        """Every rank's flat ``buf``, concatenated in rank order."""
        return self._gather(buf).reshape(-1)

    def _all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        """Chunk k of ``size`` equal chunks of flat ``buf`` to rank k; the
        chunks received, in rank order (the identity at one rank)."""
        if self.size == 1:
            return buf
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf)
        return out

    def _sum(self, buf: torch.Tensor) -> torch.Tensor:
        if self._ordered_sum:
            parts = self._gather(buf)
            out = parts[0]
            for p in parts[1:]:
                out += p
            return out
        dist.all_reduce(buf)
        return buf

    @staticmethod
    def _broadcast(buf: torch.Tensor, root: int) -> torch.Tensor:
        dist.broadcast(buf, src=root)
        return buf


_engine: Optional[CollectiveEngine] = None
_engine_lock = threading.Lock()
_atexit_registered = False


def start_engine(topo: _topo.Topology) -> CollectiveEngine:
    """Start this process's engine (``init`` calls it)."""
    global _engine, _atexit_registered
    with _engine_lock:
        if _engine is None:
            _engine = CollectiveEngine(topo)
            if not _atexit_registered:
                atexit.register(stop_engine)
                _atexit_registered = True
        return _engine


def stop_engine() -> None:
    """Stop this process's engine (``shutdown`` calls it)."""
    global _engine
    with _engine_lock:
        eng, _engine = _engine, None
    if eng is not None:
        eng.shutdown()


def engine() -> CollectiveEngine:
    """This process's engine; raises before ``init``."""
    _topo._get()
    return _engine


def _flush_hint() -> None:
    eng = _engine
    if eng is not None:
        eng.flush_hint()


# ---------------------------------------------------------------- public API

def _wire_for(tensor: torch.Tensor, compression) -> Optional[str]:
    """The encoded wire a blockwise ``compression`` selects for
    ``tensor``, or None: cast compressors transform the tensor before
    the request, and non-floating tensors keep the exact path."""
    spec = getattr(compression, "wire_spec", None)
    if spec is None or not tensor.is_floating_point():
        return None
    return _quant.parse(spec).encoded()


def allreduce_async(tensor: torch.Tensor, average: bool = True,
                    name: Optional[str] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=None) -> Handle:
    """Asynchronous sum (or mean, with ``average``) over all ranks. Here
    ``compression`` only selects a blockwise wire; cast compressors are
    applied by :func:`allreduce`."""
    return engine().enqueue(ALLREDUCE, [tensor], [name], average=average,
                            prescale=prescale_factor,
                            postscale=postscale_factor,
                            wires=[_wire_for(tensor, compression)])[0]


# Autograd: the synchronous ops' backward passes are collectives, as the
# torch shim registers them (horovod_tpu/torch/mpi_ops.py, after
# Horovod's torch/mpi_ops.py).

class _Allreduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, tensor, average, name, prescale, postscale,
                compression):
        ctx.args = (average, prescale, postscale, compression)
        return allreduce_async(tensor, average, name, prescale, postscale,
                               compression).wait()

    @staticmethod
    def backward(ctx, grad):
        # The op is linear, and its own adjoint: the same allreduce (the
        # same average, scales and wire) of the gradients.
        average, prescale, postscale, compression = ctx.args
        return (allreduce_async(grad.contiguous(), average, None, prescale,
                                postscale, compression).wait(),
                None, None, None, None, None)


class _Allgather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, tensor, name):
        out = allgather_async(tensor, name).wait()
        ctx.rows = tensor.shape[0]
        return out

    @staticmethod
    def backward(ctx, grad):
        # The sum over the ranks of the gathered gradient, then this
        # rank's rows. Ranks may gather different first dims: the offset
        # is the sum of the lower ranks' rows (gathered once more).
        summed = allreduce_async(grad.contiguous(), False).wait()
        rows = allgather_async(
            torch.tensor([ctx.rows], device=grad.device)).wait()
        start = int(rows[:_topo.rank()].sum())
        return summed[start:start + ctx.rows], None


class _Broadcast(torch.autograd.Function):

    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        ctx.root_rank = root_rank
        return broadcast_async(tensor, root_rank, name).wait()

    @staticmethod
    def backward(ctx, grad):
        # Every rank's gradient flows to the root's input; the others'
        # inputs did not reach the output.
        summed = allreduce_async(grad.contiguous(), False).wait()
        if _topo.rank() != ctx.root_rank:
            summed = torch.zeros_like(summed)
        return summed, None, None


def allreduce(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None, compression=None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Synchronous, differentiable allreduce. A cast ``compression``
    moves the tensor on the wire in its dtype and restores the input
    dtype after (outside the autograd Function, as the shim does); a
    blockwise one selects the quantized wire, in the backward too."""
    if compression is not None:
        t, ctx = compression.compress(tensor)
        blockwise = (compression if getattr(compression, "wire_spec", None)
                     is not None else None)
        out = _Allreduce.apply(t, average, name, prescale_factor,
                               postscale_factor, blockwise)
        return compression.decompress(out, ctx)
    return _Allreduce.apply(tensor, average, name, prescale_factor,
                            postscale_factor, None)


def allreduce_async_(tensor: torch.Tensor, average: bool = True,
                     name: Optional[str] = None,
                     compression=None) -> Handle:
    """In place: the result lands in ``tensor``, which is the handle's
    result."""
    return engine().enqueue(ALLREDUCE, [tensor], [name], average=average,
                            wires=[_wire_for(tensor, compression)],
                            inplace=True)[0]


def allreduce_(tensor: torch.Tensor, average: bool = True,
               name: Optional[str] = None) -> torch.Tensor:
    """In-place synchronous allreduce; returns ``tensor``."""
    return allreduce_async_(tensor, average, name).wait()


def _fused_allreduce(tensors, average, name, names, compression,
                     inplace) -> GroupedHandle:
    eng = engine()
    if names is None:
        nm = name if name is not None else \
            f"allreduce.noname.{next(eng._counter)}"
        names = [f"{nm}.{i}" for i in range(len(tensors))]
    return GroupedHandle(eng.enqueue(
        ALLREDUCE, tensors, names, average=average,
        wires=[_wire_for(t, compression) for t in tensors], inplace=inplace))


def fused_allreduce_async(tensors: Sequence[torch.Tensor],
                          average: bool = True, name: Optional[str] = None,
                          names: Optional[Sequence[str]] = None,
                          compression=None) -> GroupedHandle:
    """Submit one allreduce per tensor, named ``names[i]`` or
    ``{name}.{i}``, at once: the engine drains them together and the
    planner fuses them (per dtype and wire, cut at
    ``HOROVOD_FUSION_THRESHOLD``). The handle's result is the list of
    reduced tensors in input order."""
    return _fused_allreduce(tensors, average, name, names, compression,
                            False)


def fused_allreduce_async_(tensors: Sequence[torch.Tensor],
                           average: bool = True, name: Optional[str] = None,
                           names: Optional[Sequence[str]] = None,
                           compression=None) -> GroupedHandle:
    """In-place :func:`fused_allreduce_async`: each result lands in its
    input tensor."""
    return _fused_allreduce(tensors, average, name, names, compression,
                            True)


def grouped_allreduce(tensors: Sequence[torch.Tensor], average: bool = True,
                      name: Optional[str] = None) -> List[torch.Tensor]:
    """Allreduce a list of tensors as one fused submission."""
    return fused_allreduce_async(tensors, average, name).wait()


def allgather_async(tensor: torch.Tensor,
                    name: Optional[str] = None) -> Handle:
    """Asynchronous concatenation along dim 0 of every rank's tensor;
    first dims may differ across ranks (the MPI_Allgatherv case)."""
    return engine().enqueue(ALLGATHER, [tensor], [name])[0]


def allgather(tensor: torch.Tensor, name: Optional[str] = None):
    """Synchronous, differentiable allgather along dim 0."""
    return _Allgather.apply(tensor, name)


def _broadcast_async(tensor, root_rank, name, inplace) -> Handle:
    n = _topo.size()
    if not (0 <= root_rank < n):
        raise ValueError(
            f"Invalid root_rank {root_rank}: root rank must be in [0, {n})")
    return engine().enqueue(BROADCAST, [tensor], [name],
                            root_rank=root_rank, inplace=inplace)[0]


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None) -> Handle:
    """Asynchronous copy of ``root_rank``'s tensor to every rank."""
    return _broadcast_async(tensor, root_rank, name, False)


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None):
    """Synchronous, differentiable broadcast from ``root_rank``."""
    return _Broadcast.apply(tensor, root_rank, name)


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None) -> Handle:
    """In place: ``root_rank``'s tensor lands in ``tensor``, which is the
    handle's result."""
    return _broadcast_async(tensor, root_rank, name, True)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None) -> torch.Tensor:
    return broadcast_async_(tensor, root_rank, name).wait()


def poll(handle) -> bool:
    """True iff the op behind ``handle`` finished."""
    return handle.poll()


def synchronize(handle, timeout: Optional[float] = None):
    """Wait for ``handle`` and return its output; ``TimeoutError`` after
    ``timeout`` seconds."""
    return handle.wait(timeout)


def synchronize_many(handles: Sequence[Handle],
                     timeout: Optional[float] = None) -> List[torch.Tensor]:
    """Wait for every handle (``timeout`` in all) and return their
    outputs; the caller's stream waits once per group."""
    return _wait_all(list(handles), timeout)
