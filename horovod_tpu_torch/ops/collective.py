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
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import logging
import threading
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from .. import executor as _exec
from .. import quantization as _quant
from .. import topology as _topo
from ..utils import env as _env
from .control_plane import (ALLGATHER, ALLREDUCE, BROADCAST, OP_NAMES,
                            Coordinator, Group, Meta, dtype_name)

_log = logging.getLogger(__name__)

# The longest an idle rank stays out of the negotiation rounds: it bounds
# how long a rank's shutdown, or an op only some ranks have submitted,
# waits for the idle ranks to join a round.
IDLE_CYCLE_S = 0.1


class HorovodInternalError(RuntimeError):
    pass


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


class Handle:
    """An async op, set once by the engine with a result or an error
    (``_state``: result, error, :class:`_Done` or None). ``group`` names
    the requests it was fused with. Waiters sleep on the engine's
    condition, which the engine notifies once per group."""

    __slots__ = ("name", "group", "_cv", "_state")

    def __init__(self, name: str, cv: threading.Condition):
        self.name = name
        self.group: tuple = ()
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
    __slots__ = ("meta", "tensor", "handle", "ready", "target")

    def __init__(self, meta: Meta, tensor: torch.Tensor, handle: Handle,
                 ready, target: Optional[torch.Tensor] = None):
        self.meta, self.tensor, self.handle, self.ready = (meta, tensor,
                                                           handle, ready)
        self.target = target    # an in-place op's input, else None


class CollectiveEngine:
    """The background thread of one process: negotiate, plan, execute."""

    def __init__(self, topo: _topo.Topology):
        self.size, self.rank = topo.size, topo.rank
        self.device = topo.device
        self._ctrl = topo.control_group
        self._ordered_sum = topo.size > 1 and topo.backend == "gloo"
        self._coord = Coordinator(topo.size)
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
        self.groups_executed = 0
        self.rounds = 0                 # negotiation rounds run
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
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            for r in reqs:
                r.ready = ready
        new = [r.meta.name for r in reqs]
        with self._lock:
            if self._closed:
                raise HorovodInternalError(
                    SHUT_DOWN_ERROR.format(op=OP_NAMES[op]))
            if len(set(new)) < len(new) or not self._names.isdisjoint(new):
                raise ValueError(DUPLICATE_NAME_ERROR.format(op=OP_NAMES[op]))
            self._names.update(new)
            self._queue.extend(reqs)
            self._arrived.set()
        return [r.handle for r in reqs]

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
        try:
            stopping = idle = False
            while not stopping:
                if idle:
                    self._arrived.wait(IDLE_CYCLE_S)
                self._wake.wait(_env.cycle_time_ms() / 1e3)
                self._wake.clear()
                with self._lock:
                    batch, self._queue = self._queue, []
                    self._arrived.clear()
                    for r in batch:
                        self._announced[r.meta.name] = r
                groups, stopping, idle = self._negotiate(
                    [r.meta for r in batch], self._stop,
                    _env.fusion_threshold_bytes())
                for g in groups:
                    self._execute(g)
        except Exception as e:   # the thread's boundary: fail every handle
            _log.exception("collective engine failed")
            error = HorovodInternalError(f"collective engine failed: {e}")
        self._close(error)

    def _negotiate(self, metas: List[Meta], stop: bool, threshold: int):
        """One round with rank 0: gather announcements, broadcast the
        ordered groups, whether any rank is stopping and whether the
        world is idle (no name awaits an announcement). At world size 1
        the round sends nothing."""
        self.rounds += 1
        got = [(stop, metas)]
        if self.size > 1:
            got = [None] * self.size if self.rank == 0 else None
            dist.gather_object((stop, metas), got, dst=0, group=self._ctrl)
        plan = [None]
        if self.rank == 0:
            plan[0] = (self._coord.cycle([m for _, m in got], threshold),
                       any(s for s, _ in got), self._coord.pending() == 0)
        if self.size > 1:
            dist.broadcast_object_list(plan, src=0, group=self._ctrl)
        return plan[0]

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
                 done: Optional[_Done] = None, group: tuple = ()) -> None:
        """Set every request's handle, then wake the waiters once."""
        with self._cv:
            for i, r in enumerate(reqs):
                r.handle.group = group
                r.handle._state = (None if outs is None else outs[i], error,
                                   done)
            self._cv.notify_all()

    # ----------------------------------------------------------- execution

    def _execute(self, g: Group) -> None:
        with self._lock:
            reqs = [self._announced.pop(n) for n in g.names]
            self._names.difference_update(g.names)
        if g.error:
            self._fulfill(reqs, error=HorovodInternalError(g.error))
            return
        try:
            ctx = (torch.cuda.stream(self._stream) if self._stream is not None
                   else contextlib.nullcontext())
            with ctx:
                done = None
                if self._stream is not None:
                    for ev in {id(r.ready): r.ready for r in reqs}.values():
                        self._stream.wait_event(ev)
                    for r in reqs:
                        r.tensor.record_stream(self._stream)
                outs = self._run_group(g, reqs)
                for i, r in enumerate(reqs):
                    if r.target is not None:
                        r.target.detach().copy_(outs[i])
                        outs[i] = r.target
                if self._stream is not None:
                    event = torch.cuda.Event()
                    event.record(self._stream)
                    # Results are views of a few buffers: one per dtype.
                    bases = {}
                    for o in outs:
                        b = o if o._base is None else o._base
                        bases[id(b)] = b
                    done = _Done(event, tuple(bases.values()))
        except Exception as e:
            self._fulfill(reqs, error=HorovodInternalError(
                f"{OP_NAMES[g.op]} of {g.names} failed: {e}"))
            return
        self.groups_executed += 1
        self._fulfill(reqs, outs, done=done, group=tuple(g.names))

    def _run_group(self, g: Group, reqs: List[_Request]):
        m = reqs[0].meta
        ts = [r.tensor for r in reqs]
        if g.op == ALLREDUCE:
            post = m.postscale / self.size if m.average else m.postscale
            return _exec.fused_allreduce(ts, self._sum, m.prescale, post,
                                         _quant.parse(m.wire), self.size,
                                         self._all_to_all, self._all_gather)
        if g.op == BROADCAST:
            return _exec.fused_broadcast(
                ts, lambda b: self._broadcast(b, m.root_rank))
        return _exec.fused_allgather(ts, [g.rows[n] for n in g.names],
                                     self._gather)

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


def allreduce(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None, compression=None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Synchronous allreduce. A cast ``compression`` moves the tensor on
    the wire in its dtype and restores the input dtype after; a
    blockwise one selects the quantized wire."""
    if compression is not None:
        t, ctx = compression.compress(tensor)
        out = allreduce_async(t, average, name, prescale_factor,
                              postscale_factor, compression).wait()
        return compression.decompress(out, ctx)
    return allreduce_async(tensor, average, name, prescale_factor,
                           postscale_factor).wait()


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
    return allgather_async(tensor, name).wait()


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
    return broadcast_async(tensor, root_rank, name).wait()


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
