"""The engine's Chrome-trace timeline (``HOROVOD_TIMELINE``).

The port's own copy of ``horovod_tpu/ops/timeline_py.py``: catapult JSON
with one "process" per tensor (pid = interned tensor index) and the
reference's phase vocabulary (``NEGOTIATE_<OP>`` spans, then the op's
activity, ``NCCL_ALLREDUCE`` or ``GLOO_ALLREDUCE`` as reference Horovod
names them, where the JAX engine writes ``XLA_*``), so
``chrome://tracing`` renders both packages' traces alike.

A writer thread drains a deque, so the engine's thread never blocks on
file IO: it appends raw tuples and the drain thread formats them every
``DRAIN_POLL_S``. ``close`` (also registered with ``atexit``, so a rank
that exits without ``shutdown`` still terminates the JSON array) drains
everything left.

Every file carries clock metadata (the ``horovod_tpu_trace_meta``
event: the writer's monotonic start and the rank's offset to rank 0),
and the engine writes the same fields to a sidecar beside the trace
(:func:`write_clock_sidecar`), so that per-rank files (a ``{rank}``
placeholder in the path) can be merged onto one clock.
"""

from __future__ import annotations

import atexit
import collections
import json
import threading
import time
from typing import Optional

# Trace-metadata event name, the same as the JAX package's traces carry.
TRACE_META_EVENT = "horovod_tpu_trace_meta"


def clock_sidecar_path(trace_path: str) -> str:
    """Path of the clock-metadata sidecar written next to a per-rank
    trace (the JAX package's convention: its native writer cannot carry
    the clock in-band, so a merge tool reads the sidecar)."""
    return trace_path + ".clock.json"


def write_clock_sidecar(trace_path: str, meta: dict) -> None:
    with open(clock_sidecar_path(trace_path), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")


class PyTimeline:
    """Chrome-trace writer with the reference's phase vocabulary."""

    def __init__(self, path: str, rank: int = 0, world: int = 1,
                 proc: Optional[str] = None):
        self._path = path
        self._f = open(path, "w")
        self._f.write("[\n")
        self._start = time.monotonic()
        self.rank = rank
        self.world = world
        # A process name for writers that are not ranks (the serving
        # request traces' "replica1"), shown in place of "rank N".
        self.proc = proc
        self._pids = {}
        self._name_json = {}   # event name -> pre-escaped JSON string
        self._neg_cache = {}   # op name -> "NEGOTIATE_<OP>"
        self._queue = collections.deque()
        self._wake = threading.Event()
        self._stop = False
        self._first = True
        self._thread = threading.Thread(target=self._drain,
                                        name="hvd-tpu-timeline",
                                        daemon=True)
        self._thread.start()
        # Flush on exit (a rank that exits without shutdown): close()
        # drains the deque and terminates the JSON array. close() is
        # idempotent, so a later shutdown is a no-op.
        atexit.register(self.close)
        # Clock metadata header: written immediately with offset unknown;
        # set_clock_meta() re-emits it once the control-plane handshake
        # measured the offset to rank 0.
        self._emit_clock_meta(offset_us=0.0, rtt_us=0.0, synced=False)

    @property
    def start_monotonic_us(self) -> int:
        """This trace's epoch on the local monotonic clock — event ts are
        microseconds since this instant."""
        return int(self._start * 1e6)

    def _emit_clock_meta(self, offset_us: float, rtt_us: float,
                         synced: bool) -> None:
        args = {"rank": self.rank, "world": self.world,
                "start_mono_us": self.start_monotonic_us,
                "offset_to_rank0_us": float(offset_us),
                "rtt_us": float(rtt_us),
                "clock_synced": bool(synced)}
        if self.proc is not None:
            args["proc"] = self.proc
        self._queue.append({
            "name": TRACE_META_EVENT, "ph": "M", "pid": 0, "tid": 0,
            "args": args})
        self._wake.set()

    def set_clock_meta(self, offset_s: float, rtt_s: float) -> None:
        """Record the measured offset-to-rank-0 (seconds; positive means
        rank 0's monotonic clock reads ahead of ours) from the NTP-style
        control-plane handshake. The merge tool uses the LAST meta event
        in the file, so re-emitting supersedes the unsynced header."""
        self._emit_clock_meta(offset_us=offset_s * 1e6,
                              rtt_us=rtt_s * 1e6, synced=True)

    # ------------------------------------------------------------- events

    def _ts(self) -> int:
        return int((time.monotonic() - self._start) * 1e6)

    def _pid(self, tensor: str) -> int:
        pid = self._pids.get(tensor)
        if pid is None:
            pid = len(self._pids)
            self._pids[tensor] = pid
            self._queue.append({"name": "process_name", "ph": "M",
                                "pid": pid,
                                "args": {"name": tensor}})
        return pid

    def _emit(self, tensor: str, ph: str, name: Optional[str] = None,
              args: Optional[dict] = None, scope: Optional[str] = None):
        # The emitting thread is the engine's, on the step's critical
        # path: append the raw fields only; the drain thread builds the
        # JSON.
        self._queue.append((ph, self._ts(), self._pid(tensor), name,
                            args, scope))
        # No wake: the drain thread polls every DRAIN_POLL_S, so an
        # event never invites a context switch; close() drains the rest.

    # Phase API (begin/end pairs). These append raw tuples directly,
    # with cached phase names; the drain thread does all formatting.

    def negotiate_start(self, tensor: str, op_name: str):
        nm = self._neg_cache.get(op_name)
        if nm is None:
            nm = self._neg_cache[op_name] = "NEGOTIATE_" + op_name.upper()
        self._queue.append(("B", self._ts(), self._pid(tensor), nm,
                            None, None))

    def negotiate_end(self, tensor: str, group: Optional[int] = None):
        # The group's sequence number, the same on every rank for the
        # same fused collective, as a raw tagged value.
        self._queue.append(
            ("E", self._ts(), self._pid(tensor), None,
             ("group", int(group)) if group is not None else None, None))

    # Complete spans ("X" events): the engine holds both ends of every
    # phase (enqueue, delivery of the plan, execution's start and end on
    # its monotonic clock), so one event carries what a B/E pair would,
    # and nothing is emitted from the submitting thread. A tensor stuck
    # in a phase has no open span: the stall inspector reports it.

    def negotiate_span(self, tensor: str, op_name: str, t0: float,
                       t1: float, group: Optional[int] = None):
        """One NEGOTIATE_<OP> complete span from monotonic seconds
        ``t0`` (enqueue) to ``t1`` (group delivery)."""
        nm = self._neg_cache.get(op_name)
        if nm is None:
            nm = self._neg_cache[op_name] = "NEGOTIATE_" + op_name.upper()
        self._queue.append(
            ("X", int((t0 - self._start) * 1e6), self._pid(tensor), nm,
             ("group", int(group)) if group is not None else None,
             max(0, int((t1 - t0) * 1e6))))

    def execute_span(self, tensor: str, activity: str, t0: float,
                     t1: float, shape=None):
        """One complete span of the op's ``activity`` (``NCCL_ALLREDUCE``,
        ``GLOO_ALLGATHER``, ...) over the fused group's execution."""
        args = (("shape", tuple(int(d) for d in shape))
                if shape is not None else None)
        self._queue.append(
            ("X", int((t0 - self._start) * 1e6), self._pid(tensor),
             activity, args, max(0, int((t1 - t0) * 1e6))))

    def request_span(self, row: str, name: str, t0: float, t1: float,
                     args: Optional[dict] = None):
        """One complete span on a named row: the serving request traces'
        emitter (``serving/reqtrace.py``). ``row`` is the request's trace
        id (each request is a process row, as a tensor is in the
        engine's trace), ``t0``/``t1`` monotonic seconds, ``args`` a
        small dict formatted on the drain thread."""
        self._queue.append(
            ("X", int((t0 - self._start) * 1e6), self._pid(row), name,
             args, max(0, int((t1 - t0) * 1e6))))

    def mark_cycle(self):
        # A global ("s": "g") instant: drawn across the whole trace, as a
        # cycle boundary is (Trace Event Format, Instant Events).
        self._emit("_cycles", "i", "CYCLE_START", scope="g")

    # ------------------------------------------------------------- writer

    # Drain cadence: hundreds of events a write, and a SIGKILL loses at
    # most this much of the trace.
    DRAIN_POLL_S = 0.05

    def _drain(self):
        # Events are formatted here, names and args through (cached)
        # json.dumps for escaping; one write and flush per poll.
        dumps = json.dumps
        name_json = self._name_json
        while True:
            self._wake.wait(timeout=self.DRAIN_POLL_S)
            self._wake.clear()
            parts = []
            while self._queue:
                item = self._queue.popleft()
                if isinstance(item, dict):   # metadata events
                    parts.append(dumps(item))
                    continue
                # extra = dur for "X" complete events, scope for "i"
                # instants, None otherwise.
                ph, ts, pid, name, args, extra = item
                s = f'{{"ph":"{ph}","ts":{ts},"pid":{pid},"tid":0'
                if name is not None:
                    e = name_json.get(name)
                    if e is None:
                        e = name_json[name] = dumps(name)
                    s += f',"name":{e}'
                if args is not None:
                    # ("group", int) / ("shape", (ints,)) fast paths —
                    # integer-only payloads need no escaping; anything
                    # else goes through json.dumps.
                    if type(args) is tuple:
                        k, v = args
                        if k == "shape":
                            v = f'[{",".join(map(str, v))}]'
                        s += f',"args":{{"{k}":{v}}}'
                    else:
                        s += f',"args":{dumps(args)}'
                if extra is not None:
                    if ph == "X":
                        s += f',"dur":{extra}'
                    else:
                        s += f',"s":"{extra}"'
                parts.append(s + "}")
            if parts:
                prefix = "" if self._first else ",\n"
                self._first = False
                self._f.write(prefix + ",\n".join(parts))
                self._f.flush()
            if self._stop and not self._queue:
                return

    def close(self):
        try:
            atexit.unregister(self.close)
        except Exception:  # pragma: no cover - interpreter teardown
            pass
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            # The drain thread is stuck in a slow write: closing under it
            # would interleave the footer with its writes. Leave the file
            # open; trace viewers tolerate a missing ']'.
            return
        try:
            self._f.write("\n]\n")
            self._f.close()
        except ValueError:
            pass  # already closed
