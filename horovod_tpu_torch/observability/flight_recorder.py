"""Black-box flight recorder: the post-mortem half of the telemetry plane.

Counterpart of ``horovod_tpu/observability/flight_recorder.py``,
copied, so that ``python -m horovod_tpu.tools.postmortem`` reads a port
process's dumps as it reads the JAX package's. An always-on, bounded
ring of structured events per process is dumped to
``<HOROVOD_TPU_BLACKBOX>/blackbox-rank{rank}.jsonl`` on the exits that
matter: an uncaught exception, SIGTERM, an injected crash, and every
``HOROVOD_TPU_BLACKBOX_INTERVAL`` seconds while alive (a SIGKILLed
process leaves its last snapshot).

  - :meth:`FlightRecorder.note` is one flag check, one tuple and one
    ``deque.append``; formatting happens at dump time.
  - Events are (monotonic_ts, kind, payload-tuple); ``_FIELDS`` names
    each kind's fields, so the dump is self-describing JSONL.
  - The dump writes its header first and flushes each line: a process
    killed mid-dump leaves a valid prefix.
  - The header carries the clock fields (``offset_to_rank0_us``), so
    the postmortem tool aligns ranks on rank 0's clock.

The port records every kind below but ``coord_error`` (the port's
rounds have no TCP client to give up) and ``elastic`` (neither
package's driver writes it): the engine's group events, the step
timer's, the policy's ``adapt`` moves, the wire epochs, failure events,
the loader's ``data``, the checkpoint notes and the numerics plane's
``numerics`` evidence beside ``init``, ``fault``, ``serving``,
``request``, ``serving_replica``, ``alert`` and ``autotune``.

Event kinds (payload fields):

  ================  ========================================================
  ``init``          rank, world, generation — recorded at init()
  ``group_deliver`` seq, op, n — fused group agreed/delivered
  ``group_done``    seq, op, n, queue_ms, exec_ms — fused group executed
  ``group_error``   seq, op, n, error
  ``step``          idx — StepTimer step began
  ``step_end``      idx, step_ms, input_ms, h2d_ms, compute_ms, comm_ms
  ``wire_epoch``    epochs — adaptation wire-override list applied
  ``adapt``         action, tier, name, rank, lateness_ms — ladder moves
  ``failure``       rank, kind, detail — coordinator failure event seen
  ``fault``         kind, tick — injected fault fired
  ``checkpoint``    action, step, backend — commit/restore
  ``elastic``       event, generation, world — driver transitions
  ``coord_error``   detail — coordinator client gave up (typed error)
  ``stall``         names, age_s — engine stall escalation
  ``serving``       event, active — serving drain began/finished
  ``request``       event, trace, detail — serving request lifecycle:
                    admit/first_token/evict/finish keyed by the
                    request's trace id (docs/serving.md#request-tracing;
                    the postmortem names the in-flight requests and
                    their phase when a replica dies)
  ``serving_replica`` event, replica, detail — fleet supervisor
                    lifecycle: spawn/ready/crash/restart/drain/exit
  ``pipeline``      schedule, stages, microbatches, virtual, warmup,
                    steady, drain, bubble_share — pipeline program built
  ``data``          event, epoch, offset, detail — input-pipeline
                    lifecycle: epoch boundaries, cursor commits, resume
                    (docs/data.md; the postmortem surfaces the last
                    committed cursor per rank)
  ``alert``         alert, severity, series, who, value, baseline —
                    health-detector alert fired (docs/health.md; the
                    dump shows what the anomaly plane saw before a
                    death)
  ``numerics``      event, step, who, value, detail — numerics-plane
                    evidence (docs/numerics.md): ``nonfinite`` (who =
                    producing rank, value = element count, detail =
                    source) and ``divergence`` (who = divergent rank,
                    detail = leaf) — the postmortem names the first
                    nonfinite step/rank and the divergence chain from
                    these
  ================  ========================================================
"""

from __future__ import annotations

import collections
import json
import logging
import os
import signal
import sys
import threading
import time
from typing import Optional, Tuple

from ..utils import env as _env

_log = logging.getLogger(__name__)

# Payload field names per event kind (dump-time schema; note() only ever
# builds a tuple).
_FIELDS = {
    "init": ("rank", "world", "generation"),
    "group_deliver": ("seq", "op", "n"),
    "group_done": ("seq", "op", "n", "queue_ms", "exec_ms"),
    "group_error": ("seq", "op", "n", "error"),
    "step": ("idx",),
    "step_end": ("idx", "step_ms", "input_ms", "h2d_ms", "compute_ms",
                 "comm_ms"),
    "wire_epoch": ("epochs",),
    "adapt": ("action", "tier", "name", "rank", "lateness_ms"),
    # NB: payload field names must not collide with the event's own
    # "kind"/"t_us" keys — the dump merges them into one JSON object.
    "failure": ("rank", "failure_kind", "detail"),
    "fault": ("fault", "tick"),
    "checkpoint": ("action", "step", "backend"),
    "elastic": ("event", "generation", "world"),
    "coord_error": ("detail",),
    "stall": ("names", "age_s"),
    "serving": ("event", "active"),
    "request": ("event", "trace", "detail"),
    "serving_replica": ("event", "replica", "detail"),
    "pipeline": ("schedule", "stages", "microbatches", "virtual",
                 "warmup", "steady", "drain", "bubble_share"),
    "data": ("event", "epoch", "offset", "detail"),
    "alert": ("alert", "severity", "series", "who", "value", "baseline"),
    "autotune": ("event", "knob", "value", "score", "baseline", "detail"),
    "numerics": ("event", "step", "who", "value", "detail"),
}

# Recording lever — module-global single check like registry._enabled.
# Always on by default (the point of a flight recorder); the overhead
# bench toggles it for the A/B.
_enabled = True


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> None:
    global _enabled
    _enabled = bool(value)


class FlightRecorder:
    """Bounded per-process ring of structured events + the dump path."""

    def __init__(self, capacity: Optional[int] = None):
        self._ring = collections.deque(
            maxlen=capacity or _env.blackbox_capacity())
        self.rank = -1
        self.world = 0
        self.generation = 0
        self.clock = {"offset_to_rank0_us": 0.0, "rtt_us": 0.0,
                      "clock_synced": False}
        self._dump_lock = threading.Lock()
        self.last_dump_path: Optional[str] = None
        self.last_dump_reason: Optional[str] = None

    # ------------------------------------------------------------ record

    def note(self, kind: str, payload: Tuple = ()) -> None:
        """Append one event. HOT PATH: enabled check + tuple + append;
        the payload must already be a tuple of json-safe scalars (the
        convenience wrappers below build them)."""
        if not _enabled:
            return
        self._ring.append((time.monotonic(), kind, payload))

    # Convenience wrappers for the engine's dispatch loops — kept thin
    # so the call sites stay one line.

    def group_deliver(self, seq, op: str, n: int) -> None:
        if not _enabled:
            return
        self._ring.append((time.monotonic(), "group_deliver",
                           (seq, op, n)))

    def group_done(self, seq, op: str, n: int, t_deliver: float,
                   t_start: float, t_end: float) -> None:
        if not _enabled:
            return
        self._ring.append((t_end, "group_done",
                           (seq, op, n,
                            round((t_start - t_deliver) * 1e3, 3),
                            round((t_end - t_start) * 1e3, 3))))

    def group_error(self, seq, op: str, n: int, error: str) -> None:
        if not _enabled:
            return
        self._ring.append((time.monotonic(), "group_error",
                           (seq, op, n, str(error)[:500])))

    # ---------------------------------------------------------- identity

    def configure(self, rank: int, world: int, generation: int = 0
                  ) -> None:
        self.rank = int(rank)
        self.world = int(world)
        self.generation = int(generation)

    def set_clock_meta(self, offset_s: float, rtt_s: float,
                       synced: bool) -> None:
        """Record the control-plane clock handshake result (the
        ``offset_to_rank0_us``/``rtt_us``/``clock_synced`` header
        fields) for the dump header — same sign convention as the
        trace sidecar: positive offset means rank 0's monotonic clock
        reads ahead of ours."""
        self.clock = {"offset_to_rank0_us": float(offset_s) * 1e6,
                      "rtt_us": float(rtt_s) * 1e6,
                      "clock_synced": bool(synced)}

    # -------------------------------------------------------------- dump

    def _snapshot(self):
        """Copy the ring without a hot-path lock: deque appends are
        thread-safe; a concurrent append during list() raises
        RuntimeError, so retry a few times (dump happens at death —
        losing the race forever would mean the process is still healthy,
        which contradicts dumping)."""
        for _ in range(5):
            try:
                return list(self._ring)
            except RuntimeError:
                time.sleep(0.001)
        return list(self._ring)  # last try, let it raise

    def dump(self, reason: str, exc: Optional[BaseException] = None,
             directory: Optional[str] = None,
             window_s: Optional[float] = None) -> Optional[str]:
        """Write the last ``window_s`` seconds of events to
        ``<dir>/blackbox-rank{rank}.jsonl``. Returns the path, or None
        when no directory is configured. Header first + per-line flush:
        a kill mid-dump leaves a valid prefix. Safe to call more than
        once (later dumps overwrite — the freshest evidence wins)."""
        directory = directory or _env.blackbox_dir()
        if not directory:
            return None
        window_s = window_s if window_s is not None \
            else _env.blackbox_window_secs()
        now_mono = time.monotonic()
        events = [e for e in self._snapshot()
                  if now_mono - e[0] <= window_s]
        rank = self.rank if self.rank >= 0 else int(
            os.environ.get("HOROVOD_TPU_PROCESS_ID", "0") or 0)
        path = os.path.join(directory, f"blackbox-rank{rank}.jsonl")
        with self._dump_lock:
            try:
                os.makedirs(directory, exist_ok=True)
                with open(path, "w") as f:
                    header = {
                        "blackbox": 1,
                        "rank": rank,
                        "world": self.world,
                        "generation": self.generation,
                        "reason": reason,
                        "error": (f"{type(exc).__name__}: {exc}"[:2000]
                                  if exc is not None else None),
                        "time_unix": time.time(),
                        "mono_us": int(now_mono * 1e6),
                        "window_s": window_s,
                        "events": len(events),
                        **self.clock,
                    }
                    f.write(json.dumps(header) + "\n")
                    f.flush()
                    for ts, kind, payload in events:
                        fields = _FIELDS.get(kind)
                        if fields is not None and len(fields) == len(payload):
                            data = dict(zip(fields, payload))
                        elif isinstance(payload, dict):
                            data = payload
                        else:
                            data = {"payload": list(payload)}
                        f.write(json.dumps(
                            {"t_us": int(ts * 1e6), "kind": kind,
                             **data}, default=str) + "\n")
                        f.flush()
                    os.fsync(f.fileno())
            except OSError as e:  # never fail the death path over telemetry
                _log.warning("blackbox dump failed: %s", e)
                return None
        self.last_dump_path = path
        self.last_dump_reason = reason
        from . import registry as _reg
        _reg.registry().counter(
            "hvdtpu_blackbox_dumps_total",
            "Flight-recorder dumps written, by trigger reason"
        ).labels(reason=reason).inc()
        if reason != "inflight":   # the periodic writer would spam
            _log.warning("flight recorder dumped %d events to %s "
                         "(reason: %s)", len(events), path, reason)
        return path


_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    """The process-global flight recorder (always recording)."""
    return _recorder


def reset() -> None:
    """Test hook: fresh ring + identity (mirrors reset_engine())."""
    global _recorder
    _recorder = FlightRecorder()


_final_flush_hooks: list = []


def register_final_flush(fn) -> None:
    """Register a best-effort flush callback to run on every final-gasp
    path (:func:`dump_on`) alongside the recorder dump and the metrics
    flush. Used by writers whose buffered tail would otherwise die with
    the process — the serving request-trace writer registers its
    close() here so an injected SIGKILL leaves a complete trace.
    Idempotent per callable."""
    if fn not in _final_flush_hooks:
        _final_flush_hooks.append(fn)


def dump_on(reason: str, exc: Optional[BaseException] = None) -> None:
    """Final gasp, shared by every abnormal-exit path (excepthook,
    SIGTERM, stall escalation, worker-harness exception, injected
    crash): dump the flight recorder AND flush the last metrics
    snapshot, so neither HOROVOD_TPU_BLACKBOX nor
    HOROVOD_TPU_METRICS_FILE is ever stale-at-death. Best-effort —
    never raises."""
    try:
        _recorder.dump(reason, exc=exc)
    except Exception as e:  # pragma: no cover - defensive
        _log.warning("blackbox dump failed: %s", e)
    try:
        from . import export as _export
        _export.final_metrics_flush()
    except Exception as e:  # pragma: no cover - defensive
        _log.warning("final metrics flush failed: %s", e)
    for fn in list(_final_flush_hooks):
        try:
            fn()
        except Exception as e:  # pragma: no cover - defensive
            _log.warning("final flush hook failed: %s", e)


# ---------------------------------------------------------------------------
# Crash hooks + the periodic (continuous) dumper
# ---------------------------------------------------------------------------

_hooks_installed = False
_periodic_thread: Optional[threading.Thread] = None


def _periodic_loop(interval_s: float) -> None:
    """Continuous persistence, the actual black-box design: some death
    paths leave NO exit window at all — the JAX coordination service
    LOG(FATAL)s surviving clients within ~100 ms of a peer's death, and
    a SIGKILL is un-hookable by definition — so the ring is rewritten
    to disk every ``interval_s`` with reason ``inflight``. A real
    death-path dump later overwrites it with the precise reason; a
    hard-killed rank leaves its last in-flight snapshot as evidence."""
    while True:
        time.sleep(interval_s)
        rec = _recorder
        if rec.last_dump_reason not in (None, "inflight"):
            return   # a terminal dump happened; stop overwriting it
        try:
            rec.dump("inflight")
        except Exception:  # pragma: no cover - defensive
            pass


def maybe_install_hooks() -> None:
    """Install the crash machinery once (called by ``init()`` and by
    the serving replica and supervisor):
    chain ``sys.excepthook`` and the SIGTERM handler so an uncaught
    exception or a termination signal dumps the recorder and flushes
    the metrics file before the process dies, and start the periodic
    in-flight dumper (see :func:`_periodic_loop`). Only armed when a
    blackbox directory or a metrics file is configured — otherwise
    there is nothing to write and the process's signal semantics stay
    untouched."""
    global _hooks_installed, _periodic_thread
    if _hooks_installed:
        return
    if not (_env.blackbox_dir() or _env.metrics_file()
            or _env.history_dir()):
        # history_dir counts: its sampler registers a final-gasp flush
        # (the last window before a death must reach the history file).
        return
    _hooks_installed = True

    interval = _env.blackbox_interval_secs()
    if _env.blackbox_dir() and interval > 0:
        _periodic_thread = threading.Thread(
            target=_periodic_loop, args=(interval,),
            name="hvd-tpu-blackbox", daemon=True)
        _periodic_thread.start()

    prev_excepthook = sys.excepthook

    def _excepthook(exc_type, exc, tb):
        dump_on("exception", exc=exc)
        prev_excepthook(exc_type, exc, tb)

    sys.excepthook = _excepthook

    try:
        prev_sigterm = signal.getsignal(signal.SIGTERM)

        def _on_sigterm(signum, frame):
            dump_on("sigterm")
            if callable(prev_sigterm):
                prev_sigterm(signum, frame)
            else:
                # Restore default disposition and re-deliver, so the
                # exit status still says "killed by SIGTERM".
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):  # pragma: no cover - non-main thread
        pass

    # Clean-exit dump: without it, a healthy run's file would keep the
    # last "inflight" snapshot and read like a death. Skipped when a
    # terminal dump (exception/sigterm/...) already told the real story.
    import atexit

    def _atexit_dump():
        if _recorder.last_dump_reason in (None, "inflight"):
            dump_on("exit")

    atexit.register(_atexit_dump)
