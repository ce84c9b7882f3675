"""One shared timer thread for every periodic telemetry task.

Counterpart of ``horovod_tpu/observability/ticker.py``, copied: one
process-global scheduler thread (``hvd-tpu-torch-telemetry``) runs the
JSON metrics writer (``export.py``) and the history samplers
(``history.py``), each at its own interval, however many are armed.

  - Callbacks run on the shared thread: they must be quick and never
    raise; an exception is caught and logged so one broken exporter
    cannot starve the rest.
  - The thread sleeps until the earliest deadline; a task that overruns
    delays its next tick (and the others').
  - ``remove()`` runs the task's optional ``final`` callback (the
    exporters' flush on stop) and is idempotent.
  - The thread starts on the first ``add`` and parks while no task is
    scheduled: importing this module costs nothing.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

_log = logging.getLogger(__name__)

# Not JAX's "hvd-tpu-telemetry": a process that imports both packages
# (the parity tests) runs both tickers, and each package counts its own.
THREAD_NAME = "hvd-tpu-torch-telemetry"


class _Task:
    __slots__ = ("name", "interval_s", "fn", "final", "next_at")

    def __init__(self, name: str, interval_s: float, fn: Callable[[], None],
                 final: Optional[Callable[[], None]]):
        self.name = name
        self.interval_s = max(0.05, float(interval_s))
        self.fn = fn
        self.final = final
        self.next_at = time.monotonic() + self.interval_s


class Ticker:
    """The shared periodic-task scheduler (one per process via
    :func:`ticker`; instantiable directly for tests)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._tasks: Dict[int, _Task] = {}
        self._next_id = 0
        self._thread: Optional[threading.Thread] = None
        self._stopping = False

    def add(self, name: str, interval_s: float, fn: Callable[[], None],
            final: Optional[Callable[[], None]] = None) -> int:
        """Register ``fn`` to run every ``interval_s`` seconds on the
        shared thread; returns a handle for :meth:`remove`. ``final``
        (optional) runs once at removal — the flush-on-stop hook."""
        with self._lock:
            self._next_id += 1
            handle = self._next_id
            self._tasks[handle] = _Task(name, interval_s, fn, final)
            if self._thread is None or not self._thread.is_alive():
                self._stopping = False
                self._thread = threading.Thread(
                    target=self._loop, name=THREAD_NAME, daemon=True)
                self._thread.start()
        self._wake.set()
        return handle

    def remove(self, handle: int) -> None:
        """Unregister; runs the task's ``final`` callback (on the
        caller's thread — remove-at-exit must flush even when the
        scheduler thread is already torn down). Idempotent."""
        with self._lock:
            task = self._tasks.pop(handle, None)
        self._wake.set()
        if task is not None and task.final is not None:
            try:
                task.final()
            except Exception as e:  # never fail teardown over telemetry
                _log.warning("final flush of %s failed: %s", task.name, e)

    def tasks(self) -> Dict[int, str]:
        """Live task names by handle (tests / diagnostics)."""
        with self._lock:
            return {h: t.name for h, t in self._tasks.items()}

    def stop(self) -> None:
        """Tear down: run every final callback and stop the thread."""
        with self._lock:
            handles = list(self._tasks)
        for h in handles:
            self.remove(h)
        with self._lock:
            self._stopping = True
            thread = self._thread
            self._thread = None
        self._wake.set()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)

    # --------------------------------------------------------------- loop

    def _loop(self) -> None:
        while True:
            with self._lock:
                if self._stopping:
                    return
                now = time.monotonic()
                due = [t for t in self._tasks.values() if t.next_at <= now]
                for t in due:
                    # Fixed cadence from now — an overrunning task skips
                    # ticks instead of bursting to catch up.
                    t.next_at = now + t.interval_s
                nxt = min((t.next_at for t in self._tasks.values()),
                          default=None)
            for t in due:
                try:
                    t.fn()
                except Exception as e:  # one bad exporter != all dead
                    _log.warning("telemetry task %s failed: %s", t.name, e)
            if nxt is None:
                # No tasks: park until add() wakes us (lazy thread that
                # never spins on an empty schedule).
                self._wake.wait()
            else:
                self._wake.wait(timeout=max(0.0, nxt - time.monotonic()))
            self._wake.clear()


_ticker = Ticker()


def ticker() -> Ticker:
    """The process-global telemetry scheduler — ONE timer thread shared
    by every periodic exporter (JSON writer, history sampler)."""
    return _ticker
