"""Subprocess execution with output forwarding and orphan watchdog.

Counterpart of ``horovod_tpu/runner/safe_exec.py``, copied.

Parity:
  - horovod/spark/util/safe_shell_exec.py (reference :1-148): run a command,
    stream its stdout/stderr to the parent, kill the whole process group on
    failure or parent exit.
  - horovod/spark/task/mpirun_exec_fn.py:26-31: the worker-side watchdog
    thread that exits when the parent process dies (re-parented to init).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import IO, Dict, List, Optional


def _forward(stream: IO[bytes], sink, prefix: str = "") -> threading.Thread:
    def pump():
        try:
            for raw in iter(stream.readline, b""):
                line = raw.decode("utf-8", "replace")
                sink.write(f"{prefix}{line}" if prefix else line)
                sink.flush()
        except ValueError:
            pass  # stream closed

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return t


class ManagedProcess:
    """A spawned worker whose output is streamed with a rank prefix
    (``[rank]<stdout>:`` — the convention mpirun's ``-tag-output`` uses)."""

    def __init__(self, args: List[str], env: Dict[str, str],
                 prefix: Optional[str] = None,
                 stdout=None, stderr=None,
                 stdin_data: Optional[bytes] = None):
        self.args = args
        self.proc = subprocess.Popen(
            args, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            stdin=subprocess.PIPE if stdin_data is not None else None,
            start_new_session=True)
        if stdin_data is not None:
            # Hand secrets/config to the child over stdin, never argv
            # (argv is world-readable via ps).
            def feed():
                try:
                    self.proc.stdin.write(stdin_data)
                    self.proc.stdin.close()
                except (BrokenPipeError, OSError):
                    pass
            threading.Thread(target=feed, daemon=True).start()
        out_sink = stdout if stdout is not None else sys.stdout
        err_sink = stderr if stderr is not None else sys.stderr
        p_out = f"{prefix}<stdout>:" if prefix else ""
        p_err = f"{prefix}<stderr>:" if prefix else ""
        self._pumps = [
            _forward(self.proc.stdout, out_sink, p_out),
            _forward(self.proc.stderr, err_sink, p_err),
        ]

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def wait(self, timeout: Optional[float] = None) -> int:
        rc = self.proc.wait(timeout)
        for t in self._pumps:
            t.join(timeout=2.0)
        return rc

    def terminate(self) -> None:
        """Kill the worker's whole process group (safe_shell_exec kills the
        session it created, reference :60-90)."""
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
            try:
                self.proc.wait(timeout=3.0)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(self.proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass


def start_parent_watchdog(parent_pid: Optional[int] = None,
                          interval: float = 1.0) -> threading.Thread:
    """Exit this process when its launcher dies (mpirun_exec_fn.py:26-31)."""
    ppid = parent_pid if parent_pid is not None else os.getppid()

    def watch():
        while True:
            time.sleep(interval)
            # Re-parented to init/reaper ⇒ launcher is gone.
            if os.getppid() != ppid:
                os._exit(1)

    t = threading.Thread(target=watch, daemon=True, name="parent-watchdog")
    t.start()
    return t
