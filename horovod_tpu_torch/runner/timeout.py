"""Deadline helper with a helpful message (a copy of
``horovod_tpu/runner/timeout.py``) — parity with
horovod/spark/util/timeout.py (the reference raises a descriptive exception
when registration does not complete in time, spark/__init__.py:112-114)."""

from __future__ import annotations

import time


class TimeoutException(RuntimeError):
    pass


class Timeout:
    def __init__(self, seconds: float, message: str):
        self._deadline = time.monotonic() + seconds
        self._message = message
        self._seconds = seconds

    def remaining(self) -> float:
        return max(0.0, self._deadline - time.monotonic())

    def timed_out(self) -> bool:
        return time.monotonic() > self._deadline

    def check(self) -> None:
        if self.timed_out():
            raise TimeoutException(
                self._message.format(timeout=self._seconds))
