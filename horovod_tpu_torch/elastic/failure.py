"""Typed worker-failure events and the driver-side failure detector.

Counterpart of ``horovod_tpu/elastic/failure.py``. A lost worker must
surface as a *typed event* that names who failed and why, early enough
to act on:

  - :class:`WorkerFailure` is the event type. It subclasses the port's
    ``HorovodInternalError`` so existing ``except`` clauses keep
    working, but carries structured ``rank``/``host``/``kind``/
    ``detail`` fields an elastic driver dispatches on (which host to
    penalize, whether to shrink or abort).
  - :class:`FailureConfig` holds the escalation knobs — detection
    timeout, restart budget, backoff schedule, host blacklist window.
  - :class:`FailureDetector` is the driver-side monitor: it polls a
    launched job's workers and raises ``WorkerFailure`` for the first
    dead one (a SIGKILLed worker reports a negative returncode within
    one poll interval).

Worker-side escalation is the collective engine's: its stall inspector
fails an op in flight past ``HOROVOD_TPU_FAILURE_TIMEOUT`` with
``WorkerFailure(kind="stall")`` (``ops/collective.py``); at 0, the
default, it only warns.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from ..ops.collective import HorovodInternalError


class WorkerFailure(HorovodInternalError):
    """A worker was lost (process death, heartbeat loss, or a stall past
    the failure timeout). ``rank``/``host`` are -1/None when the failing
    party cannot be attributed (e.g. a stall names missing ranks in
    ``detail`` instead)."""

    def __init__(self, rank: int = -1, host: Optional[str] = None,
                 kind: str = "exit", detail: str = ""):
        self.rank = int(rank)
        self.host = host
        self.kind = kind
        self.detail = detail
        self.timestamp = time.time()
        where = f"rank {rank}" + (f" on {host}" if host else "")
        super().__init__(
            f"worker failure ({kind}): {where}"
            + (f" — {detail}" if detail else ""))

    def __reduce__(self):  # exceptions with kw-ish init need explicit pickle
        return (type(self), (self.rank, self.host, self.kind,
                             self.detail))


class SlowRankFailure(WorkerFailure):
    """A rank evicted for being alive but persistently too late for
    every fused collective. An elastic driver dispatches on the type:
    the host gets the SHORT slow-rank blacklist window and a readmission
    probe instead of the crash blacklist, because a slow host (thermal
    throttle, noisy neighbor, flaky NIC) often recovers."""

    def __init__(self, rank: int = -1, host: Optional[str] = None,
                 kind: str = "slow_rank", detail: str = ""):
        super().__init__(rank=rank, host=host, kind=kind, detail=detail)


def failure_from_event(event: dict) -> WorkerFailure:
    """Typed WorkerFailure from a failure event dict (``{rank, kind,
    detail}``, the shape the JAX coordinator ships)."""
    kind = str(event.get("kind", "unknown"))
    cls = SlowRankFailure if kind == "slow_rank" else WorkerFailure
    return cls(rank=int(event.get("rank", -1)), kind=kind,
               detail=str(event.get("detail", "")))


@dataclasses.dataclass
class FailureConfig:
    """Escalation knobs for elastic runs.

    ``failure_timeout_s`` is exported to workers as
    ``HOROVOD_TPU_FAILURE_TIMEOUT`` — the window after which the
    engine's stall inspector escalates to :class:`WorkerFailure` instead
    of warning.
    ``max_restarts`` bounds relaunch attempts; the backoff fields pace
    them; ``blacklist_s`` is how long a failed host's lost slot stays
    excluded before the driver lets it grow back in.

    Slow-rank eviction: a :class:`SlowRankFailure` penalizes its host
    for the shorter ``slow_blacklist_s`` window. When a penalty expires
    and ``readmit_probe`` is set (a ``host -> bool`` callable), the slot
    only returns if the probe passes; a failed probe renews the penalty with
    the window scaled by ``readmit_backoff_factor`` (capped at
    ``max_blacklist_s``) — a still-sick host is re-probed ever more
    lazily instead of flapping in and out of the world."""

    failure_timeout_s: float = 30.0
    max_restarts: int = 3
    backoff_s: float = 1.0
    backoff_factor: float = 2.0
    max_backoff_s: float = 30.0
    blacklist_s: float = 300.0
    poll_interval_s: float = 0.2
    slow_blacklist_s: float = 60.0
    readmit_probe: Optional[Callable[[str], bool]] = None
    readmit_backoff_factor: float = 2.0
    max_blacklist_s: float = 1800.0

    def next_backoff(self, current: float) -> float:
        return min(max(current, self.backoff_s) * self.backoff_factor,
                   self.max_backoff_s)


class FailureDetector:
    """Watches a launched job's workers; raises :class:`WorkerFailure`
    for the first dead one.

    ``job`` is any object with ``workers`` (each with ``poll()``, a
    ``subprocess.Popen`` returncode) and ``terminate()``. Instead of a
    generic RuntimeError it produces the typed event an elastic loop
    dispatches on, and it distinguishes signal deaths (negative
    returncode → ``kind='killed'``)
    from nonzero exits (``kind='exit'``)."""

    def __init__(self, job, rank_hosts: List[str],
                 config: Optional[FailureConfig] = None):
        self._job = job
        self._rank_hosts = list(rank_hosts)
        self.config = config or FailureConfig()
        self.failures: List[WorkerFailure] = []

    def check(self) -> None:
        """Poll every worker once; raise on the first failure found.
        All failures observed in this poll are recorded in
        ``self.failures`` first, so the driver can penalize every lost
        host even when several die together."""
        found: List[WorkerFailure] = []
        for rank, w in enumerate(self._job.workers):
            rc = w.poll()
            if rc is not None and rc != 0:
                host = (self._rank_hosts[rank]
                        if rank < len(self._rank_hosts) else None)
                kind = "killed" if rc < 0 else "exit"
                found.append(WorkerFailure(
                    rank=rank, host=host, kind=kind,
                    detail=f"worker exited with code {rc}"))
        if found:
            self.failures.extend(found)
            self._job.terminate()
            raise found[0]

    def wait(self, done, timeout: Optional[float] = None) -> None:
        """Poll ``done()`` until it returns True, checking workers at the
        configured interval; TimeoutError past ``timeout``."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while not done():
            self.check()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic attempt did not finish within {timeout}s")
            time.sleep(self.config.poll_interval_s)
