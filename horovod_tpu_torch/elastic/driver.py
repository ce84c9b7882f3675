"""Elastic driver loop — ``run_elastic(fn, ...)`` and the command-mode
equivalent behind ``python -m horovod_tpu_torch.runner --elastic``.

Counterpart of ``horovod_tpu/elastic/driver.py``, copied: the same loop,
penalties and ``hvdtpu_elastic_*`` families, over the port's launcher,
whose ranks rendezvous through ``torch.distributed``'s env.

The non-elastic ``runner.run`` (runner/api.py) launches one fixed world
and fail-fasts the whole job on any worker death. This driver makes the
world a *variable*: each attempt launches a generation of workers over
the hosts a :class:`~.discovery.HostProvider` currently reports, watches
them with a :class:`~.failure.FailureDetector`, and on a
:class:`WorkerFailure`:

  1. penalizes the failed worker's host slot (for ``blacklist_s``
     seconds — the slot returns afterwards, which is how the world grows
     back when a replacement appears or the host recovers),
  2. re-discovers, shrinking the next generation to the surviving slots
     (clamped to ``[min_np, max_np]``; below ``min_np`` the driver keeps
     re-discovering with backoff until the restart budget is spent),
  3. relaunches with a bumped ``HOROVOD_TPU_ELASTIC_GENERATION``; the
     new generation re-negotiates rendezvous from scratch through the
     launcher's env contract — a fresh store on a fresh port, fresh
     process groups — and the worker function resumes from its last
     committed :class:`ElasticState` (``state.restore()``).

Rendezvous re-negotiation is deliberately *relaunch-based*: a process
group has a fixed world size, so a changed world needs a new
``torch.distributed`` world anyway — re-forming it through the
launcher's existing plane reuses every tested code path instead of
inventing a second rendezvous protocol. State survives the relaunch
through ElasticState's commit dir, not process memory.

Worker functions signal failure semantics by *how* they die: a Python
exception is registered with the driver and aborts the job (a bug
re-runs identically — retrying it hides it); process death (SIGKILL,
OOM, host loss) is a :class:`WorkerFailure` and triggers recovery.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..observability import registry as _obs
from ..runner.api import driver_addresses
from ..runner.driver_service import DriverService
from ..runner.launcher import expand_slots, launch
from ..runner.secret import SECRET_ENV, encode_key, make_secret_key
from ..runner.timeout import Timeout
from .discovery import HostProvider, HostSlots, get_provider
from .failure import (FailureConfig, FailureDetector, SlowRankFailure,
                      WorkerFailure)
from .state import ELASTIC_DIR_ENV

_log = logging.getLogger(__name__)


class _ElasticMetrics:
    """Driver-side health telemetry (docs/metrics.md): world size and
    generation gauges, failure counters by kind, and re-rendezvous
    duration — the numbers the structured ``elastic_health`` log line is
    rendered from (one source of truth, the registry)."""

    def __init__(self):
        r = _obs.registry()
        self.world_size = r.gauge(
            "hvdtpu_elastic_world_size",
            "Ranks in the current elastic generation").labels()
        self.generation = r.gauge(
            "hvdtpu_elastic_generation",
            "Current elastic generation number").labels()
        self._failures = r.counter(
            "hvdtpu_elastic_worker_failures_total",
            "Worker failures the elastic driver recovered from, by kind")
        self.failures_all = self._failures.labels(kind="all")
        self.rendezvous = r.histogram(
            "hvdtpu_elastic_rendezvous_seconds",
            "Discover → launch time of each generation (includes "
            "blacklist backoff after a failure)",
            buckets=_obs.LATENCY_BUCKETS).labels()
        self.last_rendezvous_ms = r.gauge(
            "hvdtpu_elastic_last_rendezvous_ms",
            "Milliseconds the most recent re-rendezvous took").labels()

    def failure(self, kind: str) -> None:
        self.failures_all.inc()
        self._failures.labels(kind=kind or "unknown").inc()

    def health_line(self, event: str, np_now: int, generation: int,
                    hosts_str: str) -> None:
        """One structured, grep-able line per world-size event, rendered
        from the registry (replaces the free-form generation prints)."""
        _log.info(
            "elastic_health event=%s generation=%d world_size=%d "
            "failures_total=%d last_rendezvous_ms=%.0f hosts=%s",
            event, generation, np_now, int(self.failures_all.value),
            self.last_rendezvous_ms.value, hosts_str or "-")

GENERATION_ENV = "HOROVOD_TPU_ELASTIC_GENERATION"
FAILURE_TIMEOUT_ENV = "HOROVOD_TPU_FAILURE_TIMEOUT"


class _SlotPenalties:
    """Per-host lost-slot ledger with expiry and readmission probing.

    A failure on ``host`` removes ONE slot there (not the whole host:
    a single-host job that loses one of two local workers must shrink
    to one, not to zero) until its window passes — at which point the
    slot is offered again and the world can grow back. Each penalty
    carries its own window (crash vs slow-rank blacklists differ).

    With a ``probe`` (host -> bool), an EXPIRED penalty is only lifted
    once the probe passes; a failing probe renews it with the window
    scaled by ``backoff_factor`` (capped at ``max_blacklist_s``), so a
    host that stays sick is re-checked ever more lazily instead of
    flapping in and out of the membership."""

    def __init__(self, blacklist_s: float, probe=None,
                 backoff_factor: float = 2.0,
                 max_blacklist_s: float = 1800.0):
        self._blacklist_s = blacklist_s
        self._probe = probe
        self._backoff_factor = backoff_factor
        self._max_blacklist_s = max_blacklist_s
        # host -> [[expiry, window_s], ...]
        self._until: Dict[str, List[List[float]]] = {}

    def penalize(self, host: Optional[str],
                 window_s: Optional[float] = None) -> None:
        if host is None:
            return
        w = self._blacklist_s if window_s is None else window_s
        self._until.setdefault(host, []).append([time.monotonic() + w, w])

    def apply(self, slots: HostSlots) -> HostSlots:
        now = time.monotonic()
        out: HostSlots = []
        for host, n in slots:
            pend: List[List[float]] = []
            for expiry, window in self._until.get(host, []):
                if expiry > now:
                    pend.append([expiry, window])
                    continue
                if self._probe is not None and not self._probe(host):
                    # Still sick: renew with backoff instead of
                    # readmitting a host that would fail again.
                    window = min(window * self._backoff_factor,
                                 self._max_blacklist_s)
                    _log.warning(
                        "readmission probe failed for %s; re-penalizing "
                        "for %.0fs", host, window)
                    pend.append([now + window, window])
                # probe passed (or no probe): penalty lifted
            self._until[host] = pend
            n = max(0, n - len(pend))
            if n > 0:
                out.append((host, n))
        return out


def _clamp_world(slots: HostSlots, min_np: int, max_np: Optional[int]
                 ) -> Tuple[int, str, List[str]]:
    """Turn discovered slots into (np, hosts_str, rank→host map), capped
    at ``max_np``; raises WorkerFailure-shaped capacity info via np <
    min_np being returned as 0."""
    total = sum(n for _, n in slots)
    if total < min_np:
        return 0, "", []
    np_now = total if max_np is None else min(total, max_np)
    # Trim trailing slots past the cap, keeping hosts contiguous the way
    # the launcher orders ranks.
    trimmed: HostSlots = []
    left = np_now
    for host, n in slots:
        take = min(n, left)
        if take > 0:
            trimmed.append((host, take))
            left -= take
        if left == 0:
            break
    hosts_str = ",".join(f"{h}:{n}" for h, n in trimmed)
    return np_now, hosts_str, expand_slots(trimmed, np_now)


def _elastic_env(extra_env: Optional[Dict[str, str]], generation: int,
                 state_dir: Optional[str], config: FailureConfig
                 ) -> Dict[str, str]:
    env = dict(extra_env or {})
    env[GENERATION_ENV] = str(generation)
    if state_dir:
        env[ELASTIC_DIR_ENV] = state_dir
    env[FAILURE_TIMEOUT_ENV] = str(config.failure_timeout_s)
    return env


def _run_generation(fn_bytes: bytes, np_now: int, hosts_str: str,
                    rank_hosts: List[str], env: Dict[str, str],
                    config: FailureConfig,
                    start_timeout: float, run_timeout: Optional[float],
                    stdout, stderr) -> List[Any]:
    """One generation: launch, rendezvous, collect — api.run's flow with
    the FailureDetector as the failfast authority."""
    key = make_secret_key()
    driver = DriverService(np_now, key, fn_bytes)
    try:
        env = dict(env)
        env[SECRET_ENV] = encode_key(key)
        env["HOROVOD_TPU_DRIVER"] = driver_addresses(driver, hosts_str)
        job = launch([sys.executable, "-m",
                      "horovod_tpu_torch.runner.task_exec"],
                     np=np_now, hosts=hosts_str, extra_env=env,
                     stdout=stdout, stderr=stderr)
        detector = FailureDetector(job, rank_hosts, config)
        try:
            reg = Timeout(
                start_timeout,
                "Timed out waiting for {timeout} s for all ranks to "
                "register with the elastic driver.")
            driver.wait_for_registration(reg, failfast=detector.check)
            total = Timeout(
                run_timeout if run_timeout is not None else 10 ** 9,
                "Timed out after {timeout} s waiting for results.")
            try:
                results = driver.wait_for_results(total,
                                                  failfast=detector.check)
            except WorkerFailure as wf:
                # Typed failure registered by a worker (e.g. a
                # slow_rank eviction): attribute the host so the loop
                # can penalize the right slot.
                if wf.host is None and 0 <= wf.rank < len(rank_hosts):
                    wf.host = rank_hosts[wf.rank]
                raise
            with contextlib.suppress(TimeoutError):
                job.wait(timeout=60)
            return results
        finally:
            job.terminate()
    finally:
        driver.shutdown()


def _elastic_loop(provider: HostProvider, min_np: int,
                  max_np: Optional[int], config: FailureConfig,
                  attempt: Callable[[int, str, List[str], int], Any]
                  ) -> Any:
    """Shared discover → attempt → penalize/backoff loop for function
    and command mode. ``attempt(np, hosts_str, rank_hosts, generation)``
    returns the job result or raises WorkerFailure."""
    penalties = _SlotPenalties(
        config.blacklist_s, probe=config.readmit_probe,
        backoff_factor=config.readmit_backoff_factor,
        max_blacklist_s=config.max_blacklist_s)
    metrics = _ElasticMetrics()
    generation = 0
    restarts = 0
    backoff = config.backoff_s
    last_failure: Optional[WorkerFailure] = None
    prev_np: Optional[int] = None
    t_event = time.monotonic()   # loop entry / last failure — the
    #                              re-rendezvous clock's epoch
    while True:
        slots = penalties.apply(provider.discover())
        np_now, hosts_str, rank_hosts = _clamp_world(slots, min_np, max_np)
        if np_now == 0:
            if restarts >= config.max_restarts:
                raise WorkerFailure(
                    kind="capacity", detail=(
                        f"{provider.describe()} offers "
                        f"{sum(n for _, n in slots)} usable slots; "
                        f"min_np={min_np} and the restart budget "
                        f"({config.max_restarts}) is spent")
                ) from last_failure
            restarts += 1
            _log.warning(
                "below min_np=%d; re-discovering in %.1fs "
                "(restart %d/%d)", min_np, backoff, restarts,
                config.max_restarts)
            time.sleep(backoff)
            backoff = config.next_backoff(backoff)
            continue
        rendezvous_s = time.monotonic() - t_event
        metrics.rendezvous.observe(rendezvous_s)
        metrics.last_rendezvous_ms.set(rendezvous_s * 1000.0)
        metrics.world_size.set(np_now)
        metrics.generation.set(generation)
        event = ("launch" if prev_np is None
                 else "grow" if np_now > prev_np
                 else "shrink" if np_now < prev_np else "relaunch")
        prev_np = np_now
        metrics.health_line(event, np_now, generation, hosts_str)
        try:
            return attempt(np_now, hosts_str, rank_hosts, generation)
        except WorkerFailure as wf:
            last_failure = wf
            metrics.failure(wf.kind)
            t_event = time.monotonic()
            if restarts >= config.max_restarts:
                raise
            restarts += 1
            # Slow-rank evictions (docs/adaptation.md) get the SHORT
            # blacklist window: the host is alive, just late — the
            # readmission probe decides when it grows back in.
            penalties.penalize(
                wf.host,
                window_s=(config.slow_blacklist_s
                          if isinstance(wf, SlowRankFailure) else None))
            _log.warning(
                "%s; shrinking and relaunching in %.1fs "
                "(restart %d/%d)", wf, backoff, restarts,
                config.max_restarts)
            time.sleep(backoff)
            backoff = config.next_backoff(backoff)
            generation += 1


def run_elastic(fn: Callable, args: tuple = (),
                kwargs: Optional[dict] = None, *,
                min_np: int = 1, max_np: Optional[int] = None,
                hosts: Optional[str] = None,
                discovery: Optional[str] = None,
                hostfile: Optional[str] = None,
                provider: Optional[HostProvider] = None,
                state_dir: Optional[str] = None,
                config: Optional[FailureConfig] = None,
                extra_env: Optional[Dict[str, str]] = None,
                start_timeout: Optional[float] = None,
                run_timeout: Optional[float] = None,
                stdout=None, stderr=None) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on an elastic world of ``min_np`` to
    ``max_np`` ranks; returns the final generation's results in rank
    order.

    ``fn`` should wrap its training state in an :class:`ElasticState`
    (``state_dir`` is exported to workers as ``HOROVOD_TPU_ELASTIC_DIR``)
    and call ``state.restore()`` before its step loop — on a relaunch
    after worker loss, the surviving/replacement ranks resume from the
    last committed step instead of scratch. Without ``cloudpickle`` the
    function must be importable at module level in the workers."""
    kwargs = kwargs or {}
    config = config or FailureConfig()
    if start_timeout is None:
        from ..runner.api import START_TIMEOUT_ENV
        start_timeout = float(os.environ.get(START_TIMEOUT_ENV, 600))
    prov = provider or get_provider(discovery, hosts=hosts,
                                    hostfile=hostfile)

    try:
        import cloudpickle as pickler
    except ImportError:  # pragma: no cover
        import pickle as pickler
    fn_bytes = pickler.dumps((fn, args, kwargs))

    def attempt(np_now, hosts_str, rank_hosts, generation):
        env = _elastic_env(extra_env, generation, state_dir, config)
        return _run_generation(fn_bytes, np_now, hosts_str, rank_hosts,
                               env, config, start_timeout, run_timeout,
                               stdout, stderr)

    return _elastic_loop(prov, min_np, max_np, config, attempt)


def run_elastic_command(command: List[str], *,
                        min_np: int = 1, max_np: Optional[int] = None,
                        provider: Optional[HostProvider] = None,
                        hosts: Optional[str] = None,
                        discovery: Optional[str] = None,
                        hostfile: Optional[str] = None,
                        state_dir: Optional[str] = None,
                        config: Optional[FailureConfig] = None,
                        extra_env: Optional[Dict[str, str]] = None,
                        tag_output: bool = True,
                        run_timeout: Optional[float] = None) -> int:
    """Command-mode elastic launch (the ``--elastic`` CLI path): relaunch
    ``command`` on the surviving world after a worker is lost. Returns
    the final generation's exit code (0 on success)."""
    config = config or FailureConfig()
    prov = provider or get_provider(discovery, hosts=hosts,
                                    hostfile=hostfile)

    def attempt(np_now, hosts_str, rank_hosts, generation):
        env = _elastic_env(extra_env, generation, state_dir, config)
        job = launch(list(command), np=np_now, hosts=hosts_str,
                     extra_env=env, tag_output=tag_output)
        detector = FailureDetector(job, rank_hosts, config)
        deadline = (None if run_timeout is None
                    else time.monotonic() + run_timeout)
        try:
            while True:
                detector.check()   # raises WorkerFailure on a dead worker
                rcs = [w.poll() for w in job.workers]
                if all(rc == 0 for rc in rcs):
                    return 0
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("elastic job did not finish in time")
                time.sleep(config.poll_interval_s)
        finally:
            job.terminate()

    return _elastic_loop(prov, min_np, max_np, config, attempt)


def generation() -> int:
    """This worker's elastic generation (0 in the first launch and for
    non-elastic jobs) — from the driver-exported env, before ``init``
    (after it, ``horovod_tpu_torch.generation()`` reads the topology)."""
    return int(os.environ.get(GENERATION_ENV, "0") or 0)
