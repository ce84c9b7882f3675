"""Fleet supervisor: spawn and babysit N independent serving replicas.

Counterpart of ``horovod_tpu/serving/fleet.py``, copied; its replicas
are ``python -m horovod_tpu_torch.serving`` processes. One replica dies
with its process and every request in flight on it; the fleet applies
observe, detect, act:

  - observe: each replica is a separate process announcing its HTTP
    and metrics ports on stdout (``[serving] ready on :PORT ...
    metrics=:PORT``); the supervisor owns the pipe.
  - detect: a crash by process exit (``poll()``), a hang by a periodic
    ``/healthz`` probe: ``HOROVOD_TPU_FLEET_PROBE_FAILURES`` failures
    in a row and the replica is killed.
  - act: restart it from the same checkpoint with its incarnation
    bumped (``HOROVOD_TPU_ELASTIC_GENERATION``, so a ``gen=0`` fault
    clause fires in the first incarnation only), and record every
    transition as a flight-recorder ``serving_replica`` event and an
    ``hvdtpu_fleet_*`` metric. Each incarnation dumps its blackbox
    into its own ``gen{N}/`` subdirectory, so a restart never
    overwrites the dump that names the crash.

The supervisor never routes: :class:`~.router.Router` reads
:meth:`Fleet.endpoints` each scrape cycle, so a restarted replica (a
new ephemeral port) re-enters rotation as soon as it announces itself.
Replicas share nothing but the checkpoint directory and, on one card,
the card: each loads its own copy of the weights. SIGKILL is always a
safe supervisor action; the router's failover recovers the requests.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ..observability import flight_recorder as _flight
from ..observability import registry as _obs
from ..utils import env as _env

_log = logging.getLogger(__name__)

# Families the replica history sampler scrapes — the serving signal
# plane plus the SLO/goodput families, not the whole registry
# (docs/health.md#fleet, docs/serving.md#slo). Comma-separated: the
# replica's /metrics.json splits it into a prefix union.
_REPLICA_HISTORY_PREFIX = "hvdtpu_serving_,hvdtpu_slo_"

# The replica's announce line (serving/__main__.py). The leading
# ``ready on :PORT`` phrase is load-bearing API — tests and the
# pre-fleet tooling grep for it.
_READY_RE = re.compile(r"ready on :(\d+)")
_METRICS_RE = re.compile(r"metrics=:(\d+)")


def _metrics():
    r = _obs.registry()
    return {
        "live": r.gauge(
            "hvdtpu_fleet_replicas_live",
            "Replica processes currently alive with a bound serving "
            "port").labels(),
        "restarts": r.counter(
            "hvdtpu_fleet_replica_restarts_total",
            "Replica restarts by the supervisor, by replica index and "
            "why the previous incarnation ended"),
        "probe_failures": r.counter(
            "hvdtpu_fleet_probe_failures_total",
            "Failed replica health probes (timeouts / refused / "
            "dropped), by replica index"),
    }


@dataclasses.dataclass(frozen=True)
class ReplicaEndpoint:
    """What the router needs to know about one live replica."""

    index: int
    host: str
    port: int
    metrics_port: Optional[int] = None


class Replica:
    """One supervised replica process (identity = index; the process,
    port and incarnation all change across restarts)."""

    def __init__(self, index: int):
        self.index = index
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.metrics_port: Optional[int] = None
        self.generation = 0          # incarnation (restart count)
        self.restarts = 0
        self.probe_failures = 0
        self.t_spawn = 0.0
        self.ready = threading.Event()   # ready line seen (this proc)
        self.retiring = False        # scale-down drain in progress:
        #                              exit means RETIRE, not restart
        #                              (docs/serving.md#qos)
        self._reader: Optional[threading.Thread] = None

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def up(self) -> bool:
        return self.alive and self.port is not None


class Fleet:
    """Supervisor for ``n`` serving replicas launched from one
    checkpoint.

    ``replica_argv`` is the argv tail handed to every ``python -m
    horovod_tpu_torch.serving`` child (``--checkpoint-dir ...`` etc.);
    the supervisor adds ``--replica-id``/``--port 0`` itself and forces
    an ephemeral per-replica metrics endpoint
    (``HOROVOD_TPU_METRICS_PORT=0``) so the router has a queue-gauge
    scrape target per replica.
    """

    def __init__(self, n: int, replica_argv: List[str], *,
                 host: str = "127.0.0.1",
                 env: Optional[Dict[str, str]] = None,
                 probe_interval_s: Optional[float] = None,
                 probe_failures: Optional[int] = None,
                 max_restarts: Optional[int] = None,
                 restart_backoff_s: float = 0.5):
        if n < 1:
            raise ValueError(f"fleet needs >= 1 replica, got {n}")
        self.n = int(n)
        self.host = host
        self.replica_argv = list(replica_argv)
        self._env = dict(env) if env is not None else None
        self._probe_interval = (probe_interval_s
                                if probe_interval_s is not None
                                else _env.fleet_probe_interval_secs())
        self._probe_failures = (probe_failures
                                if probe_failures is not None
                                else _env.fleet_probe_failures())
        self.max_restarts = max_restarts
        self._backoff = float(restart_backoff_s)
        self.replicas = [Replica(i) for i in range(self.n)]
        self._m = _metrics()
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # QoS autoscaler hookups (docs/serving.md#qos): health-plane
        # alerts forwarded via on_alert; _history_armed remembers
        # whether scale-up replicas need their own history sampler.
        self.on_alert = None
        self._history_armed = False
        # Telemetry history (docs/health.md#fleet): the SUPERVISOR
        # samples each replica's scraped serving metrics into its own
        # history-replica{i}.jsonl — replica trends survive replica
        # death (the replica's own process-local history would die
        # with it), and restarts appear as counter resets, which the
        # delta reduction handles. Plus one history-fleet.jsonl over
        # the supervisor's own registry (restart/probe counters) so
        # the restart-spike detector has a durable signal.
        self._history: list = []

    # ----------------------------------------------------------- spawn

    def _note(self, event: str, replica: int, detail: str = "") -> None:
        _flight.recorder().note("serving_replica",
                                (event, replica, detail))

    def _spawn(self, rep: Replica) -> None:
        env = dict(os.environ if self._env is None else self._env)
        env["HOROVOD_TPU_REPLICA_ID"] = str(rep.index)
        # The incarnation rides the elastic-generation contract: fault
        # clauses scope to one incarnation with gen=N exactly like they
        # scope to one elastic generation in training.
        env["HOROVOD_TPU_ELASTIC_GENERATION"] = str(rep.generation)
        # One scrape target per replica: ephemeral port, announced on
        # the ready line. A parent-level plain port would collide
        # across replicas.
        env["HOROVOD_TPU_METRICS_PORT"] = "0"
        # Blackbox dumps go to a per-INCARNATION subdir: a restarted
        # replica's periodic inflight snapshots would otherwise
        # overwrite its dead predecessor's final-gasp dump — the one
        # file the postmortem needs to name the crash
        # (docs/postmortem.md).
        bb = env.get("HOROVOD_TPU_BLACKBOX")
        if bb:
            env["HOROVOD_TPU_BLACKBOX"] = os.path.join(
                bb, f"gen{rep.generation}")
        cmd = [sys.executable, "-m", "horovod_tpu_torch.serving",
               "--replica-id", str(rep.index), "--port", "0"] \
            + self.replica_argv
        rep.port = None
        rep.metrics_port = None
        rep.ready = threading.Event()
        rep.probe_failures = 0
        rep.t_spawn = time.monotonic()
        rep.proc = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL if env.get(
                "HOROVOD_TPU_FLEET_QUIET") else None,
            text=True, bufsize=1)
        self._note("spawn", rep.index, f"gen={rep.generation}")
        _log.info("replica %d spawned (pid %d, gen %d)", rep.index,
                  rep.proc.pid, rep.generation)
        rep._reader = threading.Thread(
            target=self._read_stdout, args=(rep, rep.proc),
            name=f"hvd-tpu-fleet-r{rep.index}", daemon=True)
        rep._reader.start()

    def _read_stdout(self, rep: Replica, proc: subprocess.Popen) -> None:
        """Own the replica's stdout pipe: parse the announce line, tag
        and forward everything else (a supervisor that doesn't drain
        the pipe deadlocks its child on a full buffer)."""
        try:
            for line in proc.stdout:
                m = _READY_RE.search(line)
                if m and rep.proc is proc:
                    rep.port = int(m.group(1))
                    mm = _METRICS_RE.search(line)
                    rep.metrics_port = int(mm.group(1)) if mm else None
                    rep.ready.set()
                    self._note("ready", rep.index,
                               f"port={rep.port}")
                    _log.info("replica %d ready on :%d (metrics %s)",
                              rep.index, rep.port, rep.metrics_port)
                else:
                    sys.stderr.write(f"[replica {rep.index}] {line}")
        except (ValueError, OSError):  # pipe closed mid-read
            pass

    # ------------------------------------------------------- lifecycle

    def start(self, ready_timeout_s: Optional[float] = None) -> None:
        """Spawn every replica and start the supervision loop;
        optionally block until all announce ready."""
        for rep in self.replicas:
            self._spawn(rep)
        self._thread = threading.Thread(
            target=self._supervise, name="hvd-tpu-fleet", daemon=True)
        self._thread.start()
        self._maybe_start_history()
        if ready_timeout_s is not None:
            self.wait_ready(ready_timeout_s)

    def _scrape_snapshot(self, rep: Replica) -> dict:
        """One replica's serving-metric snapshot — the prefix-filtered
        ``/metrics.json`` view (never the full registry; the prefix=
        query keeps the per-tick payload to the serving families)."""
        import urllib.request
        port = rep.metrics_port
        if not rep.up or port is None:
            raise ConnectionError(f"replica {rep.index} has no metrics "
                                  "endpoint (down or not ready)")
        with urllib.request.urlopen(
                f"http://{self.host}:{port}/metrics.json"
                f"?prefix={_REPLICA_HISTORY_PREFIX}",
                timeout=max(1.0, self._probe_interval * 4)) as resp:
            import json as _json
            return _json.loads(resp.read())

    def _maybe_start_history(self) -> None:
        """Arm the fleet history plane when HOROVOD_TPU_HISTORY is set:
        one sampler per replica (scraped, so trends survive replica
        death) plus one over the supervisor's own fleet registry, all
        sharing the telemetry timer thread. The supervisor owns the
        alert webhook for serving alerts — replicas never POST."""
        directory = _env.history_dir()
        if not directory or not _obs.enabled():
            return
        from ..observability import health as _health
        from ..observability import history as _history
        self._history_armed = True
        detectors = _env.health_detectors_enabled()
        url = _env.alert_url()
        for rep in self.replicas:
            self._start_replica_history(rep)
        fleet_monitor = _health.HealthMonitor(
            webhook_url=url,
            alert_sink=self._alert_sink) if detectors else None
        self._history.append(_history.HistorySampler(
            directory, "fleet",
            prefix=("hvdtpu_fleet_", "hvdtpu_slo_"),
            monitor=fleet_monitor,
            meta=lambda: {"role": "fleet_supervisor"},
        ).start())

    def _start_replica_history(self, rep: Replica) -> None:
        """One replica's history sampler + monitor — factored out so
        scale-up replicas (docs/serving.md#qos) get the same
        telemetry as the initial fleet."""
        if not self._history_armed:
            return
        from ..observability import health as _health
        from ..observability import history as _history
        directory = _env.history_dir()
        monitor = _health.HealthMonitor(
            replica=rep.index, webhook_url=_env.alert_url(),
            alert_sink=self._alert_sink) \
            if _env.health_detectors_enabled() else None
        self._history.append(_history.HistorySampler(
            directory, f"replica{rep.index}",
            source=(lambda r=rep: self._scrape_snapshot(r)),
            monitor=monitor,
            meta=lambda r=rep: {"replica": r.index,
                                "generation": r.generation,
                                "role": "serving_replica"},
        ).start())

    def _alert_sink(self, alert) -> None:
        """Forward scale-relevant health alerts (queue_depth_runaway)
        to the QoS autoscaler when one is attached
        (docs/serving.md#qos)."""
        cb = self.on_alert
        if cb is None or alert.kind != "queue_depth_runaway":
            return
        try:
            cb(alert.kind)
        except Exception as e:  # pragma: no cover - defensive
            _log.warning("fleet alert forward failed: %s", e)

    def wait_ready(self, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        for rep in self.replicas:
            if not rep.ready.wait(max(0.0,
                                      deadline - time.monotonic())):
                raise TimeoutError(
                    f"replica {rep.index} not ready within "
                    f"{timeout_s}s")

    def endpoints(self) -> List[ReplicaEndpoint]:
        """Live, port-announced replicas — the router's backend list,
        re-read every scrape cycle so restarts re-enter rotation."""
        out = []
        for rep in list(self.replicas):
            if rep.up:
                out.append(ReplicaEndpoint(
                    index=rep.index, host=self.host, port=rep.port,
                    metrics_port=rep.metrics_port))
        return out

    def live_count(self) -> int:
        """Replicas currently serving (up, not mid-retirement) — the
        autoscaler's notion of fleet size."""
        return sum(1 for r in list(self.replicas)
                   if r.up and not r.retiring)

    def load_views(self) -> List[dict]:
        """Supervisor-side load sample: each serving replica's
        active/queued/slots from /healthz — the autoscaler's fallback
        signal source when no router is wired in
        (docs/serving.md#qos)."""
        import http.client
        import json as _json
        out = []
        for rep in list(self.replicas):
            if not rep.up or rep.retiring:
                continue
            try:
                conn = http.client.HTTPConnection(
                    self.host, rep.port, timeout=max(
                        1.0, self._probe_interval * 4))
                try:
                    conn.request("GET", "/healthz")
                    resp = conn.getresponse()
                    if resp.status != 200:
                        continue
                    h = _json.loads(resp.read())
                finally:
                    conn.close()
            except (OSError, ValueError):
                continue
            out.append({
                "active": float(h.get("active_requests", 0)),
                "queue_depth": float(h.get("queue_depth", 0)),
                "slots": float(h.get("batch_slots", 1) or 1)})
        return out

    def scale_to(self, n: int) -> None:
        """QoS autoscaler action (docs/serving.md#qos): grow by
        spawning fresh replicas at new indices; shrink by marking the
        highest-index serving replicas ``retiring`` and SIGTERMing
        them into the existing drain path (readyz flips 503, the
        router stops admitting, every accepted request completes,
        exit 0) — the supervisor then REMOVES them instead of
        restarting, so zero requests drop through a scale-down."""
        if n < 1:
            raise ValueError(f"fleet needs >= 1 replica, got {n}")
        with self._lock:
            serving = [r for r in self.replicas
                       if r.proc is not None and not r.retiring]
            cur = len(serving)
            if n > cur:
                next_idx = 1 + max(
                    (r.index for r in self.replicas), default=-1)
                for i in range(n - cur):
                    rep = Replica(next_idx + i)
                    self.replicas.append(rep)
                    self._spawn(rep)
                    self._note("scale_up", rep.index, f"fleet={n}")
                    self._start_replica_history(rep)
            elif n < cur:
                doomed = sorted(serving, key=lambda r: -r.index)
                for rep in doomed[:cur - n]:
                    rep.retiring = True
                    self._note("scale_down", rep.index, "drain")
                    if rep.alive:
                        rep.proc.send_signal(signal.SIGTERM)
            self.n = n

    def _probe(self, rep: Replica) -> bool:
        """One /healthz liveness probe (readiness is the router's
        business — a draining replica must NOT be shot)."""
        import http.client
        try:
            conn = http.client.HTTPConnection(
                self.host, rep.port, timeout=max(
                    1.0, self._probe_interval * 4))
            try:
                conn.request("GET", "/healthz")
                return conn.getresponse().status == 200
            finally:
                conn.close()
        except OSError:
            return False

    def _supervise(self) -> None:
        while not self._stopping.is_set():
            for rep in list(self.replicas):
                if self._stopping.is_set():
                    break
                if rep.proc is None:
                    continue
                rc = rep.proc.poll()
                if rc is not None:
                    self._on_exit(rep, rc)
                    continue
                if rep.port is not None:
                    if self._probe(rep):
                        rep.probe_failures = 0
                    else:
                        rep.probe_failures += 1
                        self._m["probe_failures"].labels(
                            replica=str(rep.index)).inc()
                        if rep.probe_failures >= self._probe_failures:
                            self._note("health_timeout", rep.index,
                                       f"{rep.probe_failures} probes")
                            _log.error(
                                "replica %d unresponsive for %d "
                                "probes — killing for restart",
                                rep.index, rep.probe_failures)
                            try:
                                rep.proc.send_signal(signal.SIGKILL)
                            except OSError:
                                pass
            self._m["live"].set(
                sum(1 for r in list(self.replicas) if r.up))
            self._stopping.wait(self._probe_interval)

    def _on_exit(self, rep: Replica, rc: int) -> None:
        why = "exit" if rc == 0 else "crash"
        self._note(why, rep.index, f"rc={rc} gen={rep.generation}")
        _log.log(30 if rc else 20,
                 "replica %d (gen %d) %s with rc=%s", rep.index,
                 rep.generation, "exited" if rc == 0 else "CRASHED", rc)
        if self._stopping.is_set():
            rep.proc = None
            return
        if rep.retiring:
            # Scale-down drain completed: retire instead of restart
            # (docs/serving.md#qos).
            self._note("retired", rep.index, f"rc={rc}")
            _log.info("replica %d retired (scale-down drain done)",
                      rep.index)
            rep.proc = None
            with self._lock:
                try:
                    self.replicas.remove(rep)
                except ValueError:  # pragma: no cover - already gone
                    pass
            return
        if self.max_restarts is not None \
                and rep.restarts >= self.max_restarts:
            self._note("gave_up", rep.index,
                       f"restarts={rep.restarts}")
            _log.error("replica %d exceeded max_restarts=%d — leaving "
                       "it down", rep.index, self.max_restarts)
            rep.proc = None
            return
        # Fast-crash backoff: a replica dying within 2 s of spawn
        # (bad checkpoint, port clash) must not spin the supervisor.
        if time.monotonic() - rep.t_spawn < 2.0:
            self._stopping.wait(self._backoff)
        rep.restarts += 1
        rep.generation += 1
        self._m["restarts"].labels(replica=str(rep.index),
                                   why=why).inc()
        self._note("restart", rep.index, f"gen={rep.generation}")
        self._spawn(rep)

    def drain_replica(self, index: int) -> None:
        """Operator action: SIGTERM one replica so it drains cleanly
        (readyz flips 503, the router stops admitting, accepted work
        completes, exit 0 — and the supervisor restarts it)."""
        rep = self.replicas[index]
        if rep.alive:
            self._note("drain", index, "sigterm")
            rep.proc.send_signal(signal.SIGTERM)

    def kill_replica(self, index: int) -> None:
        """Chaos action: SIGKILL one replica mid-flight — no drain, no
        goodbye. In-flight requests on it are lost at the replica and
        recovered by the router's failover resume; the supervisor
        restarts the process like any other crash."""
        rep = self.replicas[index]
        if rep.alive:
            self._note("kill", index, "sigkill")
            rep.proc.kill()

    def stop(self, timeout_s: float = 30.0) -> None:
        """Tear the fleet down: stop restarting, SIGTERM every replica
        (graceful drain), escalate to SIGKILL past the timeout."""
        self._stopping.set()
        for sampler in self._history:
            sampler.stop()   # final flush — the last window survives
        self._history = []
        if self._thread is not None:
            self._thread.join(timeout=self._probe_interval * 4 + 1)
        for rep in self.replicas:
            if rep.alive:
                rep.proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + timeout_s
        for rep in self.replicas:
            if rep.proc is None:
                continue
            try:
                rep.proc.wait(timeout=max(
                    0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                _log.warning("replica %d did not drain in %.0fs — "
                             "SIGKILL", rep.index, timeout_s)
                rep.proc.kill()
                rep.proc.wait(timeout=10.0)
            self._note("stopped", rep.index,
                       f"rc={rep.proc.returncode}")
        self._m["live"].set(0)
