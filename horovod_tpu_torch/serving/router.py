"""Fleet router: queue-depth-aware routing with failover across
serving replicas.

Counterpart of ``horovod_tpu/serving/router.py``, copied: the same
policy, HTTP dialect and ``hvdtpu_fleet_*`` families, so it fronts a
port fleet or a JAX one alike. The router keeps a scraped view of every
replica (``/readyz`` for admission, ``/healthz`` for block size,
sessions and QoS classes, the ``hvdtpu_serving_*`` gauges of its
``/metrics.json?prefix=hvdtpu_serving_`` for load) and, for each
``POST /generate``:

  1. admits onto the replica with the least outstanding work per decode
     slot, ``(active + queue_depth) / batch_slots``, less a warmth bonus
     (the fraction of the prompt's block-aligned prefixes, hashed as the
     engine's prefix cache hashes them, already routed there) and a
     session pin (a replica holding the session's KV lease);
  2. streams the replica's NDJSON tokens to the client;
  3. fails over: a replica that dies before the first token is retried
     elsewhere; one that dies mid-stream is resumed by re-submitting
     ``prompt + tokens emitted so far`` with the remaining budget, so
     a greedy stream continues token for token.

Deadlines propagate (``deadline_ms`` shrinks per hop; an expired request
answers 504 and is never retried); fleet-wide queue-full ends in 503
with ``Retry-After``; a tenant over its token-rate quota gets 429 at the
door. One trace id names a request on every hop (``X-Request-Id``) and
in the request traces (``REQUEST``, ``DISPATCH``, ``FAILOVER`` spans).
The router holds no generation state beyond the emitted tokens: the
replicas own KV, the router owns retry.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence

from ..observability import registry as _obs
from ..utils import env as _env
from . import qos as _qos
from . import reqtrace as _rt
from . import slo as _slo
from .engine import DEADLINE_ERROR
from .fleet import ReplicaEndpoint
from .kv_cache import prefix_hashes

_log = logging.getLogger(__name__)

# Server-side cap on one routed generation (mirrors server.py).
ROUTER_TIMEOUT_S = 600.0
# How long a replica stays excluded from a request's retry loop after
# failing it (it usually also drops from the scrape view, but the
# scrape cadence must not gate failover).
_EXCLUDE_S = 2.0
# Per-read socket timeout on a replica token stream: generous (a decode
# step under load is milliseconds; even a slow_decode fault is tens of
# ms) but finite, so a fully hung replica cannot wedge a client that
# set no deadline.
_STREAM_READ_S = 120.0
# Prefix hashes remembered per replica for cache-warmth scoring (LRU;
# roughly mirrors the replica-side prefix cache, which also evicts LRU
# under pool pressure — an optimistic shadow, never load-bearing).
_WARMTH_ENTRIES = 8192
# Score bonus pinning a leased session to its replica
# (docs/serving.md#session-affinity): worth two slots of outstanding
# work — decisively above the prefix-warmth bonus (≤ 1.0), so a leased
# session sticks through ordinary load imbalance, but a replica that
# stops being READY (draining, dead) still repels it and failover falls
# back to normal dispatch.
_SESSION_PIN_BONUS = 2.0


def _metrics():
    r = _obs.registry()
    return {
        "requests": r.counter(
            "hvdtpu_fleet_requests_total",
            "Routed requests by outcome: completed, expired (deadline "
            "→ 504), rejected (fleet-wide queue-full → 429), failed, "
            "bad_request"),
        "retries": r.counter(
            "hvdtpu_fleet_retries_total",
            "Dispatch attempts beyond the first, by reason: connect, "
            "crash (stream broke), queue_full, draining, failed"),
        "failovers": r.counter(
            "hvdtpu_fleet_failovers_total",
            "Requests moved to another replica after their replica "
            "died, by phase: prefill (before first token) or "
            "midstream (resumed with re-prefill)"),
        "failover_s": r.histogram(
            "hvdtpu_fleet_failover_seconds",
            "Failure detection → first token from the replacement "
            "replica (exemplar: trace id of the worst recent "
            "failover)", buckets=_obs.LATENCY_BUCKETS).labels(),
        "request_s": r.histogram(
            "hvdtpu_fleet_request_seconds",
            "End-to-end routed request wall (relay start → terminal "
            "outcome) — the denominator of the per-request latency "
            "budget (exemplar: trace id of the worst recent request)",
            buckets=_obs.LATENCY_BUCKETS).labels(),
        "dispatch": r.counter(
            "hvdtpu_fleet_dispatch_total",
            "Dispatches by replica index (the admission policy, "
            "observable)"),
        "ready": r.gauge(
            "hvdtpu_fleet_replicas_ready",
            "Replicas currently admitting (readyz 200 at last "
            "scrape)").labels(),
        "queue": r.gauge(
            "hvdtpu_fleet_replica_queue_depth",
            "Scraped hvdtpu_serving_queue_depth per replica index — "
            "the router's own view of the signal it balances on"),
        "warmth": r.counter(
            "hvdtpu_fleet_dispatch_warmth_total",
            "Dispatches by prefix-cache warmth of the chosen replica: "
            "warm (some prompt prefix previously routed there), cold "
            "(none), or unhashed (prompt shorter than one block)"),
        # Same family the replica engine registers — in a real fleet
        # the router is its own process, and its front-door quota
        # sheds must be visible under the same name
        # (docs/serving.md#qos).
        "shed": r.counter(
            "hvdtpu_serving_shed_total",
            "Requests shed by the QoS plane before prefill, by reason "
            "(quota: over the tenant token-rate quota; deadline_pred: "
            "remaining deadline cannot cover predicted prefill + one "
            "decode step) (docs/serving.md#qos)"),
    }


@dataclasses.dataclass
class ReplicaView:
    """The router's scraped view of one replica."""

    endpoint: ReplicaEndpoint
    ready: bool = False
    ok: bool = False              # at least one successful scrape
    queue_depth: float = 0.0
    active: float = 0.0
    slots: float = 1.0
    t_scraped: float = 0.0
    block_size: Optional[int] = None   # scraped from /healthz; the
    #                                    prefix-hash granularity
    # Prefix hashes this router has routed here (bounded LRU) — the
    # warmth estimate behind prefix-aware admission.
    warm: "OrderedDict" = dataclasses.field(default_factory=OrderedDict)
    # Session ids holding a KV lease here, from /healthz (plus the
    # router's own shadow adds between scrapes) — the pin targets.
    sessions: set = dataclasses.field(default_factory=set)
    # Per-QoS-class queued/active counts from /healthz
    # (docs/serving.md#qos) — empty until the replica advertises them.
    qos_classes: Dict[str, dict] = dataclasses.field(
        default_factory=dict)
    reserved_slots: float = 0.0

    @property
    def score(self) -> float:
        """Outstanding work per decode slot — lower admits first."""
        return (self.active + self.queue_depth) / max(1.0, self.slots)

    def class_score(self, qos_class: Optional[str]) -> float:
        """Class-aware load score (docs/serving.md#qos): top-priority
        (interactive) requests are scored by the replica's
        *interactive-only* backlog — under a fleet-wide bulk backlog
        every replica's global score saturates equally and placement
        degenerates to random, which collides interactive requests on
        one replica's reserved slot; counting only same-class work
        spreads them instead. The global score stays as a small
        tiebreak, and other classes keep the global policy."""
        if qos_class != _qos.TOP_CLASS:
            return self.score
        cc = self.qos_classes.get(qos_class)
        if cc is None:
            return self.score
        own = float(cc.get("active", 0)) + float(cc.get("queued", 0))
        return own / max(1.0, self.slots) + 1e-3 * self.score

    def warmth(self, hashes: Sequence[bytes]) -> float:
        """Fraction of the prompt's prefix blocks previously routed to
        this replica (longest-prefix, like the replica-side cache)."""
        if not hashes:
            return 0.0
        n = 0
        for h in hashes:
            if h not in self.warm:
                break
            n += 1
        return n / len(hashes)

    def note_dispatch(self, hashes: Sequence[bytes]) -> None:
        for h in hashes:
            if h in self.warm:
                self.warm.move_to_end(h)
            else:
                self.warm[h] = True
        while len(self.warm) > _WARMTH_ENTRIES:
            self.warm.popitem(last=False)


class StaticBackends:
    """Fixed endpoint list (external replicas / stub-replica tests) —
    the same ``endpoints()`` surface as :class:`fleet.Fleet`."""

    def __init__(self, endpoints: Sequence[ReplicaEndpoint]):
        self._endpoints = list(endpoints)

    def endpoints(self) -> List[ReplicaEndpoint]:
        return list(self._endpoints)


def pick_replica(views: Sequence[ReplicaView],
                 exclude: Optional[set] = None,
                 rr: int = 0,
                 warmth: Optional[Dict[int, float]] = None,
                 qos_class: Optional[str] = None
                 ) -> Optional[ReplicaView]:
    """The routing policy, isolated for unit testing: among ready,
    scrape-confirmed, non-excluded replicas, the lowest *effective*
    score — load score minus the replica's prefix-cache warmth for THIS
    prompt (``warmth``: fraction of prefix blocks already routed there,
    worth up to one slot's outstanding work) — ties broken round-robin
    by ``rr``. None when nobody can admit. With no warmth map this is
    exactly the pre-prefix-cache policy. ``qos_class`` makes the load
    term class-aware (docs/serving.md#qos): an interactive request is
    scored by each replica's interactive-only backlog, so a fleet-wide
    bulk backlog cannot starve (or randomize) interactive dispatch."""
    exclude = exclude or set()
    warmth = warmth or {}
    ok = [v for v in views
          if v.ready and v.ok and v.endpoint.index not in exclude]
    if not ok:
        return None

    def eff(v: ReplicaView) -> float:
        return v.class_score(qos_class) \
            - warmth.get(v.endpoint.index, 0.0)

    best = min(eff(v) for v in ok)
    tied = [v for v in ok if eff(v) == best]
    return tied[rr % len(tied)]


class Router:
    """HTTP front end balancing ``/generate`` across a replica fleet.

    ``backends`` is anything with ``endpoints() ->
    List[ReplicaEndpoint]`` — a :class:`fleet.Fleet` (endpoints move as
    replicas restart) or a :class:`StaticBackends`.
    """

    def __init__(self, backends, port: int = 0, host: str = "0.0.0.0",
                 scrape_interval_s: Optional[float] = None,
                 max_attempts: Optional[int] = None):
        self.backends = backends
        self._scrape_interval = (scrape_interval_s
                                 if scrape_interval_s is not None
                                 else _env.fleet_probe_interval_secs())
        self._max_attempts = max_attempts
        self._views: Dict[int, ReplicaView] = {}
        self._views_lock = threading.Lock()
        self._rr = 0
        self._m = _metrics()
        self._stop = threading.Event()
        self._scrape_thread: Optional[threading.Thread] = None
        self._next_id = 0
        self._id_lock = threading.Lock()
        # QoS plane (docs/serving.md#qos): front-door token-rate
        # quotas (the replica-side check still covers single-replica
        # deployments) and a 429/queue-full pressure window the
        # autoscaler reads via qos_signals().
        self._quota = _qos.QuotaLedger(_qos.policy())
        self._pressure: deque = deque()
        self._pressure_lock = threading.Lock()
        self._build_http(host, port)

    def _note_pressure(self) -> None:
        with self._pressure_lock:
            self._pressure.append(time.monotonic())

    def qos_signals(self) -> dict:
        """The autoscaler's signal sample (docs/serving.md#qos):
        fleet-wide outstanding work per slot across ready replicas,
        the ready count, and recent 429/queue-full pressure per
        second (10 s window)."""
        with self._views_lock:
            views = [v for v in self._views.values()
                     if v.ready and v.ok]
        slots = sum(v.slots for v in views)
        work = sum(v.active + v.queue_depth for v in views)
        now = time.monotonic()
        with self._pressure_lock:
            while self._pressure and self._pressure[0] < now - 10.0:
                self._pressure.popleft()
            pressure = len(self._pressure) / 10.0
        return {"load_per_slot": work / max(1.0, slots),
                "n_replicas": len(views),
                "retry_pressure": pressure}

    # ------------------------------------------------------ scraping

    def _scrape_one(self, view: ReplicaView) -> None:
        ep = view.endpoint
        try:
            conn = http.client.HTTPConnection(
                ep.host, ep.port, timeout=max(
                    1.0, self._scrape_interval * 4))
            try:
                conn.request("GET", "/readyz")
                view.ready = conn.getresponse().status == 200
            finally:
                conn.close()
        except OSError:
            view.ready = False
            view.ok = False
            return
        # healthz first, every cycle: besides being the load fallback,
        # it carries block_size (the prefix-hash granularity) and the
        # live session-lease ids the pinning policy routes on — both
        # are healthz-only.
        got = self._scrape_healthz(view)
        if ep.metrics_port:
            # The registry gauges stay the primary load signal when a
            # metrics endpoint exists.
            got = self._scrape_metrics(view) or got
        view.ok = got
        view.t_scraped = time.monotonic()

    def _scrape_metrics(self, view: ReplicaView) -> bool:
        """The primary load signal: the replica's own
        ``hvdtpu_serving_*`` gauges from its registry endpoint."""
        ep = view.endpoint
        try:
            conn = http.client.HTTPConnection(
                ep.host, ep.metrics_port, timeout=max(
                    1.0, self._scrape_interval * 4))
            try:
                # prefix= keeps the per-scrape payload to the serving
                # families — the replica never serializes (and the
                # router never parses) the whole registry per tick.
                conn.request("GET", "/metrics.json?prefix=hvdtpu_serving_")
                resp = conn.getresponse()
                if resp.status != 200:
                    return False
                snap = json.loads(resp.read())
            finally:
                conn.close()
        except (OSError, ValueError):
            return False

        def gauge(name, default=None):
            try:
                return float(snap[name]["values"][""])
            except (KeyError, TypeError, ValueError):
                return default

        q = gauge("hvdtpu_serving_queue_depth")
        a = gauge("hvdtpu_serving_active_requests")
        s = gauge("hvdtpu_serving_batch_slots")
        if q is None or a is None:
            return False
        view.queue_depth, view.active = q, a
        if s:
            view.slots = s
        return True

    def _scrape_healthz(self, view: ReplicaView) -> bool:
        """Fallback when the replica runs with metrics disabled
        (HOROVOD_TPU_METRICS=0): /healthz carries the same numbers."""
        ep = view.endpoint
        try:
            conn = http.client.HTTPConnection(
                ep.host, ep.port, timeout=max(
                    1.0, self._scrape_interval * 4))
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                if resp.status != 200:
                    return False
                h = json.loads(resp.read())
            finally:
                conn.close()
        except (OSError, ValueError):
            return False
        view.queue_depth = float(h.get("queue_depth", 0))
        view.active = float(h.get("active_requests", 0))
        view.slots = float(h.get("batch_slots", 1) or 1)
        if h.get("block_size"):
            view.block_size = int(h["block_size"])
        if "sessions" in h:
            view.sessions = set(h.get("sessions") or [])
        if isinstance(h.get("qos_classes"), dict):
            view.qos_classes = h["qos_classes"]
        view.reserved_slots = float(h.get("reserved_slots", 0) or 0)
        return True

    def _scrape_cycle(self) -> None:
        eps = {ep.index: ep for ep in self.backends.endpoints()}
        with self._views_lock:
            # Drop vanished replicas; reset views whose port moved
            # (a restarted replica is a NEW backend).
            for idx in list(self._views):
                if idx not in eps:
                    del self._views[idx]
                elif self._views[idx].endpoint != eps[idx]:
                    self._views[idx] = ReplicaView(endpoint=eps[idx])
            for idx, ep in eps.items():
                if idx not in self._views:
                    self._views[idx] = ReplicaView(endpoint=ep)
            views = list(self._views.values())
        for v in views:
            self._scrape_one(v)
            self._m["queue"].labels(
                replica=str(v.endpoint.index)).set(v.queue_depth)
        self._m["ready"].set(sum(1 for v in views if v.ready))

    def _scrape_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._scrape_cycle()
            except Exception as e:  # never die over telemetry
                _log.warning("scrape cycle failed: %s", e)
            self._stop.wait(self._scrape_interval)

    def _pick(self, exclude: Dict[int, float],
              prompt: Optional[List[int]] = None,
              session_id: Optional[str] = None,
              qos_class: Optional[str] = None
              ) -> Optional[ReplicaView]:
        now = time.monotonic()
        live = {i for i, until in exclude.items() if until > now}
        with self._views_lock:
            views = list(self._views.values())
        warmth: Dict[int, float] = {}
        if prompt:
            for v in views:
                hashes = prefix_hashes(prompt, v.block_size or 16)
                warmth[v.endpoint.index] = v.warmth(hashes)
        if session_id:
            # Session pinning rides the warmth channel: the replica
            # advertising this session's lease gets a bonus big enough
            # to win any warmth tie, while exclusion (failover) and
            # readiness still override it unconditionally.
            for v in views:
                if session_id in v.sessions:
                    warmth[v.endpoint.index] = warmth.get(
                        v.endpoint.index, 0.0) + _SESSION_PIN_BONUS
        self._rr += 1
        view = pick_replica(views, exclude=live, rr=self._rr,
                            warmth=warmth, qos_class=qos_class)
        if view is not None and prompt:
            hashes = prefix_hashes(prompt, view.block_size or 16)
            state = ("unhashed" if not hashes else
                     "warm" if warmth.get(view.endpoint.index) else
                     "cold")
            self._m["warmth"].labels(state=state).inc()
            view.note_dispatch(hashes)
        return view

    # ------------------------------------------------------ dispatch

    def _relay(self, rid: str, prompt: List[int], max_new: int,
               temperature: Optional[float],
               deadline: Optional[float], emit,
               session_id: Optional[str] = None,
               tenant: Optional[str] = None, slo=None) -> dict:
        """Drive one client request across the fleet until it
        completes (see :meth:`_relay_attempts`), timing the wall: the
        ``REQUEST`` trace span and the ``hvdtpu_fleet_request_seconds``
        histogram (exemplar: this trace id) cover relay start →
        terminal outcome — the denominator every per-request budget
        share divides by."""
        t0m = time.monotonic()
        meta = self._relay_attempts(rid, prompt, max_new, temperature,
                                    deadline, emit,
                                    session_id=session_id,
                                    tenant=tenant, slo=slo)
        t1m = time.monotonic()
        self._m["request_s"].observe(t1m - t0m, exemplar=rid)
        span_args = {"status": meta["status"],
                     "retries": meta["retries"],
                     "tokens": len(meta["tokens"])}
        if tenant or slo is not None:
            label = _slo.resolve_tenant(tenant)
            span_args["tenant"] = meta.get("tenant", label)
            if isinstance(meta.get("slo"), dict):
                span_args["slo_met"] = meta["slo"].get("slo_met")
            self._account_slo(label, meta)
            if label and meta["status"] == "completed":
                # Tenant drain rate: what quota Retry-After quotes
                # (docs/serving.md#qos).
                self._quota.note_completion(
                    label, len(prompt) + len(meta["tokens"]))
        _rt.span(rid, "REQUEST", t0m, t1m, span_args)
        return meta

    def _account_slo(self, tenant_label: str, meta: dict) -> None:
        """Fleet-side goodput recount from the replica's verdict: the
        router re-counts hvdtpu_slo_* in ITS registry (real fleets
        keep one registry per process), and is the only place that
        sees requests no replica ever answered — those land as shed
        or deadline here (docs/serving.md#slo)."""
        status = meta.get("status")
        if status == "completed":
            verdict = meta.get("slo")
            if not isinstance(verdict, dict):
                return
            m = _slo.metrics()
            if verdict.get("slo_met"):
                m["goodput"].labels(tenant=tenant_label).inc()
                return
            for dim in ("ttft", "tpot"):
                if verdict.get(f"{dim}_violation"):
                    m["violations"].labels(tenant=tenant_label,
                                           reason=dim).inc()
        elif status == "expired":
            _slo.record_shed(tenant_label, "deadline")
        elif status == "failed":
            _slo.record_shed(tenant_label, "shed")

    def _relay_attempts(self, rid: str, prompt: List[int],
                        max_new: int, temperature: Optional[float],
                        deadline: Optional[float], emit,
                        session_id: Optional[str] = None,
                        tenant: Optional[str] = None,
                        slo=None) -> dict:
        """Pick → stream → (on death) fail over, until terminal.
        ``emit(tok)`` is called once per generated token in order;
        returns the terminal meta dict {"status": ..., "retries": N,
        ...}. The SAME ``rid`` rides every dispatch — a failover
        re-dispatch reuses the identity, never re-mints it."""
        emitted: List[int] = []
        exclude: Dict[int, float] = {}
        qos_class = _qos.policy().class_of(
            _slo.resolve_tenant(tenant)) if tenant else None
        attempts = 0
        retries = 0
        t_fail: Optional[float] = None     # failover stopwatch
        fail_phase: Optional[str] = None   # phase/origin at FIRST
        fail_from: Optional[int] = None    # detection (span args)
        cur_idx: Optional[int] = None      # replica of the live attempt
        n_backends = max(1, len(self.backends.endpoints()))
        max_attempts = self._max_attempts or max(6, 3 * n_backends)

        def expired() -> bool:
            return deadline is not None and time.monotonic() > deadline

        def retry(reason: str) -> None:
            nonlocal retries
            retries += 1
            self._m["retries"].labels(reason=reason).inc()
            if reason == "queue_full":
                # Retry-After pressure: a scale-up signal for the
                # QoS autoscaler (docs/serving.md#qos).
                self._note_pressure()

        def emit_observed(tok: int) -> None:
            # First token after a failover closes the detection→resume
            # stopwatch (kept across back-to-back failed attempts: the
            # client's gap is measured from the FIRST detection).
            nonlocal t_fail
            if t_fail is not None:
                now = time.monotonic()
                self._m["failover_s"].observe(now - t_fail,
                                              exemplar=rid)
                _rt.span(rid, "FAILOVER", t_fail, now,
                         {"phase": fail_phase, "from": fail_from,
                          "to": cur_idx})
                t_fail = None
            emit(tok)

        while True:
            if expired():
                return {"status": "expired", "error": DEADLINE_ERROR,
                        "retries": retries, "tokens": emitted}
            if attempts >= max_attempts:
                return {"status": "failed",
                        "error": f"no replica completed the request "
                                 f"after {attempts} attempts",
                        "retries": retries, "tokens": emitted}
            view = self._pick(exclude, prompt, session_id=session_id,
                              qos_class=qos_class)
            if view is None:
                # Nobody ready right now (mass restart, all draining):
                # wait out a scrape cycle rather than failing a
                # promised request — bounded by deadline/attempts.
                attempts += 1
                wait = self._scrape_interval
                if deadline is not None:
                    wait = min(wait, max(0.0,
                                         deadline - time.monotonic()))
                time.sleep(wait)
                continue
            attempts += 1
            idx = view.endpoint.index
            cur_idx = idx
            self._m["dispatch"].labels(replica=str(idx)).inc()
            t_att = time.monotonic()
            outcome = self._stream_from(
                rid, view.endpoint, prompt + emitted,
                max_new - len(emitted), temperature, deadline,
                emitted, emit_observed, session_id=session_id,
                tenant=tenant, slo=slo)
            _rt.span(rid, "DISPATCH", t_att, time.monotonic(),
                     {"replica": idx, "outcome": outcome["kind"]})
            if outcome["kind"] == "done":
                if session_id:
                    # Shadow the lease the replica just formed so the
                    # session's next turn pins here even if it lands
                    # before the next healthz scrape.
                    view.sessions.add(session_id)
                return {"status": "completed", "retries": retries,
                        "tokens": emitted, "replica": idx,
                        **outcome.get("meta", {})}
            if outcome["kind"] == "deadline":
                return {"status": "expired", "error": DEADLINE_ERROR,
                        "retries": retries, "tokens": emitted}
            if outcome["kind"] == "bad_request":
                return {"status": "bad_request",
                        "error": outcome["error"],
                        "retries": retries, "tokens": emitted}
            # Retryable: crash/connect/queue_full/draining/failed.
            exclude[idx] = time.monotonic() + _EXCLUDE_S
            retry(outcome["kind"])
            if outcome["kind"] in ("crash", "connect"):
                phase = "midstream" if emitted else "prefill"
                self._m["failovers"].labels(phase=phase).inc()
                if t_fail is None:
                    t_fail = time.monotonic()
                    fail_phase, fail_from = phase, idx
                _log.warning(
                    "replica %d died %s request %s (%d tokens emitted)"
                    " — failing over", idx,
                    "mid-stream of" if emitted else "before first "
                    "token of", rid, len(emitted))

    def _stream_from(self, rid: str, ep: ReplicaEndpoint,
                     prompt: List[int], max_new: int,
                     temperature: Optional[float],
                     deadline: Optional[float], emitted: List[int],
                     emit, session_id: Optional[str] = None,
                     tenant: Optional[str] = None, slo=None) -> dict:
        """One dispatch attempt against one replica, streaming. Appends
        to ``emitted`` / calls ``emit`` as tokens land. Returns a
        tagged outcome: done / deadline / bad_request, or a retryable
        kind (connect, crash, queue_full, draining, failed)."""
        body = {"tokens": prompt, "max_new_tokens": max_new,
                "stream": True}
        if temperature is not None:
            body["temperature"] = temperature
        if session_id:
            body["session_id"] = session_id
        if tenant:
            body["tenant"] = tenant
        if slo is not None:
            body["slo"] = slo
        if deadline is not None:
            remaining_ms = (deadline - time.monotonic()) * 1e3
            if remaining_ms <= 0:
                return {"kind": "deadline"}
            body["deadline_ms"] = round(remaining_ms, 1)
        read_timeout = _STREAM_READ_S
        if deadline is not None:
            read_timeout = min(read_timeout, max(
                0.1, deadline - time.monotonic() + 1.0))
        try:
            conn = http.client.HTTPConnection(ep.host, ep.port,
                                              timeout=read_timeout)
            try:
                conn.request(
                    "POST", "/generate", json.dumps(body),
                    {"Content-Type": "application/json",
                     "X-Request-Id": rid})
                resp = conn.getresponse()
                if resp.status == 429:
                    resp.read()
                    return {"kind": "queue_full"}
                if resp.status == 503:
                    resp.read()
                    return {"kind": "draining"}
                if resp.status == 400:
                    err = resp.read().decode(errors="replace")
                    return {"kind": "bad_request", "error": err}
                if resp.status == 504:
                    resp.read()
                    return {"kind": "deadline"}
                if resp.status != 200:
                    resp.read()
                    return {"kind": "failed"}
                saw_done = False
                while True:
                    line = resp.readline()
                    if not line:
                        break
                    line = line.strip()
                    if not line:
                        continue
                    obj = json.loads(line)
                    if "t" in obj:
                        emitted.append(int(obj["t"]))
                        emit(int(obj["t"]))
                    elif obj.get("done"):
                        saw_done = True
                        if obj.get("status") == "completed":
                            return {"kind": "done", "meta": {
                                k: obj[k] for k in ("ttft_ms",
                                                    "latency_ms",
                                                    "tenant", "slo")
                                if k in obj}}
                        if DEADLINE_ERROR in str(obj.get("error")):
                            return {"kind": "deadline"}
                        return {"kind": "failed"}
                if not saw_done:
                    # Stream broke without a terminal line: the
                    # replica died under this request.
                    return {"kind": "crash"}
                return {"kind": "failed"}
            finally:
                conn.close()
        except (http.client.HTTPException, TimeoutError, OSError,
                ValueError):
            # Connection refused/reset, torn JSON line (killed
            # mid-write), read timeout: all read as replica loss. If
            # the status line never arrived, the request may not have
            # been admitted at all — still safe to retry, generation
            # is idempotent (greedy) or re-sampled (temperature).
            return {"kind": "crash" if emitted else "connect"}

    # ---------------------------------------------------------- HTTP

    def _build_http(self, host: str, port: int) -> None:
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, payload: dict,
                       headers: Optional[dict] = None) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?")[0]
                if path == "/healthz":
                    with outer._views_lock:
                        views = list(outer._views.values())
                    self._reply(200, {
                        "status": "routing",
                        "replicas": [{
                            "index": v.endpoint.index,
                            "port": v.endpoint.port,
                            "ready": v.ready,
                            "queue_depth": v.queue_depth,
                            "active": v.active,
                            "slots": v.slots,
                            "score": round(v.score, 4),
                        } for v in views],
                        "ready_replicas": sum(
                            1 for v in views if v.ready),
                    })
                    return
                if path == "/readyz":
                    with outer._views_lock:
                        n = sum(1 for v in outer._views.values()
                                if v.ready)
                    if n > 0:
                        self._reply(200, {"status": "ready",
                                          "ready_replicas": n})
                    else:
                        self._reply(503, {"status": "no ready "
                                                    "replicas"})
                    return
                self._reply(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802 (http.server API)
                if self.path.split("?")[0] != "/generate":
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    tokens = body["tokens"]
                    if not isinstance(tokens, list) or not tokens:
                        raise ValueError(
                            "'tokens' must be a non-empty list")
                    tokens = [int(t) for t in tokens]
                    max_new = int(body.get("max_new_tokens", 64))
                    temperature = body.get("temperature")
                    stream = bool(body.get("stream", False))
                    deadline_ms = body.get(
                        "deadline_ms",
                        self.headers.get("X-Request-Deadline-Ms"))
                    # Tenant + SLO attribution (docs/serving.md#slo):
                    # validated here so a malformed "slo" is a 400 at
                    # the front door, not a retry storm.
                    tenant = self.headers.get("X-Tenant") \
                        or body.get("tenant")
                    slo_req = body.get("slo")
                    _slo.parse_slo(slo_req)
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    outer._m["requests"].labels(
                        outcome="bad_request").inc()
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                deadline = None
                if deadline_ms not in (None, ""):
                    deadline = time.monotonic() \
                        + float(deadline_ms) / 1e3
                else:
                    deadline = time.monotonic() + ROUTER_TIMEOUT_S
                # The request's ONE trace id: the client's, if it
                # brought one, else freshly minted — reused verbatim on
                # every retry and failover hop from here on.
                rid = str(self.headers.get("X-Request-Id")
                          or body.get("request_id")
                          or outer._request_id())
                if tenant:
                    # Front-door token-rate quota (docs/serving.md#
                    # qos): enforced here so a fleet of N replicas
                    # cannot multiply a tenant's quota by N via
                    # retries; Retry-After from the tenant's own
                    # measured drain rate.
                    label = _slo.resolve_tenant(tenant)
                    retry = outer._quota.admit(
                        label, len(tokens) + max_new)
                    if retry is not None:
                        outer._m["requests"].labels(
                            outcome="rejected").inc()
                        outer._m["shed"].labels(reason="quota").inc()
                        _slo.record_shed(label, "shed")
                        self._reply(
                            429,
                            {"error": "tenant over token-rate quota",
                             "trace_id": rid},
                            headers={"Retry-After": retry})
                        return
                sid = self.headers.get("X-Session-Id") \
                    or body.get("session_id")
                sid = str(sid) if sid else None
                if stream:
                    self._do_stream(rid, tokens, max_new, temperature,
                                    deadline, sid, tenant, slo_req)
                else:
                    self._do_unary(rid, tokens, max_new, temperature,
                                   deadline, sid, tenant, slo_req)

            def _do_unary(self, rid, tokens, max_new, temperature,
                          deadline, session_id=None, tenant=None,
                          slo=None) -> None:
                t0 = time.perf_counter()
                meta = outer._relay(rid, tokens, max_new, temperature,
                                    deadline, emit=lambda t: None,
                                    session_id=session_id,
                                    tenant=tenant, slo=slo)
                outer._count(meta["status"])
                if meta["status"] == "completed":
                    t_egress = time.monotonic()
                    reply = {
                        "id": rid, "trace_id": rid,
                        "tokens": meta["tokens"],
                        "retries": meta["retries"],
                        "replica": meta.get("replica"),
                        "latency_ms": round(
                            (time.perf_counter() - t0) * 1e3, 3)}
                    egress_args = {"tokens": len(meta["tokens"])}
                    if "ttft_ms" in meta:
                        reply["ttft_ms"] = meta["ttft_ms"]
                    if "tenant" in meta:
                        reply["tenant"] = meta["tenant"]
                        egress_args["tenant"] = meta["tenant"]
                    if "slo" in meta:
                        reply["slo"] = meta["slo"]
                        if isinstance(meta["slo"], dict):
                            egress_args["slo_met"] = \
                                meta["slo"].get("slo_met")
                    self._reply(200, reply)
                    _rt.span(rid, "EGRESS", t_egress,
                             time.monotonic(), egress_args)
                elif meta["status"] == "expired":
                    self._reply(504, {"error": DEADLINE_ERROR,
                                      "trace_id": rid,
                                      "retries": meta["retries"]})
                elif meta["status"] == "bad_request":
                    self._reply(400, {"error": meta["error"],
                                      "trace_id": rid})
                else:
                    self._reply(503, {"error": meta["error"],
                                      "trace_id": rid,
                                      "retries": meta["retries"]},
                                headers={"Retry-After": 1})

            def _do_stream(self, rid, tokens, max_new, temperature,
                           deadline, session_id=None, tenant=None,
                           slo=None) -> None:
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/x-ndjson")
                self.send_header("Cache-Control", "no-store")
                self.close_connection = True
                self.end_headers()

                def line(obj) -> None:
                    self.wfile.write(
                        json.dumps(obj).encode() + b"\n")
                    self.wfile.flush()

                try:
                    line({"id": rid, "trace_id": rid})
                    meta = outer._relay(
                        rid, tokens, max_new, temperature, deadline,
                        emit=lambda t: line({"t": t}),
                        session_id=session_id,
                        tenant=tenant, slo=slo)
                    outer._count(meta["status"])
                    done = {"done": True,
                            "status": ("completed"
                                       if meta["status"] == "completed"
                                       else "failed"),
                            "n": len(meta["tokens"]),
                            "trace_id": rid,
                            "retries": meta["retries"]}
                    for k in ("ttft_ms", "latency_ms", "tenant",
                              "slo"):
                        if k in meta:
                            done[k] = meta[k]
                    if meta["status"] != "completed":
                        done["error"] = meta.get("error")
                    line(done)
                except (BrokenPipeError, ConnectionResetError,
                        OSError):
                    pass   # client hung up; nothing to unwind

            def log_message(self, *args):  # silence per-request stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="hvd-tpu-fleet-router", daemon=True)

    def _request_id(self) -> str:
        """Mint a trace id: globally unique (uuid) with a short local
        sequence suffix for log readability."""
        with self._id_lock:
            n = self._next_id
            self._next_id += 1
        return f"{uuid.uuid4().hex[:12]}-{n}"

    def _count(self, status: str) -> None:
        outcome = {"completed": "completed", "expired": "expired",
                   "bad_request": "bad_request"}.get(status, "failed")
        self._m["requests"].labels(outcome=outcome).inc()

    # ------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._scrape_cycle()   # one synchronous pass: never route blind
        self._scrape_thread = threading.Thread(
            target=self._scrape_loop, name="hvd-tpu-fleet-scrape",
            daemon=True)
        self._scrape_thread.start()
        self._http_thread.start()
        _log.info("fleet router on :%d (%d replica(s) scraped)",
                  self.port, len(self._views))

    def shutdown(self) -> None:
        self._stop.set()
        if self._scrape_thread is not None:
            self._scrape_thread.join(timeout=5.0)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._http_thread.join(timeout=5.0)
