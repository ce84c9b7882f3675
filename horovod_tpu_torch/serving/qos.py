"""Multi-tenant QoS plane (docs/serving.md#qos): priority classes,
deficit-weighted-round-robin admission, deadline-aware shedding,
token-rate quotas, and SLO-driven fleet autoscaling.

Counterpart of ``horovod_tpu/serving/qos.py``, copied: the same
decisions for the same inputs. Under strict-FIFO admission a bulk burst
inflates an interactive tenant's TTFT tail; this module is the control
plane against that:

* :class:`QosPolicy` maps tenants to priority classes via the same
  ``HOROVOD_TPU_SLO_CONFIG`` file the SLO plane reads — tenant rows
  grow optional ``priority`` / ``weight`` / ``quota_tokens_per_s``
  fields (:data:`QOS_CONFIG_FIELDS`, stripped before SLO parsing so
  old configs stay valid).
* :class:`ClassQueues` replaces the engine's single FIFO admission
  queue with per-class queues drained under deficit-weighted round
  robin (DWRR): every backlogged class earns deficit each round in
  proportion to its weight, so interactive gets most admissions while
  bulk can never be starved outright.
* :func:`shed_decision` / :func:`predict_prefill_s` decide, *before*
  prefill, whether a deadline can still be met given the measured
  per-bucket prefill EWMA plus a minimum decode budget — requests that
  would 504 anyway are shed at the queue head instead of burning a
  batch slot.
* :class:`QuotaLedger` enforces per-tenant token-rate quotas with a
  token bucket and computes Retry-After from the tenant's *own
  measured drain rate* (tokens actually completed per second), not the
  global queue estimate.
* :class:`AutoscalerState` is the pure hysteresis state machine
  (sustain / cooldown clocks) that turns load
  pressure + health alerts into scale-up/down decisions;
  :class:`FleetAutoscaler` is the supervisor-side thread that feeds it
  and applies decisions via ``Fleet.scale_to``.

Everything here is host-side stdlib Python. The autoscaler classes are
driven by the fleet supervisor (``python -m horovod_tpu_torch.serving
--fleet N --autoscale-max M``).
"""

from __future__ import annotations

import collections
import json
import logging
import math
import threading
import time
from typing import (Callable, Deque, Dict, Iterator, List, Mapping,
                    Optional, Sequence, Tuple)

from ..utils import env as _env

_log = logging.getLogger(__name__)

# Priority classes in descending priority order.  The first class is
# the "top" class batch-slot reservations protect (docs/serving.md#qos).
PRIORITY_CLASSES = ("interactive", "default", "bulk")
DEFAULT_CLASS = "default"
TOP_CLASS = PRIORITY_CLASSES[0]

# Default DWRR weights per class when the config row names a priority
# but no explicit weight.
DEFAULT_WEIGHTS = {"interactive": 4.0, "default": 2.0, "bulk": 1.0}

# Tenant-row fields owned by the QoS plane.  slo.SloPolicy strips
# these before parse_slo() so extending a config with QoS fields never
# invalidates the SLO half of the file.
QOS_CONFIG_FIELDS = ("priority", "weight", "quota_tokens_per_s")

# Per-class floor on quota Retry-After seconds: bulk clients are told
# to back off longer so interactive retries drain first.
RETRY_AFTER_FLOOR_S = {"interactive": 1, "default": 1, "bulk": 4}
RETRY_AFTER_CAP_S = 60


def class_rank(name: str) -> int:
    """Position in :data:`PRIORITY_CLASSES` (lower = higher priority);
    unknown names rank with ``default``."""
    try:
        return PRIORITY_CLASSES.index(name)
    except ValueError:
        return PRIORITY_CLASSES.index(DEFAULT_CLASS)


class TenantQos:
    """Resolved QoS spec for one tenant: priority class, DWRR weight,
    optional token-rate quota."""

    __slots__ = ("priority", "weight", "quota_tokens_per_s")

    def __init__(self, priority: str = DEFAULT_CLASS,
                 weight: Optional[float] = None,
                 quota_tokens_per_s: Optional[float] = None):
        if priority not in PRIORITY_CLASSES:
            raise ValueError(
                "unknown priority class %r (expected one of %s)"
                % (priority, ", ".join(PRIORITY_CLASSES)))
        if weight is not None and not weight > 0:
            raise ValueError("weight must be > 0, got %r" % (weight,))
        if quota_tokens_per_s is not None and not quota_tokens_per_s > 0:
            raise ValueError("quota_tokens_per_s must be > 0, got %r"
                             % (quota_tokens_per_s,))
        self.priority = priority
        self.weight = (float(weight) if weight is not None
                       else DEFAULT_WEIGHTS[priority])
        self.quota_tokens_per_s = (
            float(quota_tokens_per_s)
            if quota_tokens_per_s is not None else None)

    def to_dict(self) -> dict:
        d = {"priority": self.priority, "weight": self.weight}
        if self.quota_tokens_per_s is not None:
            d["quota_tokens_per_s"] = self.quota_tokens_per_s
        return d


def _parse_row(row: object) -> Optional[TenantQos]:
    """Extract the QoS half of one tenant config row; None when the
    row carries no QoS fields (tenant rides the default spec)."""
    if not isinstance(row, dict):
        return None
    if not any(k in row for k in QOS_CONFIG_FIELDS):
        return None
    return TenantQos(
        priority=str(row.get("priority", DEFAULT_CLASS)),
        weight=row.get("weight"),
        quota_tokens_per_s=row.get("quota_tokens_per_s"))


class QosPolicy:
    """Tenant → QoS class/weight/quota mapping, loaded from the same
    ``HOROVOD_TPU_SLO_CONFIG`` file as :class:`..slo.SloPolicy`.  A
    malformed file degrades to everything-default with a warning — the
    QoS plane must never take the serving path down."""

    def __init__(self, config_path: Optional[str] = None):
        self.tenants: Dict[str, TenantQos] = {}
        self.default = TenantQos()
        path = config_path if config_path is not None else _env.slo_config()
        if not path:
            return
        try:
            with open(path) as f:
                doc = json.load(f)
            for name, row in (doc.get("tenants") or {}).items():
                spec = _parse_row(row)
                if spec is not None:
                    self.tenants[str(name)] = spec
            d = _parse_row(doc.get("default"))
            if d is not None:
                self.default = d
        except (OSError, ValueError) as e:
            _log.warning("ignoring QoS config %s: %s", path, e)
            self.tenants = {}
            self.default = TenantQos()

    def spec_of(self, tenant: Optional[str]) -> TenantQos:
        if tenant is not None and tenant in self.tenants:
            return self.tenants[tenant]
        return self.default

    def class_of(self, tenant: Optional[str]) -> str:
        return self.spec_of(tenant).priority

    def quota_of(self, tenant: Optional[str]) -> Optional[float]:
        return self.spec_of(tenant).quota_tokens_per_s

    def class_weights(self) -> Dict[str, float]:
        """Effective DWRR weight per priority class: the max weight of
        any tenant mapped there (plus the default spec), so a class's
        share follows the most-privileged tenant the operator put in
        it."""
        w = {c: 0.0 for c in PRIORITY_CLASSES}
        for spec in list(self.tenants.values()) + [self.default]:
            w[spec.priority] = max(w[spec.priority], spec.weight)
        for c in PRIORITY_CLASSES:
            if w[c] <= 0:
                w[c] = DEFAULT_WEIGHTS[c]
        return w


_policy: Optional[QosPolicy] = None
_policy_lock = threading.Lock()


def policy() -> QosPolicy:
    """Process-wide QoS policy singleton (mirrors ``slo.policy()``)."""
    global _policy
    with _policy_lock:
        if _policy is None:
            _policy = QosPolicy()
        return _policy


def _reset_policy() -> None:
    global _policy
    with _policy_lock:
        _policy = None


# --------------------------------------------------------------------------
# Deficit-weighted round-robin admission queues
# --------------------------------------------------------------------------

class ClassQueues:
    """Per-priority-class FIFO queues drained under DWRR.

    Drop-in replacement surface for the engine's single ``deque``:
    ``append`` / ``__len__`` / ``__bool__`` / ``__iter__`` (class
    order, FIFO within class).  Selection happens through
    :meth:`select`, which pops the next request per DWRR among classes
    an ``allowed`` predicate admits; :meth:`pushback` returns a popped
    request to its queue head (and refunds its deficit) when admission
    fails downstream, e.g. on KV-pool exhaustion.

    DWRR mechanics: each class carries a deficit counter.  When no
    eligible backlogged class has deficit >= 1 (one request costs 1),
    every eligible backlogged class is replenished by its weight —
    so over a saturated period admissions per class converge to the
    weight ratio, and any backlogged class with weight > 0 is served
    within one round (no starvation).  Deficit resets when a class
    empties (standard DWRR) so idle classes cannot bank credit.
    """

    def __init__(self, weights: Optional[Mapping[str, float]] = None):
        w = dict(DEFAULT_WEIGHTS)
        if weights:
            for k, v in weights.items():
                if k in w and v > 0:
                    w[k] = float(v)
        self._weights = w
        self._q: Dict[str, Deque[object]] = {
            c: collections.deque() for c in PRIORITY_CLASSES}
        self._deficit: Dict[str, float] = {
            c: 0.0 for c in PRIORITY_CLASSES}
        self._cursor = 0

    def append(self, req: object,
               qos_class: Optional[str] = None) -> None:
        cls = qos_class or getattr(req, "qos_class", None) or DEFAULT_CLASS
        if cls not in self._q:
            cls = DEFAULT_CLASS
        self._q[cls].append(req)

    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())

    def __bool__(self) -> bool:
        return any(self._q.values())

    def __iter__(self) -> Iterator[object]:
        for c in PRIORITY_CLASSES:
            yield from self._q[c]

    def depths(self) -> Dict[str, int]:
        return {c: len(q) for c, q in self._q.items()}

    def heads(self) -> List[object]:
        """Current head request of each non-empty class (priority
        order) — the shed/expiry scan looks here."""
        return [q[0] for q in self._q.values() if q]

    def remove(self, req: object) -> bool:
        """Remove a specific queued request (expiry/shed at any class
        head); True when found."""
        for c, q in self._q.items():
            try:
                q.remove(req)
            except ValueError:
                continue
            if not q:
                self._deficit[c] = 0.0
            return True
        return False

    def select(self, allowed: Optional[Callable[[str], bool]] = None
               ) -> Optional[object]:
        """Pop the next request under DWRR among non-empty classes
        passing ``allowed`` (None = all).  Returns None when nothing
        is eligible."""
        eligible = [c for c in PRIORITY_CLASSES
                    if self._q[c] and (allowed is None or allowed(c))]
        if not eligible:
            return None
        n = len(PRIORITY_CLASSES)
        for _round in range(2):
            for off in range(n):
                c = PRIORITY_CLASSES[(self._cursor + off) % n]
                if c not in eligible:
                    continue
                if self._deficit[c] >= 1.0:
                    self._deficit[c] -= 1.0
                    req = self._q[c].popleft()
                    if not self._q[c]:
                        self._deficit[c] = 0.0
                    self._cursor = (self._cursor + off) % n
                    setattr(req, "qos_class", c)
                    return req
            # No eligible class had deficit — replenish proportionally
            # to weight, scaled so the heaviest eligible class reaches
            # a full quantum in one round (fractional weights stay
            # proportional but cannot stall the loop).
            need = 1.0 - max(self._deficit[c] for c in eligible)
            fastest = max(self._weights[c] for c in eligible)
            k = max(1, int(math.ceil(need / fastest)))
            for c in eligible:
                self._deficit[c] += k * self._weights[c]
        return None  # pragma: no cover - unreachable with weights > 0

    def pushback(self, req: object) -> None:
        """Return a just-selected request to its queue head and refund
        the deficit it consumed (admission failed downstream)."""
        cls = getattr(req, "qos_class", None) or DEFAULT_CLASS
        if cls not in self._q:
            cls = DEFAULT_CLASS
        self._q[cls].appendleft(req)
        self._deficit[cls] += 1.0


# --------------------------------------------------------------------------
# Deadline-aware shedding
# --------------------------------------------------------------------------

def predict_prefill_s(n_tokens: int,
                      ewma_by_bucket: Mapping[int, float],
                      bucket_of: Callable[[int], int],
                      chunk_tokens: int = 0) -> float:
    """Predicted prefill seconds for a prompt of ``n_tokens`` from a
    per-bucket cost EWMA.

    Monolithic path (``chunk_tokens == 0``): cost of the prompt's
    padding bucket.  Chunked path: per-chunk cost of the chunk bucket
    times the number of chunks.  Unmeasured buckets fall back to the
    largest measured bucket's cost scaled by the bucket ratio (an
    optimistic-but-monotone estimate); with no measurements at all the
    prediction is 0.0 — shedding stays off until the EWMA warms up,
    because shedding on a guess converts servable requests into 504s.
    """
    if n_tokens <= 0:
        return 0.0
    if chunk_tokens and chunk_tokens > 0:
        n_chunks = (n_tokens + chunk_tokens - 1) // chunk_tokens
        per = _bucket_cost(bucket_of(chunk_tokens), ewma_by_bucket)
        return n_chunks * per
    return _bucket_cost(bucket_of(n_tokens), ewma_by_bucket)


def _bucket_cost(bucket: int,
                 ewma_by_bucket: Mapping[int, float]) -> float:
    if not ewma_by_bucket:
        return 0.0
    v = ewma_by_bucket.get(bucket)
    if v is not None:
        return v
    # Scale the largest measured bucket linearly — prefill cost grows
    # at least linearly in padded length, so this under-estimates
    # (sheds conservatively) rather than over-sheds.
    largest = max(ewma_by_bucket)
    return ewma_by_bucket[largest] * (bucket / float(largest))


def shed_decision(remaining_s: float, predicted_prefill_s: float,
                  min_decode_s: float) -> bool:
    """True when a deadline-carrying request should be shed before
    prefill: the remaining budget cannot cover predicted prefill plus
    one minimum decode step, so it would 504 after burning a slot.
    With no measurements yet (both predictions 0) never shed."""
    need = predicted_prefill_s + min_decode_s
    if need <= 0.0:
        return False
    return remaining_s < need


# --------------------------------------------------------------------------
# Per-tenant token-rate quotas + measured drain rate
# --------------------------------------------------------------------------

class _TokenBucket:
    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.t_last = now

    def _refill(self, now: float) -> None:
        dt = max(0.0, now - self.t_last)
        self.t_last = now
        self.tokens = min(self.burst, self.tokens + dt * self.rate)

    def take(self, n: float, now: float) -> float:
        """Deduct ``n`` tokens if available; returns 0.0 on success,
        else the deficit (tokens short) with no deduction."""
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        return n - self.tokens


# Drain-rate observation window: long enough to smooth decode-tick
# granularity, short enough to track a throttled tenant's real rate.
_DRAIN_WINDOW_S = 30.0


class QuotaLedger:
    """Token-rate quota enforcement plus per-tenant measured drain
    rates (docs/serving.md#qos).

    ``admit`` charges ``prompt + max_new_tokens`` against the tenant's
    bucket (burst = 2s of rate, so short bursts ride through).  On
    rejection the Retry-After is ``deficit / drain_rate`` where
    ``drain_rate`` is the tenant's *own measured* completion rate over
    the last 30s — a tenant the fleet is actually serving quickly gets
    a short backoff; one whose work is crawling gets an honest long
    one.  Tenants with no completions yet fall back to the quota rate
    itself.  The result is clamped to a per-class floor
    (:data:`RETRY_AFTER_FLOOR_S`) and :data:`RETRY_AFTER_CAP_S`."""

    def __init__(self, qos_policy: Optional[QosPolicy] = None):
        self._policy = qos_policy
        self._buckets: Dict[str, _TokenBucket] = {}
        self._done: Dict[str, Deque[Tuple[float, float]]] = {}
        self._lock = threading.Lock()

    def _spec(self, tenant: Optional[str]) -> TenantQos:
        pol = self._policy if self._policy is not None else policy()
        return pol.spec_of(tenant)

    def admit(self, tenant: Optional[str], tokens: float,
              now: Optional[float] = None) -> Optional[int]:
        """Charge ``tokens`` against the tenant's quota.  None = admitted
        (or no quota configured); otherwise the Retry-After seconds to
        return with the 429."""
        spec = self._spec(tenant)
        rate = spec.quota_tokens_per_s
        if rate is None or tenant is None:
            return None
        now = time.monotonic() if now is None else now
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None or b.rate != rate:
                b = _TokenBucket(rate, burst=2.0 * rate, now=now)
                self._buckets[tenant] = b
            deficit = b.take(float(tokens), now)
        if deficit <= 0.0:
            return None
        return self.retry_after_s(tenant, deficit, now=now)

    def note_completion(self, tenant: Optional[str], tokens: float,
                        now: Optional[float] = None) -> None:
        """Record ``tokens`` drained (prompt + generated) for the
        tenant's measured-rate window."""
        if tenant is None or tokens <= 0:
            return
        now = time.monotonic() if now is None else now
        with self._lock:
            dq = self._done.setdefault(tenant, collections.deque())
            dq.append((now, float(tokens)))
            while dq and dq[0][0] < now - _DRAIN_WINDOW_S:
                dq.popleft()

    def drain_rate(self, tenant: Optional[str],
                   now: Optional[float] = None) -> Optional[float]:
        """Tenant's measured completion rate (tokens/s) over the last
        30s; None with no completions in window."""
        if tenant is None:
            return None
        now = time.monotonic() if now is None else now
        with self._lock:
            dq = self._done.get(tenant)
            if not dq:
                return None
            while dq and dq[0][0] < now - _DRAIN_WINDOW_S:
                dq.popleft()
            if not dq:
                return None
            total = sum(n for _, n in dq)
            span = max(1.0, now - dq[0][0])
        return total / span

    def retry_after_s(self, tenant: Optional[str], deficit: float,
                      now: Optional[float] = None) -> int:
        """Seconds until ``deficit`` tokens plausibly drain for this
        tenant: measured drain rate first, quota rate as fallback,
        clamped to the class floor and the global cap."""
        spec = self._spec(tenant)
        rate = self.drain_rate(tenant, now=now)
        if rate is None or rate <= 0:
            rate = spec.quota_tokens_per_s or 1.0
        floor = RETRY_AFTER_FLOOR_S.get(spec.priority, 1)
        return max(floor, min(RETRY_AFTER_CAP_S,
                              int(math.ceil(deficit / rate))))


class QuotaExceededError(Exception):
    """Request rejected by per-tenant token-rate quota; carries the
    Retry-After seconds computed from the tenant's drain rate."""

    def __init__(self, retry_after_s: int, tenant: Optional[str] = None):
        super().__init__("tenant %s over token-rate quota" % (tenant,))
        self.retry_after_s = int(retry_after_s)
        self.tenant = tenant


# --------------------------------------------------------------------------
# SLO-driven fleet autoscaling
# --------------------------------------------------------------------------

class AutoscalerConfig:
    """Hysteresis knobs for the fleet autoscaler (a ladder pattern:
    sustain window to escalate, cooldown window to de-escalate,
    clocks reset on every action)."""

    def __init__(self, min_replicas: int, max_replicas: int, *,
                 high_load: float = 1.5, low_load: float = 0.25,
                 sustain_s: float = 3.0, cooldown_s: float = 15.0,
                 alert_hold_s: float = 10.0,
                 ttft_target_ms: Optional[float] = None):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.high_load = high_load    # outstanding work per slot
        self.low_load = low_load
        self.sustain_s = sustain_s
        self.cooldown_s = cooldown_s
        self.alert_hold_s = alert_hold_s
        self.ttft_target_ms = ttft_target_ms


class AutoscalerState:
    """Pure scale-decision state machine — no threads, no I/O, fed by
    :meth:`observe` with the current signals and a monotonic clock so
    tests can drive it deterministically.

    Scale up when pressure (per-slot load above ``high_load``, a held
    ``queue_depth_runaway`` alert, Retry-After/429 pressure, or TTFT
    p99 over target) is sustained for ``sustain_s``.  Scale down when
    load stays under ``low_load`` with no pressure for ``cooldown_s``.
    Both clocks reset after every decision, and a decision names the
    dominant signal as ``why`` for the flight recorder / metrics
    label."""

    SCALE_UP_WHYS = ("queue_runaway", "ttft_trend", "retry_pressure",
                     "queue_depth")

    def __init__(self, config: AutoscalerConfig):
        self.config = config
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._alert_until = 0.0
        self._alert_kind: Optional[str] = None

    def note_alert(self, kind: str, now: float) -> None:
        """Hold a health-plane alert (e.g. ``queue_depth_runaway``) as
        scale-up pressure for ``alert_hold_s``."""
        self._alert_until = now + self.config.alert_hold_s
        self._alert_kind = kind

    def observe(self, now: float, n_replicas: int,
                load_per_slot: float,
                retry_pressure: float = 0.0,
                ttft_p99_ms: Optional[float] = None) -> Optional[dict]:
        """Feed one signal sample; returns a decision dict
        ``{"direction": "up"|"down", "why": ..., "n": target}`` or
        None.  ``load_per_slot`` is outstanding work (active+queued)
        per batch slot across ready replicas; ``retry_pressure`` is
        recent 429/queue-full events per second observed at the
        router."""
        c = self.config
        alert_held = now < self._alert_until
        ttft_high = (c.ttft_target_ms is not None
                     and ttft_p99_ms is not None
                     and ttft_p99_ms > c.ttft_target_ms)
        why = None
        if alert_held:
            why = "queue_runaway"
        elif ttft_high:
            why = "ttft_trend"
        elif retry_pressure > 0.0:
            why = "retry_pressure"
        elif load_per_slot > c.high_load:
            why = "queue_depth"
        pressure = why is not None

        if pressure:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            if (now - self._above_since >= c.sustain_s
                    and n_replicas < c.max_replicas):
                self._above_since = None
                return {"direction": "up", "why": why,
                        "n": n_replicas + 1}
            return None

        self._above_since = None
        if load_per_slot < c.low_load:
            if self._below_since is None:
                self._below_since = now
            if (now - self._below_since >= c.cooldown_s
                    and n_replicas > c.min_replicas):
                self._below_since = None
                return {"direction": "down", "why": "recovered",
                        "n": n_replicas - 1}
        else:
            self._below_since = None
        return None


class FleetAutoscaler:
    """Supervisor-side autoscaling thread: polls a signal source
    (normally ``Router.qos_signals``), feeds :class:`AutoscalerState`,
    and applies decisions through ``fleet.scale_to`` — recording each
    as a flight-recorder ``qos`` event plus
    ``hvdtpu_fleet_scale_events_total{direction,why}``
    (docs/serving.md#qos)."""

    def __init__(self, fleet, config: AutoscalerConfig, *,
                 signals: Optional[Callable[[], dict]] = None,
                 interval_s: float = 1.0):
        self.fleet = fleet
        self.state = AutoscalerState(config)
        self.interval_s = interval_s
        self._signals = signals
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.decisions: List[dict] = []
        from ..observability import registry as _reg
        self._m_events = _reg.registry().counter(
            "hvdtpu_fleet_scale_events_total",
            "Autoscaler scale decisions applied, by direction "
            "(up/down) and dominant signal (docs/serving.md#qos)")
        self._m_target = _reg.registry().gauge(
            "hvdtpu_fleet_target_replicas",
            "Replica count the QoS autoscaler is currently steering "
            "the fleet toward (docs/serving.md#qos)")

    def note_alert(self, kind: str) -> None:
        """Health-plane alert sink hookup (``Fleet`` forwards
        ``queue_depth_runaway`` here)."""
        self.state.note_alert(kind, time.monotonic())

    def _default_signals(self) -> dict:
        views = self.fleet.load_views()
        slots = sum(v.get("slots", 0) for v in views) or 1
        work = sum(v.get("active", 0) + v.get("queue_depth", 0)
                   for v in views)
        return {"load_per_slot": work / float(slots),
                "n_replicas": max(1, len(views))}

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """One observe/act cycle (also called directly by tests)."""
        now = time.monotonic() if now is None else now
        try:
            sig = (self._signals or self._default_signals)()
        except Exception as e:  # pragma: no cover - defensive
            _log.debug("autoscaler signal source failed: %s", e)
            return None
        n = int(sig.get("n_replicas") or self.fleet.live_count())
        decision = self.state.observe(
            now, n,
            float(sig.get("load_per_slot", 0.0)),
            retry_pressure=float(sig.get("retry_pressure", 0.0)),
            ttft_p99_ms=sig.get("ttft_p99_ms"))
        if decision is None:
            return None
        try:
            self.fleet.scale_to(decision["n"])
        except Exception as e:
            _log.warning("autoscaler scale_to(%d) failed: %s",
                         decision["n"], e)
            return None
        self.decisions.append(decision)
        self._m_events.labels(direction=decision["direction"],
                              why=decision["why"]).inc()
        self._m_target.set(decision["n"])
        from ..observability import flight_note
        flight_note("qos", ("scale", decision["direction"],
                            decision["why"], decision["n"]))
        _log.info("qos autoscale %s -> %d replicas (%s)",
                  decision["direction"], decision["n"],
                  decision["why"])
        return decision

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._m_target.set(self.fleet.live_count())
        self._thread = threading.Thread(
            target=self._run, name="hvd-tpu-qos-autoscaler",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
