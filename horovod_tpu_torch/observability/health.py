"""Online anomaly detection over the telemetry history window.

Counterpart of ``horovod_tpu/observability/health.py``, copied: the
same detectors, alert kinds and thresholds, so both packages fire the
same alerts at the same samples of the same series. The history sampler
(``history.py``) reduces each window to flat series; three detector
families watch them:

  - :class:`EwmaDetector`: a robust EWMA z-score for level shifts (step
    time, MFU, collective share), winsorized at 3 sigma.
  - :class:`TrendDetector`: a Theil-Sen slope behind a Mann-Kendall gate
    for monotone drifts (an HBM leak, a serving queue running away).
  - :class:`RateDetector`: windowed event counts for spikes (replica
    restarts, worker failures).

A fired :class:`Alert` lands in the flight recorder (an ``alert``
event), ``hvdtpu_health_alerts_total{kind,severity}``, a
``health_alert`` log line, an optional sink (the fleet forwards
``queue_depth_runaway`` to its autoscaler) and, on rank 0 or the fleet
supervisor, an optional webhook POST (``HOROVOD_TPU_ALERT_URL``).
Ladder-input kinds queue for an adaptation policy
(:func:`drain_policy_alerts`); JAX's forwarding of them to the rank-0
coordinator waits for the port's policy (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import math
import statistics
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..utils import env as _env
from . import registry as _reg

_log = logging.getLogger(__name__)

# Every alert kind the plane can fire. The drift test asserts each is
# documented in docs/health.md and registers its metric label.
ALERT_KINDS = (
    "step_time_regression",   # windowed step time shifted up
    "mfu_droop",              # model-FLOPs utilization shifted down
    "collective_share_creep", # collective share of step time shifted up
    "hbm_leak",               # device memory in monotone growth
    "queue_depth_runaway",    # serving queue depth in monotone growth
    "restart_spike",          # replica restarts / worker failures spiking
    "nonfinite_rate",         # NaN/Inf elements seen in local payloads
    "grad_norm_explosion",    # global gradient norm shifted up
    "loss_spike",             # loss value shifted up
    "rank_divergence",        # param fingerprints disagree across ranks
    "quantization_drift",     # EF residual norm in monotone growth
)

# Kinds the adaptation policy consumes as ladder inputs.
# quantization_drift is the QUALITY direction: instead of clamping
# lateness, the policy backs the quantized wire off to fp32
# (adaptation/policy.py, docs/numerics.md#drift).
POLICY_ALERT_KINDS = ("step_time_regression", "hbm_leak",
                      "quantization_drift")


@dataclasses.dataclass
class Alert:
    """One typed health alert — everything a responder (or the
    adaptation policy) needs without re-reading the history."""

    kind: str
    severity: str              # "warning" | "critical"
    series: str                # the series key that tripped
    rank: int = -1             # offending rank (-1: not a training rank)
    replica: int = -1          # offending serving replica (-1: n/a)
    value: float = 0.0         # the observation that tripped
    baseline: float = 0.0      # what the detector expected
    window_s: float = 0.0      # the window the detector judged over
    t_unix: float = 0.0
    evidence: dict = dataclasses.field(default_factory=dict)

    @property
    def message(self) -> str:
        who = (f"replica {self.replica}" if self.replica >= 0
               else f"rank {self.rank}" if self.rank >= 0 else "process")
        return (f"{self.kind} on {who}: {self.series} = "
                f"{self.value:.6g} vs baseline {self.baseline:.6g} "
                f"over {self.window_s:.0f}s")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["message"] = self.message
        return d


# --------------------------------------------------------------------------
# Detectors — pure, deterministically-testable state machines
# --------------------------------------------------------------------------

class EwmaDetector:
    """Robust EWMA z-score level-shift detector.

    ``direction="up"`` fires on sustained increases (latency,
    share), ``"down"`` on decreases (MFU). A trip requires BOTH a
    z-score above ``z_threshold`` (deviation dominates the noise
    floor) and a relative/absolute change above ``min_rel`` /
    ``min_abs`` (a dead-quiet series must not alert over nanoseconds).
    """

    def __init__(self, direction: str = "up", *, alpha: float = 0.25,
                 z_threshold: float = 4.0, min_rel: float = 0.2,
                 min_abs: float = 0.0, min_baseline: float = 0.0,
                 warmup: int = 5):
        if direction not in ("up", "down"):
            raise ValueError(f"direction must be up/down, got {direction}")
        self.direction = direction
        self.alpha = alpha
        self.z_threshold = z_threshold
        self.min_rel = min_rel
        self.min_abs = min_abs
        # Below this baseline the detector holds fire: a share/MFU
        # gauge sitting at ~0 during job bring-up "shifts" infinitely
        # in relative terms the moment real work starts — that is
        # cold start, not a regression.
        self.min_baseline = min_baseline
        self.warmup = max(2, warmup)
        self._mean: Optional[float] = None
        self._dev = 0.0
        self._n = 0
        self._t0: Optional[float] = None
        self._warm: List[float] = []

    def update(self, t: float, v: float) -> Optional[dict]:
        if self._mean is None:
            # Baseline bootstrap: hold fire through the warmup window,
            # then initialize from its MEDIAN and MAD — a first-sample
            # init would let one compile-spike sample poison the
            # baseline for the rest of the run (the EWMA then glides
            # down through a later genuine shift without ever firing).
            if self._t0 is None:
                self._t0 = t
            self._warm.append(v)
            self._n += 1
            if self._n >= self.warmup:
                self._mean = statistics.median(self._warm)
                self._dev = statistics.median(
                    abs(x - self._mean) for x in self._warm)
                self._warm = []
            return None
        mean, dev = self._mean, self._dev
        delta = v - mean
        signed = delta if self.direction == "up" else -delta
        # Noise floor: the EWMA absolute residual, with a relative
        # epsilon so a near-constant series doesn't divide by ~0.
        scale = max(dev, abs(mean) * 1e-3, 1e-12)
        z = signed / scale
        rel = signed / abs(mean) if mean else float("inf")
        fired = None
        if (self._n >= self.warmup and z >= self.z_threshold
                and signed >= self.min_abs
                and abs(mean) >= self.min_baseline
                and (rel >= self.min_rel or abs(mean) == 0.0)):
            fired = {"z": round(z, 2), "baseline": mean,
                     "deviation": dev, "rel_change": round(rel, 4),
                     "window_s": t - (self._t0 or t)}
        # Winsorized update: clamp the sample at 3 scale units so one
        # outlier (or the first windows of a real shift) can't yank the
        # baseline to the new level instantly.
        clipped = mean + max(-3.0 * scale, min(3.0 * scale, delta))
        self._mean = mean + self.alpha * (clipped - mean)
        self._dev = ((1 - self.alpha) * dev
                     + self.alpha * abs(clipped - self._mean))
        self._n += 1
        return fired


class TrendDetector:
    """Theil–Sen monotone-trend detector over a bounded window.

    Fires when the median pairwise slope projects growth over the
    window that (a) exceeds ``min_rel`` of the window median (or
    ``min_abs``), and (b) dominates the residual noise by ``snr``
    — the false-positive guard a plain "is it higher than before"
    check lacks: a noisy-but-flat series has residual MAD of the same
    order as any apparent growth and stays quiet."""

    def __init__(self, *, window: int = 12, min_points: int = 8,
                 min_rel: float = 0.05, min_abs: float = 0.0,
                 snr: float = 4.0, mk_z: float = 3.0):
        self.window = window
        self.min_points = max(3, min_points)
        self.min_rel = min_rel
        self.min_abs = min_abs
        self.snr = snr
        self.mk_z = mk_z
        self._pts: Deque[Tuple[float, float]] = collections.deque(
            maxlen=window)

    def update(self, t: float, v: float) -> Optional[dict]:
        self._pts.append((t, v))
        if len(self._pts) < self.min_points:
            return None
        pts = list(self._pts)
        slopes = []
        mk_s = 0
        for i in range(len(pts)):
            ti, vi = pts[i]
            for j in range(i + 1, len(pts)):
                tj, vj = pts[j]
                if tj > ti:
                    slopes.append((vj - vi) / (tj - ti))
                mk_s += (vj > vi) - (vj < vi)
        if not slopes:
            return None
        # Mann–Kendall monotonicity gate: a genuine drift has nearly
        # every pair ordered (S → n(n-1)/2, z large); pure noise has
        # S ≈ 0. This is what keeps a long noisy-flat series quiet
        # even when one window's Theil–Sen slope happens to look big.
        n = len(pts)
        mk_var = n * (n - 1) * (2 * n + 5) / 18.0
        z = (mk_s - 1) / math.sqrt(mk_var) if mk_var > 0 else 0.0
        if z < self.mk_z:
            return None
        slope = statistics.median(slopes)
        if slope <= 0:
            return None
        span = pts[-1][0] - pts[0][0]
        growth = slope * span
        t_med = statistics.median(p[0] for p in pts)
        v_med = statistics.median(p[1] for p in pts)
        resid = [abs(v - (v_med + slope * (tt - t_med)))
                 for tt, v in pts]
        mad = statistics.median(resid)
        floor = max(self.min_rel * abs(v_med), self.min_abs,
                    self.snr * mad, 1e-12)
        if growth > floor:
            return {"slope_per_s": slope, "growth": growth,
                    "baseline": pts[0][1], "residual_mad": mad,
                    "mk_z": round(z, 2), "window_s": span}
        return None


class RateDetector:
    """Windowed event-count spike detector over a *rate* series (the
    history reduction of a counter). Fires when at least ``threshold``
    events landed within the trailing ``window_s``."""

    def __init__(self, *, threshold: float = 3.0,
                 window_s: float = 600.0):
        self.threshold = threshold
        self.window_s = window_s
        self._events: Deque[Tuple[float, float]] = collections.deque()
        self._last_t: Optional[float] = None

    def update(self, t: float, rate: float) -> Optional[dict]:
        dt = (t - self._last_t) if self._last_t is not None else 0.0
        self._last_t = t
        n = max(0.0, rate) * max(dt, 0.0)
        if n > 0:
            self._events.append((t, n))
        while self._events and t - self._events[0][0] > self.window_s:
            self._events.popleft()
        total = sum(n for _, n in self._events)
        if total >= self.threshold:
            return {"events": round(total, 3),
                    "window_s": min(self.window_s,
                                    t - self._events[0][0]
                                    if self._events else 0.0),
                    "baseline": 0.0}
        return None


# --------------------------------------------------------------------------
# Series matching
# --------------------------------------------------------------------------

def split_series_key(key: str) -> Tuple[str, str, str]:
    """``family{labels}|suffix`` → (family, label_block, suffix)."""
    base, _, suffix = key.partition("|")
    fam, _, labels = base.partition("{")
    return fam, labels.rstrip("}"), suffix


@dataclasses.dataclass(frozen=True)
class DetectorSpec:
    """One alert kind: which series it watches and how."""

    kind: str
    severity: str
    families: Tuple[str, ...]     # exact family names
    suffix: str                   # "" for gauges/counters, "mean"/...
    factory: Callable[[], object]
    labels: str = ""              # required label fragment ("" = any)

    def matches(self, key: str) -> bool:
        fam, label_block, suffix = split_series_key(key)
        if self.labels and self.labels not in label_block:
            return False
        return fam in self.families and suffix == self.suffix


def default_specs() -> List[DetectorSpec]:
    """The stock detector plane (docs/health.md#detectors)."""
    return [
        DetectorSpec(
            "step_time_regression", "warning",
            ("hvdtpu_step_seconds",), "mean",
            lambda: EwmaDetector("up", min_rel=0.15)),
        DetectorSpec(
            "mfu_droop", "warning",
            ("hvdtpu_mfu",), "",
            lambda: EwmaDetector("down", min_rel=0.1, min_abs=0.01,
                                 min_baseline=0.01)),
        DetectorSpec(
            "collective_share_creep", "warning",
            ("hvdtpu_collective_step_share",), "",
            lambda: EwmaDetector("up", min_rel=0.15, min_abs=0.05,
                                 min_baseline=0.02)),
        DetectorSpec(
            "hbm_leak", "critical",
            ("hvdtpu_hbm_bytes_in_use",), "",
            lambda: TrendDetector(min_rel=0.02)),
        DetectorSpec(
            "queue_depth_runaway", "critical",
            ("hvdtpu_serving_queue_depth",
             "hvdtpu_fleet_replica_queue_depth"), "",
            lambda: TrendDetector(min_rel=0.5, min_abs=4.0)),
        DetectorSpec(
            "restart_spike", "critical",
            ("hvdtpu_fleet_replica_restarts_total",
             "hvdtpu_elastic_worker_failures_total"), "",
            lambda: RateDetector(threshold=3.0, window_s=600.0)),
        # ---- numerics plane (docs/numerics.md#detectors) ----
        # The windowed twin of the same-step sentinel: even if the
        # immediate alert was refire-suppressed, a sustained nonfinite
        # stream shows up in the counter's rate series.
        DetectorSpec(
            "nonfinite_rate", "critical",
            ("hvdtpu_numerics_nonfinite_total",), "",
            lambda: RateDetector(threshold=1.0, window_s=120.0)),
        DetectorSpec(
            "grad_norm_explosion", "critical",
            ("hvdtpu_numerics_grad_norm",), "",
            lambda: EwmaDetector("up", min_rel=1.0, z_threshold=6.0)),
        DetectorSpec(
            "loss_spike", "warning",
            ("hvdtpu_numerics_loss",), "",
            lambda: EwmaDetector("up", min_rel=0.5, z_threshold=6.0)),
        DetectorSpec(
            "quantization_drift", "warning",
            ("hvdtpu_numerics_ef_residual_norm",), "",
            lambda: TrendDetector(min_rel=0.2)),
        # Windowed backstop for the same-step divergence alert rank 0
        # fires from record_fingerprint: any mismatch event in the
        # counter's rate series pages, even if the immediate alert was
        # refire-suppressed. The label filter keeps the routine
        # computed/compared event rates from matching.
        DetectorSpec(
            "rank_divergence", "critical",
            ("hvdtpu_numerics_fingerprints_total",), "",
            lambda: RateDetector(threshold=1.0, window_s=600.0),
            labels='event="mismatch"'),
    ]


# --------------------------------------------------------------------------
# The monitor
# --------------------------------------------------------------------------

# Alerts an adaptation policy should see, fed by every local monitor and
# cleared by whoever drains them.
_policy_alerts: Deque[dict] = collections.deque(maxlen=64)
_policy_lock = threading.Lock()


def queue_policy_alert(alert: "Alert") -> None:
    with _policy_lock:
        _policy_alerts.append(
            {"kind": alert.kind, "rank": alert.rank,
             "t_unix": alert.t_unix})


def drain_policy_alerts() -> List[dict]:
    """Pending ladder-input alerts (``{"kind", "rank", "t_unix"}``),
    cleared on read (JAX's coordinator policy consumes these; the
    port's waits for ROADMAP Queue 1 item 5)."""
    with _policy_lock:
        out = list(_policy_alerts)
        _policy_alerts.clear()
    return out


def post_webhook(url: str, payload: dict, timeout_s: float = 2.0) -> None:
    """Fire-and-forget alert POST (stdlib only): its own daemon thread,
    bounded timeout, errors logged once — telemetry must never stall
    the sampler or the job."""
    import urllib.request

    def _post():
        try:
            req = urllib.request.Request(
                url, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=timeout_s).close()
        except Exception as e:
            _log.warning("alert webhook POST failed: %s", e)

    threading.Thread(target=_post, name="hvd-tpu-alert-webhook",
                     daemon=True).start()


class HealthMonitor:
    """Routes live series through the detector specs and fans fired
    alerts out to the recorder/metrics/log/webhook/policy surfaces.

    ``emit=False`` collects alerts in ``self.alerts`` without side
    effects — the offline mode ``tools/health`` runs over merged
    history files. ``refire_s`` suppresses repeat alerts per
    (kind, series) so a sustained regression pages once per window,
    not once per sample."""

    def __init__(self, specs: Optional[List[DetectorSpec]] = None, *,
                 emit: bool = True, rank: int = -1, replica: int = -1,
                 webhook_url: Optional[str] = None,
                 refire_s: float = 60.0,
                 alert_sink: Optional[Callable[[Alert], None]] = None):
        self.specs = specs if specs is not None else default_specs()
        self.emit = emit
        self.rank = rank
        self.replica = replica
        self.webhook_url = webhook_url
        self.refire_s = refire_s
        self.alert_sink = alert_sink
        self.alerts: List[Alert] = []
        self._detectors: Dict[Tuple[int, str], object] = {}
        self._route: Dict[str, List[int]] = {}
        self._last_fire: Dict[Tuple[str, str], float] = {}
        self._m_alerts = _reg.registry().counter(
            "hvdtpu_health_alerts_total",
            "Health alerts fired by the online detector plane, by "
            "alert kind and severity (docs/health.md)")

    def observe(self, series: Dict[str, float], t: float,
                t_unix: Optional[float] = None) -> List[Alert]:
        """Feed one history sample's series; returns alerts fired."""
        fired: List[Alert] = []
        for key, v in series.items():
            if v is None:
                continue
            route = self._route.get(key)
            if route is None:
                route = [i for i, s in enumerate(self.specs)
                         if s.matches(key)]
                self._route[key] = route
            for i in route:
                spec = self.specs[i]
                det = self._detectors.get((i, key))
                if det is None:
                    det = spec.factory()
                    self._detectors[(i, key)] = det
                ev = det.update(t, float(v))
                if not ev:
                    continue
                last = self._last_fire.get((spec.kind, key))
                if last is not None and t - last < self.refire_s:
                    continue
                self._last_fire[(spec.kind, key)] = t
                fired.append(self._fire(spec, key, float(v), ev,
                                        t_unix if t_unix is not None
                                        else time.time()))
        return fired

    def fire(self, kind: str, severity: str, series: str, value: float,
             *, baseline: float = 0.0,
             evidence: Optional[dict] = None,
             t: Optional[float] = None,
             t_unix: Optional[float] = None) -> Optional[Alert]:
        """Fire a typed alert directly, bypassing the detector plane —
        the same fan-out (metric/recorder/log/policy/webhook) with the
        same per-(kind, series) refire suppression. The numerics
        plane's same-step sentinels (nonfinite payloads, fingerprint
        divergence) use this: their evidence is exact, not statistical,
        so no windowed detector should gate them. Returns None when
        refire-suppressed."""
        t = time.monotonic() if t is None else t
        last = self._last_fire.get((kind, series))
        if last is not None and t - last < self.refire_s:
            return None
        self._last_fire[(kind, series)] = t
        ev = dict(evidence or {})
        ev.setdefault("baseline", baseline)
        spec = DetectorSpec(kind, severity, (), "", lambda: None)
        return self._fire(spec, series, float(value), ev,
                          t_unix if t_unix is not None else time.time())

    def _fire(self, spec: DetectorSpec, key: str, value: float,
              evidence: dict, t_unix: float) -> Alert:
        alert = Alert(
            kind=spec.kind, severity=spec.severity, series=key,
            rank=self.rank, replica=self.replica, value=value,
            baseline=float(evidence.get("baseline", 0.0)),
            window_s=float(evidence.get("window_s", 0.0)),
            t_unix=t_unix, evidence=evidence)
        self.alerts.append(alert)
        if len(self.alerts) > 1024:
            del self.alerts[:512]
        if not self.emit:
            return alert
        self._m_alerts.labels(kind=alert.kind,
                              severity=alert.severity).inc()
        from . import flight_recorder as _flight
        _flight.recorder().note("alert", (
            alert.kind, alert.severity, alert.series,
            alert.replica if alert.replica >= 0 else alert.rank,
            round(alert.value, 6), round(alert.baseline, 6)))
        _log.warning(
            "health_alert kind=%s severity=%s series=%s rank=%d "
            "replica=%d value=%.6g baseline=%.6g window_s=%.1f",
            alert.kind, alert.severity, alert.series, alert.rank,
            alert.replica, alert.value, alert.baseline, alert.window_s)
        if alert.kind in POLICY_ALERT_KINDS:
            queue_policy_alert(alert)
        if self.alert_sink is not None:
            try:
                self.alert_sink(alert)
            except Exception as e:  # pragma: no cover - defensive
                _log.warning("alert sink failed: %s", e)
        if self.webhook_url:
            post_webhook(self.webhook_url, alert.to_dict())
        return alert


def default_monitor() -> HealthMonitor:
    """The live monitor ``init`` hands the history sampler: this
    process's rank, the webhook on rank 0 only (one receiver, not N
    copies). JAX's monitor also forwards ladder-input alerts to the
    rank-0 coordinator's adaptation policy; the port has no such policy
    yet (ROADMAP Queue 1 item 5), so they stay in the local queue
    (:func:`drain_policy_alerts`)."""
    from . import flight_recorder as _flight
    from .. import topology as _topo
    rank = (_topo._get().rank if _topo.is_initialized()
            else max(_flight.recorder().rank, 0))
    url = _env.alert_url() if rank == 0 else None
    return HealthMonitor(rank=rank, webhook_url=url)
