"""The closed-loop adaptation policy: rank 0's degradation ladder.

Counterpart of ``horovod_tpu/adaptation/policy.py``, copied: the same
ladder, hysteresis, metric families and ``adaptation_event`` lines. The
coordinator's skew tracker (``ops/control_plane.py``) elects a
straggler and measures its decay-weighted announce lateness; on
sustained lateness above a threshold the policy climbs

  ``shrink``      the fusion threshold divided by ``shrink_factor``
                  (smaller fused groups),
  ``bf16``        fused allreduce groups moved as bf16 casts,
  ``int8x256``    the block-scaled int8 wire,
  ``fp8x256``     the block-scaled fp8 wire,
  ``evict``       a ``slow_rank`` failure event: every engine fails its
                  pending handles with a typed ``SlowRankFailure`` and
                  the elastic driver re-rendezvouses without the host.

Escalation needs the lateness above ``threshold_s`` for ``sustain_s``
per step; de-escalation below ``threshold_s * deescalate_ratio`` for
``cooldown_s`` per step, in reverse order; between the bands both
clocks reset, so a borderline rank causes no flapping. Transitions are
``adaptation_event`` log lines, flight-recorder ``adapt`` events and
``hvdtpu_adaptation_*`` metrics.

:meth:`AdaptationPolicy.observe` is a pure state machine over the
lateness map and a clock; the coordinator applies its events.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

from ..observability import flight_recorder as _flight
from ..observability import registry as _obs
from ..utils import env as _env

_log = logging.getLogger(__name__)

# Ladder entries that select a wire transport (vs structural actions).
_WIRE_TIERS = ("bf16", "int8x256", "fp8x256")
DEFAULT_TIERS = ("shrink", "bf16", "int8x256", "fp8x256", "evict")


@dataclasses.dataclass
class AdaptationConfig:
    """Knobs of the degradation ladder (env: HOROVOD_TPU_ADAPT_*)."""

    threshold_s: float = 0.1       # lateness that starts the sustain clock
    sustain_s: float = 5.0         # above threshold this long per escalation
    cooldown_s: float = 30.0       # below the low band this long per de-esc
    interval_s: float = 1.0        # evaluation cadence
    deescalate_ratio: float = 0.5  # low band = threshold * ratio
    shrink_factor: int = 4         # fusion-threshold divisor for 'shrink'
    alert_hold_s: float = 30.0     # how long a health alert keeps pressure
    tiers: Tuple[str, ...] = DEFAULT_TIERS

    @classmethod
    def from_env(cls) -> "AdaptationConfig":
        tiers = _env.adapt_tiers()
        return cls(
            threshold_s=_env.adapt_threshold_s(),
            sustain_s=_env.adapt_sustain_s(),
            cooldown_s=_env.adapt_cooldown_s(),
            interval_s=_env.adapt_interval_s(),
            alert_hold_s=_env.adapt_alert_hold_s(),
            tiers=tuple(t.strip() for t in tiers.split(",") if t.strip())
            if tiers else DEFAULT_TIERS)


class AdaptationPolicy:
    """Hysteresis-guarded tier ladder over the straggler-lateness signal.

    ``tier`` is 0 (baseline) .. len(tiers); tier k means tiers[:k] are
    active. ``observe(lateness_by_rank, now)`` advances the state
    machine and returns the transitions taken this call as event dicts
    (``{"action", "tier", "name", "rank", "lateness_s"}``) — the
    coordinator applies them; tests drive it with synthetic clocks."""

    def __init__(self, config: Optional[AdaptationConfig] = None,
                 allow_evict: bool = True):
        self.config = config or AdaptationConfig()
        # Eviction needs the elastic failure plane (it kills the job on
        # a fixed-world run); the coordinator passes allow_evict=False
        # when HOROVOD_TPU_FAILURE_TIMEOUT is not armed.
        self.allow_evict = allow_evict
        self.tier = 0
        self.evicted: set = set()
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        r = _obs.registry()
        self._m_tier = r.gauge(
            "hvdtpu_adaptation_tier",
            "Active degradation tier (0 = baseline; N = the first N "
            "ladder entries are active)").labels()
        self._m_transitions = r.counter(
            "hvdtpu_adaptation_transitions_total",
            "Degradation-ladder transitions, by direction and tier name")
        self._m_lateness = r.gauge(
            "hvdtpu_adaptation_lateness_seconds",
            "Worst-rank decayed lateness at the last policy "
            "evaluation").labels()
        self._m_straggler = r.gauge(
            "hvdtpu_adaptation_straggler_rank",
            "Rank the policy currently considers the straggler "
            "(-1: none)").labels()
        self._m_wire = r.gauge(
            "hvdtpu_adaptation_wire_active",
            "1 for the wire spec the policy currently imposes on fused "
            "allreduce groups (raw = no override)")
        self._m_evictions = r.counter(
            "hvdtpu_adaptation_evictions_total",
            "Slow-rank evictions requested by the policy, by rank")
        self._m_alert_inputs = r.counter(
            "hvdtpu_adaptation_alert_inputs_total",
            "Health alerts consumed as ladder inputs, by alert kind "
            "(docs/health.md#adaptation)")
        self._m_tier.set(0)
        self._m_straggler.set(-1)
        self._set_wire_gauge()
        # Health-alert pressure (docs/health.md#adaptation): a
        # regression/leak alert keeps the named rank's effective
        # lateness at the threshold for alert_hold_s — it can START
        # the sustain clock but never bypass the hysteresis.
        self._alert_until: Dict[Tuple[str, int], float] = {}
        # quantization_drift quality backoff (docs/numerics.md#drift):
        # while this clock runs, the ladder refuses to re-enter a wire
        # tier — the lossy transport stays off until drift clears.
        self._wire_block_until: float = 0.0

    # ----------------------------------------------------------- derived

    def active_tiers(self) -> Tuple[str, ...]:
        return self.config.tiers[: self.tier]

    def wire_spec(self) -> Optional[str]:
        """Wire transport the current tier imposes (the STRONGEST active
        wire entry), or None for raw."""
        spec = None
        for t in self.active_tiers():
            if t in _WIRE_TIERS:
                spec = t
        return spec

    def shrink_active(self) -> bool:
        return "shrink" in self.active_tiers()

    def _set_wire_gauge(self) -> None:
        self._m_wire.clear()
        self._m_wire.labels(spec=self.wire_spec() or "raw").set(1)

    # ------------------------------------------------------------- alerts

    def note_alert(self, kind: str, rank: int, now: float) -> None:
        """Record one health alert (docs/health.md#adaptation) as
        ladder pressure: for ``alert_hold_s`` after this call the named
        rank's effective lateness is clamped to at least
        ``threshold_s``, so a sustained regression/leak walks the same
        hysteresis-guarded ladder as measured negotiate lateness — and
        a one-off alert that is not renewed decays without ever
        escalating. Unknown kinds are accepted (forward compat) but
        only regression/leak kinds are ever forwarded here.

        ``quantization_drift`` is special-cased as the QUALITY
        direction (docs/numerics.md#drift): the quantized wire is the
        suspected *cause*, so instead of adding escalation pressure the
        policy unwinds every active wire tier back to the raw fp32
        transport and blocks wire re-escalation for ``alert_hold_s``."""
        if str(kind) == "quantization_drift":
            self._m_alert_inputs.labels(kind=str(kind)).inc()
            self._quality_backoff(int(rank), now)
            return
        self._alert_until[(str(kind), int(rank))] = \
            now + self.config.alert_hold_s
        self._m_alert_inputs.labels(kind=str(kind)).inc()
        _log.warning(
            "adaptation_event action=alert_input kind=%s rank=%d",
            kind, rank)
        _flight.recorder().note("adapt", (
            "alert_input", self.tier, str(kind), int(rank), 0.0))

    def _quality_backoff(self, rank: int, now: float) -> None:
        """Back the quantized wire off to raw fp32: drop ladder tiers
        until no wire entry is active (structural tiers such as
        ``shrink`` below the wire rungs survive), and refuse to
        re-enter a wire tier until the block window expires. Repeated
        drift alerts renew the window, so a genuinely lossy wire stays
        off as long as the detector keeps firing."""
        self._wire_block_until = now + self.config.alert_hold_s
        new_tier = self.tier
        while new_tier > 0 and any(
                t in _WIRE_TIERS for t in self.config.tiers[:new_tier]):
            new_tier -= 1
        if new_tier == self.tier:
            _log.warning(
                "adaptation_event action=quality_block rank=%d "
                "hold_s=%.1f", rank, self.config.alert_hold_s)
            return
        dropped = self.config.tiers[new_tier:self.tier]
        self.tier = new_tier
        self._m_tier.set(self.tier)
        for name in dropped:
            self._m_transitions.labels(
                action="quality_backoff", tier=name).inc()
        self._set_wire_gauge()
        _log.warning(
            "adaptation_event action=quality_backoff tier=%d dropped=%s "
            "rank=%d hold_s=%.1f", self.tier, ",".join(dropped), rank,
            self.config.alert_hold_s)
        _flight.recorder().note("adapt", (
            "quality_backoff", self.tier, ",".join(dropped), rank, 0.0))

    def _alert_pressure(self, now: float) -> Dict[int, float]:
        """Per-rank synthetic lateness from alerts still inside their
        hold window (expired entries are pruned)."""
        expired = [k for k, until in self._alert_until.items()
                   if until < now]
        for k in expired:
            del self._alert_until[k]
        out: Dict[int, float] = {}
        for (_, rank), _until in self._alert_until.items():
            if rank >= 0:
                out[rank] = self.config.threshold_s
        return out

    # ------------------------------------------------------------- clock

    def observe(self, lateness_by_rank: Dict[int, float],
                now: float) -> List[dict]:
        """Advance the ladder given the current per-rank decayed
        lateness; returns the transition events taken (possibly empty,
        never more than one per call — one hysteresis window per
        step keeps the escalation rate bounded and observable)."""
        cfg = self.config
        merged = dict(lateness_by_rank)
        for rank, floor in self._alert_pressure(now).items():
            merged[rank] = max(merged.get(rank, 0.0), floor)
        live = {r: v for r, v in merged.items()
                if r not in self.evicted}
        worst_rank = max(live, key=live.get) if live else -1
        lateness = live.get(worst_rank, 0.0)
        self._m_lateness.set(lateness)
        self._m_straggler.set(worst_rank if lateness > 0 else -1)

        events: List[dict] = []
        if lateness >= cfg.threshold_s:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            elif now - self._above_since >= cfg.sustain_s:
                ev = self._escalate(worst_rank, lateness, now)
                if ev is not None:
                    events.append(ev)
                # Each further step needs its own full sustain window.
                self._above_since = now
        elif lateness < cfg.threshold_s * cfg.deescalate_ratio:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            elif now - self._below_since >= cfg.cooldown_s:
                ev = self._deescalate(lateness, now)
                if ev is not None:
                    events.append(ev)
                self._below_since = now
        else:
            # Hysteresis band: hold state, restart both clocks — a
            # borderline-slow rank neither escalates nor unwinds.
            self._above_since = None
            self._below_since = None
        return events

    def _escalate(self, rank: int, lateness: float, now: float
                  ) -> Optional[dict]:
        if self.tier >= len(self.config.tiers):
            return None
        name = self.config.tiers[self.tier]
        if name in _WIRE_TIERS and now < self._wire_block_until:
            # Quality backoff in force: the ladder is capped below the
            # wire rungs until the drift hold window expires.
            return None
        if name == "evict":
            if not self.allow_evict or rank < 0:
                return None   # ladder capped below eviction
            # Edge-triggered, NOT a persistent tier: the straggler is
            # removed from the signal, the degradation tiers below stay
            # until the cooldown unwinds them, and a SECOND straggler
            # sustaining lateness earns its own eviction after its own
            # sustain window.
            self.evicted.add(rank)
            self._m_evictions.labels(rank=str(rank)).inc()
            self._m_transitions.labels(action="escalate", tier=name).inc()
            _log.warning(
                "adaptation_event action=evict rank=%d lateness_ms=%.1f",
                rank, lateness * 1e3)
            _flight.recorder().note("adapt", (
                "evict", self.tier, name, rank,
                round(lateness * 1e3, 3)))
            return {"action": "escalate", "tier": self.tier,
                    "name": name, "rank": rank, "lateness_s": lateness}
        self.tier += 1
        self._m_tier.set(self.tier)
        self._m_transitions.labels(action="escalate", tier=name).inc()
        ev = {"action": "escalate", "tier": self.tier, "name": name,
              "rank": rank, "lateness_s": lateness}
        self._set_wire_gauge()
        _log.warning(
            "adaptation_event action=escalate tier=%d name=%s rank=%d "
            "lateness_ms=%.1f", self.tier, name, rank, lateness * 1e3)
        _flight.recorder().note("adapt", (
            "escalate", self.tier, name, rank, round(lateness * 1e3, 3)))
        return ev

    def _deescalate(self, lateness: float, now: float) -> Optional[dict]:
        if self.tier <= 0:
            return None
        name = self.config.tiers[self.tier - 1]
        if name == "evict":
            # Eviction is not unwound by the ladder — readmission is the
            # elastic driver's probe/backoff story (docs/elastic.md).
            return None
        self.tier -= 1
        self._m_tier.set(self.tier)
        self._m_transitions.labels(action="deescalate", tier=name).inc()
        self._set_wire_gauge()
        _log.warning(
            "adaptation_event action=deescalate tier=%d dropped=%s "
            "lateness_ms=%.1f", self.tier, name, lateness * 1e3)
        _flight.recorder().note("adapt", (
            "deescalate", self.tier, name, -1, round(lateness * 1e3, 3)))
        return {"action": "deescalate", "tier": self.tier, "name": name,
                "rank": -1, "lateness_s": lateness}
