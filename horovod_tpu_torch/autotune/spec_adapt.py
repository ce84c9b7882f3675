"""Per-slot adaptive speculative-decode draft length. Counterpart of
``horovod_tpu/autotune/spec_adapt.py``, copied.

The ``spec_tokens`` knob is the one knob the global tuner does NOT move
centrally: the right draft length depends on how well the drafter
predicts THIS request's continuation, a signal only the serving engine
sees and only per slot. So the knob's safety class is ``slot`` and this
controller owns it (docs/autotune.md):

  - each slot keeps an EWMA of its draft-acceptance rate (fraction of
    proposed draft tokens the target verified);
  - acceptance below the backoff threshold halves ``k_eff``
    (multiplicative decrease — a cold or mismatched drafter quickly
    lands at k=1, where the engine falls back to the plain decode path
    and stops paying the verify-width tax entirely);
  - acceptance above the raise threshold adds one (additive increase,
    AIMD-style, up to the configured cap);
  - at k=1 the engine calls :meth:`note_plain_step` each plain decode
    step; every ``probe_every`` such steps the controller probes back
    to k=2 so a recovered drafter is re-discovered without a central
    tuner move.

The engine verifies at ``width = max(k_eff)`` over the batch and caps
each slot's accepted run at its own ``k_eff`` — slots never pay for a
neighbour's optimism beyond the shared verify width.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable


@dataclasses.dataclass
class _SlotState:
    k_eff: int
    ewma: float
    plain_steps: int = 0


class SpecTokensController:
    """AIMD controller over per-slot speculative draft length."""

    def __init__(self, k_max: int, *, alpha: float = 0.5,
                 backoff_below: float = 0.25, raise_above: float = 0.6,
                 probe_every: int = 16):
        if k_max < 1:
            raise ValueError("k_max must be >= 1")
        self.k_max = int(k_max)
        self.alpha = float(alpha)
        self.backoff_below = float(backoff_below)
        self.raise_above = float(raise_above)
        self.probe_every = int(probe_every)
        self._slots: Dict[int, _SlotState] = {}
        self._metrics = None

    # ------------------------------------------------------------ state

    def _state(self, slot: int) -> _SlotState:
        st = self._slots.get(slot)
        if st is None:
            # Optimistic start: run at the configured k until the
            # acceptance signal says otherwise.
            st = _SlotState(k_eff=self.k_max, ewma=1.0)
            self._slots[slot] = st
        return st

    def slot_k(self, slot: int) -> int:
        return self._state(slot).k_eff

    def width(self, slots: Iterable[int]) -> int:
        """Verify width for one spec step: the max k over the batch
        (1 when every slot has backed off — the engine then takes the
        plain decode path)."""
        ks = [self._state(s).k_eff for s in slots]
        return max(ks) if ks else self.k_max

    def reset(self, slot: int) -> None:
        self._slots.pop(slot, None)

    # ---------------------------------------------------------- signals

    def observe(self, slot: int, proposed: int, accepted: int) -> int:
        """Feed one spec step's outcome for one slot; returns the
        slot's (possibly adjusted) k_eff."""
        st = self._state(slot)
        if proposed > 0:
            rate = min(max(accepted / proposed, 0.0), 1.0)
            st.ewma = self.alpha * rate + (1.0 - self.alpha) * st.ewma
        old = st.k_eff
        if st.ewma < self.backoff_below:
            st.k_eff = max(1, st.k_eff // 2)
            if st.k_eff != old:
                self._record(slot, st, old, "spec_backoff", "down")
        elif st.ewma > self.raise_above and st.k_eff < self.k_max:
            st.k_eff = st.k_eff + 1
            self._record(slot, st, old, "spec_raise", "up")
        st.plain_steps = 0
        return st.k_eff

    def note_plain_step(self, slot: int) -> int:
        """Tick the probe clock while a slot decodes plainly at k=1;
        after ``probe_every`` plain steps, probe back to k=2 (with a
        half-reset EWMA so one good probe can keep climbing)."""
        st = self._state(slot)
        if st.k_eff > 1:
            return st.k_eff
        st.plain_steps += 1
        if st.plain_steps >= self.probe_every:
            old = st.k_eff
            st.k_eff = min(2, self.k_max)
            st.ewma = max(st.ewma, 0.5)
            st.plain_steps = 0
            if st.k_eff != old:
                self._record(slot, st, old, "spec_probe", "probe")
        return st.k_eff

    # -------------------------------------------------------- telemetry

    def _record(self, slot: int, st: _SlotState, old: int,
                event: str, direction: str) -> None:
        from ..observability import flight_note
        flight_note("autotune", (event, "spec_tokens", str(st.k_eff),
                                 round(st.ewma, 4), float(old),
                                 f"slot={slot}"))
        try:
            m = self._metrics
            if m is None:
                from ..observability import registry as _obs
                r = _obs.registry()
                m = self._metrics = (
                    r.gauge("hvdtpu_autotune_spec_k",
                            "Adaptive speculative draft length across "
                            "serving slots (stat=min|max)"),
                    r.counter("hvdtpu_autotune_spec_moves_total",
                              "Per-slot spec_tokens adjustments by "
                              "direction (up, down, probe)"))
            gauge, counter = m
            ks = [s.k_eff for s in self._slots.values()]
            gauge.labels(stat="min").set(float(min(ks)))
            gauge.labels(stat="max").set(float(max(ks)))
            counter.labels(direction=direction).inc()
        except Exception:  # pragma: no cover
            pass
