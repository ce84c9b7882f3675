"""The global autotune driver — closes the observe -> tune loop.

Counterpart of ``horovod_tpu/autotune/driver.py``: the same moves and
verdicts on the same measurements.

One search space over every perf knob (knobs.py), scored on MEASURED
windowed step time read from the ``observability/history`` series, with
a safe online apply plane (apply.py) and a health-plane guard: every
move is recorded in the flight recorder, scored against a pre-move
baseline with the same relative-regression comparison ``tools/health
--baseline`` uses, and automatically rolled back when the step-time
regression detector (observability/health.EwmaDetector) fires or the
post-move window regresses beyond the guard threshold
(docs/autotune.md).

Two operating modes share the scoring machinery:

  - ONLINE (:meth:`AutoTuner.run`): coordinate sweep over the knobs the
    apply plane can flip on a live job (wire spec / fusion threshold
    via coordinator-stamped epochs, torch bucket size at a step
    boundary, cycle time live). Each candidate value is one guarded
    move.
  - OFFLINE / per-trial (:func:`search.successive_halving` via
    :meth:`AutoTuner.tune_rebuild`): the ``rebuild`` safety class
    (pipeline schedule, microbatch count) is scored by rebuilding the
    train step per trial, JAX's cold-start search over schedule x
    microbatches (``experiments/mesh_parity.py`` variant ``autotune``
    drives it on the pipelined step).

Scores are negative mean step seconds — higher is better, matching the
legacy GP log convention so its seeds compose (gp.py).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..utils import env as _env
from .knobs import Knob, KnobRegistry, default_registry
from .search import Trial, enumerate_configs, successive_halving

_log = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Metrics (docs/metrics.md#autotuner)
# --------------------------------------------------------------------------


class _Metrics:
    _instance = None

    def __init__(self):
        from ..observability import registry as _obs
        r = _obs.registry()
        self.trials = r.counter(
            "hvdtpu_autotune_trials_total",
            "Scored autotuner trials, by knob (or 'joint' for the "
            "multi-knob rebuild search)")
        self.moves = r.counter(
            "hvdtpu_autotune_moves_total",
            "Online autotuner moves by knob and outcome: kept (clear "
            "win), reverted (no win), rolled_back (guard fired)")
        self.rollbacks = r.counter(
            "hvdtpu_autotune_rollbacks_total",
            "Guard-triggered rollbacks — the post-move window tripped "
            "the step-time regression detector or the baseline "
            "comparison")
        self.score = r.gauge(
            "hvdtpu_autotune_score",
            "Last trial score per knob (negative mean step seconds — "
            "higher is better)")
        self.best = r.gauge(
            "hvdtpu_autotune_best_score",
            "Best score the tuner has measured so far this run")

    @classmethod
    def get(cls) -> "_Metrics":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance


def _note(event: str, knob: str, value, score, baseline, detail: str = ""):
    from ..observability import flight_recorder as _fr
    _fr.recorder().note("autotune", (
        event, knob, str(value),
        None if score is None else round(float(score), 6),
        None if baseline is None else round(float(baseline), 6),
        detail))


# --------------------------------------------------------------------------
# Step-time source: the history plane's series
# --------------------------------------------------------------------------


class WindowedStepTime:
    """Mean step time over the most recent window of the persisted
    ``hvdtpu_step_seconds|mean`` history series (the history plane's
    on-disk time-series, in JAX's format) — the measurement the tuner
    scores moves on."""

    FAMILY = "hvdtpu_step_seconds"

    def __init__(self, inputs: Sequence[str], *, window: int = 8):
        self.inputs = list(inputs)
        self.window = int(window)

    def read(self) -> Optional[float]:
        from ..observability import history as _history
        from ..observability.health import split_series_key
        try:
            files = _history.load_history(self.inputs)
        except FileNotFoundError:
            return None
        vals: List[float] = []
        for hf in files:
            for key, pts in hf.series().items():
                family, _, suffix = split_series_key(key)
                if family == self.FAMILY and suffix == "mean":
                    vals.extend(v for _, v in pts[-self.window:])
        if not vals:
            return None
        return sum(vals) / len(vals)


# --------------------------------------------------------------------------
# The tuner
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Move:
    """One guarded online move and its verdict."""

    knob: str
    old: Any
    new: Any
    baseline_s: Optional[float]
    after_s: Optional[float]
    outcome: str          # "kept" | "reverted" | "rolled_back"
    detail: str = ""


class AutoTuner:
    """Coordinate-sweep online tuner + per-trial rebuild search.

    Args:
      registry: the knob space (default: :func:`knobs.default_registry`).
      plane: an :class:`apply.ApplyPlane` wiring knobs to live
        subsystems; knobs whose mechanism the plane does not support
        are skipped online.
      measure: ``measure(budget_windows) -> step_seconds`` — blocks
        until ``budget_windows`` fresh measurement windows landed and
        returns their mean step time (see :class:`WindowedStepTime`).
      guard_rel: post-move window worse than baseline by more than this
        fraction => rollback (the ``tools/health --baseline`` regression
        threshold); default ``HOROVOD_TPU_AUTOTUNE_GUARD_REL`` (0.10).
      min_rel_gain: keep a move only if it improves step time by at
        least this fraction; anything in between is reverted (no
        free-riding on noise).
      trial_budget: measurement windows per scored candidate; default
        ``HOROVOD_TPU_AUTOTUNE_TRIAL_BUDGET`` (2).
      seed_log: optional legacy Bayesian tuner CSV
        (``HOROVOD_AUTOTUNE_LOG``) to warm-start continuous knobs.
    """

    def __init__(self, registry: Optional[KnobRegistry] = None, *,
                 plane=None,
                 measure: Optional[Callable[[int], Optional[float]]] = None,
                 guard_rel: Optional[float] = None,
                 min_rel_gain: float = 0.02,
                 trial_budget: Optional[int] = None,
                 seed_log: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        from .apply import ApplyPlane
        from ..observability.health import EwmaDetector
        self.registry = registry or default_registry()
        self.plane = plane or ApplyPlane()
        self.measure = measure or (lambda budget: None)
        self.guard_rel = float(_env.autotune_guard_rel()
                               if guard_rel is None else guard_rel)
        self.min_rel_gain = float(min_rel_gain)
        self.trial_budget = int(_env.autotune_trial_budget()
                                if trial_budget is None else trial_budget)
        self.clock = clock
        self.current: Dict[str, Any] = self.registry.defaults()
        self.moves: List[Move] = []
        self.best_score: Optional[float] = None
        # The step-time regression detector: same shape the history
        # plane runs on hvdtpu_step_seconds|mean (health.default_specs).
        self._detector = EwmaDetector("up", min_rel=0.15)
        self._gp = self._seed_gp(seed_log)

    def _seed_gp(self, seed_log):
        from .gp import GaussianProcess, seed_gp_for_cycle_time
        cont = self.registry.continuous()
        if not cont:
            return None
        gp = GaussianProcess([k.domain for k in cont])
        if seed_log and len(cont) == 1 and cont[0].name == "cycle_time_ms":
            n = seed_gp_for_cycle_time(gp, seed_log)
            if n:
                _log.info("autotune: seeded cycle-time GP with %d "
                          "legacy-log points", n)
                _note("gp_seed", "cycle_time_ms", n, None, None,
                      seed_log)
        return gp

    # ------------------------------------------------------- measurement

    def _window(self) -> Optional[float]:
        v = self.measure(self.trial_budget)
        if v is not None:
            self._detector.update(self.clock(), float(v))
        return v

    def _score(self, knob_name: str, step_s: Optional[float]) -> float:
        score = float("-inf") if step_s is None else -float(step_s)
        m = _Metrics.get()
        m.trials.labels(knob=knob_name).inc()
        if step_s is not None:
            m.score.labels(knob=knob_name).set(score)
            if self.best_score is None or score > self.best_score:
                self.best_score = score
                m.best.labels().set(score)
        return score

    # ------------------------------------------------------ online moves

    def try_move(self, knob_name: str, value) -> Move:
        """Apply one value through the safe plane, score the post-move
        window against the pre-move baseline, keep / revert / roll
        back. The guard fires on either the detector or the baseline
        comparison — belt and braces, exactly one rollback."""
        knob = self.registry.get(knob_name)
        old = self.current[knob_name]
        value = knob.clamp(value)
        baseline = self._window()
        _note("move", knob_name, value, None, baseline, f"from={old!r}")
        self.plane.apply(knob, value)
        self.current[knob_name] = value
        after = self._window()
        fired = (after is not None and baseline is not None
                 and after > baseline * (1.0 + self.guard_rel))
        det = None
        if after is not None:
            det = self._detector.update(self.clock(), float(after))
        self._score(knob_name, after)
        m = _Metrics.get()
        if fired or det is not None:
            # ROLLBACK: restore the pre-move value through the same
            # mechanism (a wire knob re-stamps an epoch, a bucket knob
            # re-partitions back) and record the guard verdict.
            self.plane.apply(knob, old)
            self.current[knob_name] = old
            detail = ("detector" if det is not None else
                      f"+{(after - baseline) / baseline:.1%}")
            move = Move(knob_name, old, value, baseline, after,
                        "rolled_back", detail)
            m.rollbacks.labels(knob=knob_name).inc()
            m.moves.labels(knob=knob_name, outcome="rolled_back").inc()
            _note("rollback", knob_name, old,
                  None if after is None else -after, baseline, detail)
        elif (after is not None and baseline is not None
              and after <= baseline * (1.0 - self.min_rel_gain)):
            move = Move(knob_name, old, value, baseline, after, "kept")
            m.moves.labels(knob=knob_name, outcome="kept").inc()
            _note("keep", knob_name, value, -after, baseline)
        else:
            self.plane.apply(knob, old)
            self.current[knob_name] = old
            move = Move(knob_name, old, value, baseline, after,
                        "reverted", "no_gain")
            m.moves.labels(knob=knob_name, outcome="reverted").inc()
            _note("revert", knob_name, old,
                  None if after is None else -after, baseline)
        self.moves.append(move)
        return move

    def run(self, knob_names: Optional[Sequence[str]] = None
            ) -> List[Move]:
        """One full online pass: every discrete knob the plane can
        apply, domain values in order, each a guarded move; continuous
        knobs take one GP suggestion each."""
        out: List[Move] = []
        names = (list(knob_names) if knob_names is not None
                 else self.registry.names())
        for name in names:
            knob = self.registry.get(name)
            if not self.plane.supports(knob):
                continue
            if knob.kind == "discrete":
                for v in knob.domain:
                    if v == self.current[name]:
                        continue
                    out.append(self.try_move(name, v))
            elif self._gp is not None:
                cont = [k.name for k in self.registry.continuous()]
                x = self._gp.suggest()
                v = x[cont.index(name)]
                move = self.try_move(name, v)
                if move.after_s is not None:
                    self._gp.observe(x, -move.after_s)
                out.append(move)
        _note("pass_done", "all", len(out), self.best_score, None)
        return out

    # -------------------------------------------------- rebuild knobs

    def tune_rebuild(self, score_fn: Callable[[Dict, int], float], *,
                     knob_names: Sequence[str] = ("pipeline_schedule",
                                                  "num_microbatches"),
                     constraint: Optional[Callable] = None,
                     eta: int = 2):
        """Successive halving over the ``rebuild`` knobs: each
        candidate is scored by rebuilding the train step
        (``score_fn(config, budget) -> score``, higher is better).
        Returns ``(best_config, trials)`` and records every trial."""
        knobs = [self.registry.get(n) for n in knob_names]
        candidates = enumerate_configs(knobs, constraint=constraint)
        m = _Metrics.get()

        def scored(cfg: Dict, budget: int) -> float:
            s = float(score_fn(cfg, budget))
            m.trials.labels(knob="joint").inc()
            m.score.labels(knob="joint").set(s)
            if self.best_score is None or s > self.best_score:
                self.best_score = s
                m.best.labels().set(s)
            _note("trial", "joint", cfg, s, None, f"budget={budget}")
            return s

        best, trials = successive_halving(
            candidates, scored, eta=eta,
            base_budget=max(1, self.trial_budget))
        self.current.update(best)
        _note("converged", "joint", best,
              max(t.score for t in trials), None,
              f"trials={len(trials)}")
        return best, trials
