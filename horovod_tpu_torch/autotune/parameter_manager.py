"""The engine's legacy Bayesian tuner (``HOROVOD_TPU_AUTOTUNE=1`` or
``HOROVOD_AUTOTUNE=1``).

Counterpart of the JAX package's native tuner
(``horovod_tpu/runtime/src/parameter_manager.{h,cc}``,
``bayesian_optimization.cc``), which runs in its C++ core; the port's
engine is Python, so the tuner is too, on :mod:`.gp`'s posterior. It
lives in rank 0's coordinator (``ops/control_plane.py``): each plan is
one cycle: rank 0's planner cuts every rank's groups with its fusion
threshold, each group carries its hierarchical flags, and the plan's
params carry its cycle time to every rank.

The same knobs and protocol as JAX's:

  - the fusion threshold (0-64 MB) and the cycle time (1-100 ms) by
    Bayesian optimization, one posterior per combination of the two
    hierarchical flags (allreduce, allgather), which are explored
    categorically on a mostly-flat schedule;
  - the score: bytes planned per microsecond of the cycles' wall time;
  - 10 cycles a sample, 3 warm-up samples dropped, the median of 5
    samples a step, at most 30 steps, then a freeze to the best point;
  - each step's median logged to ``HOROVOD_AUTOTUNE_LOG`` as
    ``fusion_mb,cycle_ms,hier_allreduce,hier_allgather,score``.

The next point maximizes expected improvement over 512 uniform draws
and three rounds of coordinate refinement around the best, as the C++
``BayesianOptimization::NextSample`` does; the draws come from numpy's
generator seeded per combination (the C++ one uses ``mt19937_64``, so
the points explored differ, not the protocol).
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from .gp import GaussianProcess

_log = logging.getLogger(__name__)

HEADER = "fusion_mb,cycle_ms,hier_allreduce,hier_allgather,score"
BOUNDS = ((0.0, 64.0), (1.0, 100.0))     # fusion MB, cycle ms
# Combination c: bit 1 hierarchical allreduce, bit 0 allgather.
SCHEDULE = (0, 2, 0, 1, 0, 3, 0, 0)


class _Bayes:
    """One combination's posterior and its next-point search."""

    def __init__(self, seed: int):
        self.gp = GaussianProcess(BOUNDS)
        self.rng = np.random.default_rng(seed)

    def next_sample(self) -> List[float]:
        lo = np.array([b[0] for b in BOUNDS])
        hi = np.array([b[1] for b in BOUNDS])
        if len(self.gp) == 0:
            return list(lo + 0.5 * (hi - lo))

        def ei(u):
            return self.gp.expected_improvement(lo + u * (hi - lo))

        best_u, best = np.full(len(BOUNDS), 0.5), -1.0
        for u in self.rng.uniform(size=(512, len(BOUNDS))):
            v = ei(u)
            if v > best:
                best, best_u = v, u
        step = 0.05
        for _ in range(3):
            for i in range(len(BOUNDS)):
                for delta in (-step, step):
                    u = best_u.copy()
                    u[i] = min(1.0, max(0.0, u[i] + delta))
                    v = ei(u)
                    if v > best:
                        best, best_u = v, u
            step *= 0.5
        return list(lo + best_u * (hi - lo))


class ParameterManager:
    """Rank 0's tuner of the engine's fusion threshold, cycle time and
    hierarchical flags. :meth:`update` takes one cycle's bytes and
    seconds and returns True when the point changed."""

    CYCLES_PER_SAMPLE = 10
    SAMPLES_PER_STEP = 5
    WARMUP_SAMPLES = 3
    MAX_STEPS = 30

    def __init__(self, fusion_mb: float, cycle_ms: float,
                 log_path: Optional[str] = None):
        self.fusion_mb = min(64.0, max(0.0, float(fusion_mb)))
        self.cycle_ms = min(100.0, max(1.0, float(cycle_ms)))
        self.hier_allreduce = self.hier_allgather = False
        self.active, self.done = True, False
        self._best = (-1.0, self.fusion_mb, self.cycle_ms, 0)
        self._bo = [_Bayes(41 + 2 * c) for c in range(4)]
        self._category = 0
        self._acc_bytes, self._acc_s, self._acc_cycles = 0, 0.0, 0
        self._samples: List[float] = []
        self._warmups = self.WARMUP_SAMPLES
        self.steps = 0
        self._log = None
        if log_path:
            self._log = open(log_path, "w")
            self._log.write(HEADER + "\n")
            self._log.flush()

    @property
    def fusion_bytes(self) -> int:
        return int(self.fusion_mb * 1024.0 * 1024.0)

    def _combo(self) -> int:
        return (2 if self.hier_allreduce else 0) | \
            (1 if self.hier_allgather else 0)

    def flags(self) -> int:
        """The coordinator's ``FLAG_HIERARCHICAL_*`` bits of the point."""
        return (1 if self.hier_allreduce else 0) | \
            (2 if self.hier_allgather else 0)

    def params(self) -> dict:
        """The plan's share of the point: the cycle time every rank
        waits and the tuner's state (rank 0's planner cuts with
        :attr:`fusion_bytes`; the groups carry :meth:`flags`)."""
        return {"cycle_time_ms": self.cycle_ms,
                "autotune_active": self.active and not self.done,
                "autotune_done": self.done}

    def update(self, nbytes: int, seconds: float) -> bool:
        if not self.active or self.done:
            return False
        self._acc_bytes += int(nbytes)
        self._acc_s += float(seconds)
        self._acc_cycles += 1
        if self._acc_cycles < self.CYCLES_PER_SAMPLE:
            return False
        score = (self._acc_bytes / (self._acc_s * 1e6)
                 if self._acc_s > 0 else 0.0)
        self._acc_bytes, self._acc_s, self._acc_cycles = 0, 0.0, 0
        if self._warmups > 0:
            self._warmups -= 1
            return False
        self._samples.append(score)
        if len(self._samples) < self.SAMPLES_PER_STEP:
            return False
        s = sorted(self._samples)
        self._samples = []
        median = s[len(s) // 2]
        self._log_sample(median)
        self._tune(median)
        return True

    def _tune(self, score: float) -> None:
        combo = self._combo()
        self._bo[combo].gp.observe([self.fusion_mb, self.cycle_ms], score)
        if score > self._best[0]:
            self._best = (score, self.fusion_mb, self.cycle_ms, combo)
        self.steps += 1
        if self.steps >= self.MAX_STEPS:
            self.set_done()
            return
        self._category = (self._category + 1) % len(SCHEDULE)
        nxt = SCHEDULE[self._category]
        fusion, cycle = self._bo[nxt].next_sample()
        self.fusion_mb = min(64.0, max(0.0, fusion))
        self.cycle_ms = min(100.0, max(1.0, cycle))
        self.hier_allreduce = bool(nxt & 2)
        self.hier_allgather = bool(nxt & 1)
        _log.debug("autotune step %d: fusion_mb=%.3f cycle_ms=%.3f "
                   "hier_ar=%d hier_ag=%d (median score %.6f)", self.steps,
                   self.fusion_mb, self.cycle_ms, self.hier_allreduce,
                   self.hier_allgather, score)

    def set_done(self) -> None:
        """Freeze to the best point measured."""
        score, self.fusion_mb, self.cycle_ms, combo = self._best
        self.hier_allreduce = bool(combo & 2)
        self.hier_allgather = bool(combo & 1)
        self.done = True
        _log.info("autotune converged: fusion_mb=%.3f cycle_ms=%.3f "
                  "hier_allreduce=%d hier_allgather=%d score=%.6f",
                  self.fusion_mb, self.cycle_ms, self.hier_allreduce,
                  self.hier_allgather, score)
        self.close()

    def close(self) -> None:
        if self._log is not None:
            self._log.close()
            self._log = None

    def _log_sample(self, score: float) -> None:
        if self._log is not None:
            self._log.write(f"{self.fusion_mb:.3f},{self.cycle_ms:.3f},"
                            f"{int(self.hier_allreduce)},"
                            f"{int(self.hier_allgather)},{score:.6f}\n")
            self._log.flush()
