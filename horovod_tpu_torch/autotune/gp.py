"""Tiny Gaussian-process regressor + expected improvement — the
continuous half of the global autotuner's search, and the posterior of
the engine's legacy tuner (``parameter_manager.py``).

Counterpart of ``horovod_tpu/autotune/gp.py``: the same posterior and
the same suggestions for the same observations.

The legacy eager-path Bayesian tuner (reference parameter_manager /
optim, tests/test_autotune.py) runs its GP in the native core and logs
every sampled point to ``HOROVOD_AUTOTUNE_LOG`` as
``fusion_mb,cycle_ms,hier_allreduce,hier_allgather,score`` CSV. This
module is the pure-python counterpart the GLOBAL tuner uses: it can be
seeded from that CSV (:func:`seed_points_from_legacy_log`) so a job
that already ran the legacy tuner starts its continuous knobs from the
legacy posterior instead of cold (docs/autotune.md).

Numpy-only RBF GP with a nugget; no scipy (the container bakes no new
deps). Scores are HIGHER-IS-BETTER (the tuner scores negative step
time), matching the legacy log's score column.
"""

from __future__ import annotations

import csv
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


class GaussianProcess:
    """RBF-kernel GP posterior over a box-bounded input space."""

    def __init__(self, bounds: Sequence[Tuple[float, float]], *,
                 length_scale: float = 0.2, signal: float = 1.0,
                 noise: float = 1e-4):
        self.bounds = [(float(lo), float(hi)) for lo, hi in bounds]
        self.length_scale = float(length_scale)
        self.signal = float(signal)
        self.noise = float(noise)
        self._x: List[np.ndarray] = []
        self._y: List[float] = []
        self._chol: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None

    # ------------------------------------------------------------- data

    def _unit(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        out = np.empty_like(x)
        for i, (lo, hi) in enumerate(self.bounds):
            out[i] = (x[i] - lo) / (hi - lo) if hi > lo else 0.0
        return out

    def observe(self, x, y: float) -> None:
        self._x.append(self._unit(x))
        self._y.append(float(y))
        self._chol = None

    def __len__(self) -> int:
        return len(self._y)

    # ---------------------------------------------------------- fitting

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.signal * np.exp(-0.5 * d2 / self.length_scale ** 2)

    def _fit(self) -> None:
        x = np.stack(self._x)
        y = np.asarray(self._y)
        self._ymean = float(y.mean())
        self._yscale = float(y.std()) or 1.0
        k = self._kernel(x, x) + self.noise * np.eye(len(y))
        self._chol = np.linalg.cholesky(k)
        resid = (y - self._ymean) / self._yscale
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, resid))

    def predict(self, x) -> Tuple[float, float]:
        """Posterior (mean, std) at one point in ORIGINAL units."""
        if not self._y:
            return 0.0, self.signal
        if self._chol is None:
            self._fit()
        xs = np.stack(self._x)
        q = self._unit(x)[None, :]
        kq = self._kernel(xs, q)[:, 0]
        mean = float(kq @ self._alpha) * self._yscale + self._ymean
        v = np.linalg.solve(self._chol, kq)
        var = max(self.signal - float(v @ v), 1e-12)
        return mean, math.sqrt(var) * self._yscale

    # ------------------------------------------------------ acquisition

    def expected_improvement(self, x) -> float:
        """EI versus the incumbent best (higher-is-better scores)."""
        if not self._y:
            return float("inf")
        mean, std = self.predict(x)
        best = max(self._y)
        if std <= 0:
            return max(mean - best, 0.0)
        z = (mean - best) / std
        # Normal pdf/cdf without scipy.
        pdf = math.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
        cdf = 0.5 * (1.0 + math.erf(z / math.sqrt(2)))
        return (mean - best) * cdf + std * pdf

    def suggest(self, n_grid: int = 16) -> List[float]:
        """Argmax-EI over a deterministic per-dimension grid — small
        spaces (1-2 continuous knobs) make a grid sweep exact enough,
        and determinism keeps two runs on the same measurements alike."""
        dims = len(self.bounds)
        axes = [np.linspace(lo, hi, n_grid) for lo, hi in self.bounds]
        best_x, best_ei = None, -1.0
        grid = np.meshgrid(*axes, indexing="ij") if dims > 1 else [axes[0]]
        flat = np.stack([g.ravel() for g in grid], axis=-1)
        for row in flat:
            ei = self.expected_improvement(row)
            if ei > best_ei:
                best_ei, best_x = ei, row
        return [float(v) for v in best_x]


def seed_points_from_legacy_log(path: str) -> List[Tuple[dict, float]]:
    """Parse the legacy Bayesian tuner's CSV log into
    ``[({knob: value}, score), ...]`` seed observations.

    The log format is the native core's
    ``fusion_mb,cycle_ms,hier_allreduce,hier_allgather,score``
    (tests/test_autotune.py asserts the header). Missing or torn files
    yield an empty seed list — cold start is always a valid start."""
    if not path or not os.path.exists(path):
        return []
    points: List[Tuple[dict, float]] = []
    try:
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader, None)
            if header is None or header[0] != "fusion_mb":
                return []
            for row in reader:
                if len(row) != 5:
                    continue
                try:
                    points.append((
                        {"fusion_mb": float(row[0]),
                         "cycle_time_ms": float(row[1]),
                         "hier_allreduce": bool(float(row[2])),
                         "hier_allgather": bool(float(row[3]))},
                        float(row[4])))
                except ValueError:
                    continue
    except OSError:
        return []
    return points


def seed_gp_for_cycle_time(gp: GaussianProcess, log_path: str) -> int:
    """Feed the legacy log's (cycle_ms, score) samples into a 1-D GP
    over cycle time; returns how many points seeded."""
    pts = seed_points_from_legacy_log(log_path)
    for cfg, score in pts:
        gp.observe([cfg["cycle_time_ms"]], score)
    return len(pts)
