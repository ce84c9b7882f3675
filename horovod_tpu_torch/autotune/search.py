"""Successive halving over the discrete knob space.

Counterpart of ``horovod_tpu/autotune/search.py``: the same candidates
in the same order, the same rungs and the same tie-breaks.

The discrete half of the global tuner's search (docs/autotune.md): all
candidate configs get a small measurement budget, the top 1/eta by
score survive to the next rung with the budget multiplied by eta, until
one winner remains — the classic successive-halving bandit, which suits
step-time tuning because a config that is 20% slower reveals itself in
a handful of steps while the final contenders deserve long, low-noise
windows. The MLPerf pod-scaling playbook (arXiv 1909.09756) is the
convergence methodology: measure short, prune hard, re-measure the
survivors at scale.

Everything here is deterministic given the candidate order and the
score function, so two searches over the same measurements agree.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Trial:
    """One scored measurement of one candidate config at one rung."""

    config: Dict
    rung: int
    budget: int
    score: float


def enumerate_configs(knobs, *, constraint: Optional[Callable] = None
                      ) -> List[Dict]:
    """Cartesian product over the discrete knobs' domains, in domain
    order (deterministic), filtered by ``constraint(config) -> bool``
    (e.g. zb-h1 needs microbatches >= stages)."""
    names = [k.name for k in knobs]
    domains = [k.domain for k in knobs]
    out = []
    for combo in itertools.product(*domains):
        cfg = dict(zip(names, combo))
        if constraint is None or constraint(cfg):
            out.append(cfg)
    return out


def successive_halving(candidates: Sequence[Dict],
                       score_fn: Callable[[Dict, int], float], *,
                       eta: int = 2, base_budget: int = 1,
                       min_survivors: int = 1
                       ) -> Tuple[Dict, List[Trial]]:
    """Run successive halving; returns ``(best_config, trials)``.

    ``score_fn(config, budget)`` measures one candidate with ``budget``
    units of measurement (steps, repeats — the caller's choice) and
    returns a HIGHER-IS-BETTER score (the tuner scores negative step
    time). Ties break by candidate order, so equal scores keep the
    earlier candidate — determinism again."""
    if not candidates:
        raise ValueError("successive halving needs at least one "
                         "candidate")
    if eta < 2:
        raise ValueError("eta must be >= 2")
    alive: List[Dict] = list(candidates)
    budget = int(base_budget)
    rung = 0
    trials: List[Trial] = []
    while True:
        scored = []
        for cfg in alive:
            s = float(score_fn(cfg, budget))
            trials.append(Trial(dict(cfg), rung, budget, s))
            scored.append((s, cfg))
        # Stable sort: equal scores keep candidate order.
        scored.sort(key=lambda p: -p[0])
        if len(alive) <= min_survivors:
            return dict(scored[0][1]), trials
        keep = max(min_survivors, len(alive) // eta)
        alive = [cfg for _, cfg in scored[:keep]]
        budget *= eta
        rung += 1


def rungs_for(n_candidates: int, *, eta: int = 2,
              min_survivors: int = 1) -> int:
    """How many rungs successive halving will run (for a report)."""
    rungs = 1
    alive = n_candidates
    while alive > min_survivors:
        alive = max(min_survivors, alive // eta)
        rungs += 1
    return rungs
