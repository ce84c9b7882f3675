"""Online tuning: the global autotuner and the serving path's draft
length.

Counterpart of ``horovod_tpu/autotune``. One search space over the
perf knobs (wire spec, fusion threshold, torch bucket size, pipeline
schedule and microbatches, serving ``spec_tokens``, engine cycle time),
scored on measured step time, applied through safe per-knob
mechanisms, guarded by the health plane's step-time detector with
rollback:

    knobs.py              typed knob registry (domain / apply / safety)
    search.py             successive halving over the discrete space
    gp.py                 numpy GP seeded from the legacy tuner's log
    apply.py              the safe online apply plane (injected hooks)
    driver.py             the AutoTuner: baseline -> move -> score -> guard
    parameter_manager.py  the engine's legacy Bayesian tuner
    spec_adapt.py         per-slot adaptive speculative draft length

Rank 0's coordinator arms the legacy tuner where
``HOROVOD_TPU_AUTOTUNE`` (the runner's ``--autotune``) is on, or where
it is unset and ``HOROVOD_AUTOTUNE`` is, as JAX's core reads them. The
``AutoTuner`` is the program's own: it runs where a caller builds it,
with its guard and budget defaulting to ``HOROVOD_TPU_AUTOTUNE_GUARD_REL``
and ``HOROVOD_TPU_AUTOTUNE_TRIAL_BUDGET``.
"""

from .apply import ApplyPlane
from .driver import AutoTuner, Move, WindowedStepTime
from .gp import GaussianProcess, seed_gp_for_cycle_time, \
    seed_points_from_legacy_log
from .knobs import APPLY_VIAS, KINDS, SAFETY_CLASSES, Knob, \
    KnobRegistry, default_registry
from .parameter_manager import ParameterManager
from .search import Trial, enumerate_configs, rungs_for, \
    successive_halving
from .spec_adapt import SpecTokensController

__all__ = [
    "APPLY_VIAS", "KINDS", "SAFETY_CLASSES",
    "ApplyPlane", "AutoTuner", "GaussianProcess", "Knob",
    "KnobRegistry", "Move", "ParameterManager", "SpecTokensController",
    "Trial", "WindowedStepTime", "default_registry", "enumerate_configs",
    "rungs_for", "seed_gp_for_cycle_time",
    "seed_points_from_legacy_log", "successive_halving",
]
