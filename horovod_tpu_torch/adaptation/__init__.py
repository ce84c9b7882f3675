"""The self-healing collective plane: fault injection (:mod:`.faults`,
``HOROVOD_TPU_FAULT_SPEC``) and rank 0's degradation ladder
(:mod:`.policy`, ``HOROVOD_TPU_ADAPTATION=1``), which the coordinator
hosts (``ops/control_plane.py``); its eviction tier hands off to the
elastic driver through a typed ``SlowRankFailure``."""

from .faults import (FAULT_SPEC_ENV, FaultClause, FaultInjector, injector,
                     parse_spec)
from .policy import DEFAULT_TIERS, AdaptationConfig, AdaptationPolicy

__all__ = [
    "FAULT_SPEC_ENV", "FaultClause", "FaultInjector", "injector",
    "parse_spec", "AdaptationConfig", "AdaptationPolicy", "DEFAULT_TIERS",
]
