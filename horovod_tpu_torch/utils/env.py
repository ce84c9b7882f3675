"""Environment-variable configuration of the port.

The same ``HOROVOD_*`` names as the JAX package, with ``HOROVOD_TPU_*``
overrides taking precedence, and the same defaults. Only the variables
this package reads are here.
"""

from __future__ import annotations

import os
from typing import Optional

# Horovod's fusion threshold default (64 MiB) and the JAX engine's cycle.
DEFAULT_FUSION_THRESHOLD_MB = 64
DEFAULT_CYCLE_TIME_MS = 1.0
DEFAULT_STALL_WARNING_SECS = 60  # the reference's STALL_WARNING_TIME


def _get(name: str) -> Optional[str]:
    v = os.environ.get("HOROVOD_TPU_" + name)
    if v is None:
        v = os.environ.get("HOROVOD_" + name)
    return v


def fusion_threshold_bytes() -> int:
    """Byte cap of one fused gradient buffer (HOROVOD_FUSION_THRESHOLD)."""
    v = _get("FUSION_THRESHOLD")
    if v is not None:
        return int(v)
    return DEFAULT_FUSION_THRESHOLD_MB * 1024 * 1024


def torch_bucket_mb() -> float:
    """Size target of the DistributedOptimizer's gradient buckets
    (HOROVOD_TPU_TORCH_BUCKET_MB, MiB). The default is the fusion
    threshold's, so each bucket fills one fused group; 0 disables
    bucketing (per-tensor hooks). ``bucket_cap_mb=`` overrides it."""
    v = _get("TORCH_BUCKET_MB")
    if v is not None:
        return float(v)
    return float(DEFAULT_FUSION_THRESHOLD_MB)


def torch_grad_view() -> bool:
    """Default of the DistributedOptimizer's ``gradient_as_bucket_view``
    (HOROVOD_TPU_TORCH_GRAD_VIEW): alias each ``p.grad`` into its
    bucket's buffer. Off by default: it changes the identity of
    ``p.grad`` tensors."""
    return _get("TORCH_GRAD_VIEW") not in (None, "", "0")


def torch_skip_nonfinite() -> bool:
    """Default of the DistributedOptimizer's ``skip_nonfinite_steps``
    (HOROVOD_TPU_TORCH_SKIP_NONFINITE): skip the inner update of a step
    whose packed gradients held NaN or Inf. Needs HOROVOD_TPU_NUMERICS=1
    for the count to exist."""
    return _get("TORCH_SKIP_NONFINITE") not in (None, "", "0")


def numerics_enabled() -> bool:
    """HOROVOD_TPU_NUMERICS=1 arms the nonfinite sentinel of the
    gradient buckets; ``init`` reads it."""
    return _get("NUMERICS") in ("1",)


def cycle_time_ms() -> float:
    """Pause of the collective engine between cycles (HOROVOD_CYCLE_TIME,
    milliseconds). A blocking ``Handle.wait`` cuts the pause short."""
    v = _get("CYCLE_TIME")
    if v is not None:
        return float(v)
    return DEFAULT_CYCLE_TIME_MS


def log_level() -> str:
    return (_get("LOG_LEVEL") or "warning").lower()


def torch_build_dir() -> Optional[str]:
    """Directory the CUDA kernels are built into
    (HOROVOD_TPU_TORCH_BUILD_DIR); None keeps ``ops/_kernels``."""
    return _get("TORCH_BUILD_DIR") or None


def hierarchical_allreduce() -> bool:
    """HOROVOD_HIERARCHICAL_ALLREDUCE: sum fused groups in two stages,
    within each node ('ici') and across nodes ('dcn'). Rank 0's value
    rules every rank's execution (the engine stamps it into the plan)."""
    return _get("HIERARCHICAL_ALLREDUCE") not in (None, "", "0")


def hierarchical_allgather() -> bool:
    """HOROVOD_HIERARCHICAL_ALLGATHER: gather within each node, then
    across nodes. Rank 0's value rules, as for the allreduce."""
    return _get("HIERARCHICAL_ALLGATHER") not in (None, "", "0")


def stall_warning_secs() -> float:
    """Seconds an op may wait in flight before the engine warns
    (HOROVOD_STALL_WARNING, default 60, as the reference's
    STALL_WARNING_TIME); 0 when HOROVOD_STALL_CHECK_DISABLE is set."""
    if _get("STALL_CHECK_DISABLE") not in (None, "", "0"):
        return 0.0
    v = _get("STALL_WARNING")
    if v not in (None, ""):
        return float(v)
    return DEFAULT_STALL_WARNING_SECS


def timeline_path() -> Optional[str]:
    """HOROVOD_TIMELINE: the Chrome-trace file the engine writes."""
    return _get("TIMELINE")


def resolved_timeline_path(rank: int) -> Optional[str]:
    """The timeline file this rank writes, or None. A ``{rank}``
    placeholder in the path makes every rank write its own file;
    without one only rank 0 writes (a second writer would truncate its
    file)."""
    path = timeline_path()
    if not path:
        return None
    if "{rank}" in path:
        return path.replace("{rank}", str(rank))
    return path if rank == 0 else None


def timeline_mark_cycles() -> bool:
    """HOROVOD_TIMELINE_MARK_CYCLES: a CYCLE_START instant per engine
    cycle in the timeline."""
    return _get("TIMELINE_MARK_CYCLES") not in (None, "", "0")


def checkpoint_keep() -> int:
    """Keep-last-N retention of committed checkpoints, for the sharded
    engine and ElasticState's pickle backend
    (HOROVOD_TPU_CHECKPOINT_KEEP, default 10; 0 keeps every step)."""
    v = _get("CHECKPOINT_KEEP")
    if v in (None, ""):
        return 10
    return int(v)


def failure_timeout_secs() -> float:
    """Seconds after which the engine's stall inspector fails an op in
    flight with a typed ``WorkerFailure`` instead of only warning
    (HOROVOD_TPU_FAILURE_TIMEOUT). 0, the default, keeps it warn-only."""
    v = _get("FAILURE_TIMEOUT")
    if v in (None, ""):
        return 0.0
    return float(v)
