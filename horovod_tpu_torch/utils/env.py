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
    """HOROVOD_TPU_NUMERICS=1 arms the numerics plane at ``init``: the
    nonfinite sentinels, the train steps' telemetry and the fingerprint
    probes (``observability/numerics.py``)."""
    return _get("NUMERICS") in ("1",)


def numerics_fp_interval() -> int:
    """Cross-rank parameter-fingerprint cadence in training steps
    (HOROVOD_TPU_NUMERICS_FP_INTERVAL, default 50); 0 turns the probe
    off and keeps the rest of the plane armed."""
    v = _get("NUMERICS_FP_INTERVAL")
    if v in (None, ""):
        return 50
    return int(v)


def autotune() -> bool:
    """``HOROVOD_AUTOTUNE``, the legacy tuner's own switch. Reads only
    that name, not the ``HOROVOD_TPU_`` override, which is
    :func:`autotune_global`."""
    return os.environ.get("HOROVOD_AUTOTUNE") not in (None, "", "0")


def autotune_global() -> bool:
    """``HOROVOD_TPU_AUTOTUNE``, which the runner's ``--autotune``
    exports."""
    return os.environ.get("HOROVOD_TPU_AUTOTUNE") not in (None, "", "0")


def autotune_engine() -> bool:
    """Whether rank 0's coordinator arms the engine's Bayesian tuner, as
    JAX's core reads it (``EnvOr("HOROVOD_TPU_AUTOTUNE",
    "HOROVOD_AUTOTUNE")``): ``HOROVOD_TPU_AUTOTUNE`` where it is set,
    else ``HOROVOD_AUTOTUNE``. An empty value is off."""
    if "HOROVOD_TPU_AUTOTUNE" in os.environ:
        return autotune_global()
    return autotune()


def autotune_log() -> Optional[str]:
    """CSV log of the engine tuner's samples (HOROVOD_AUTOTUNE_LOG)."""
    return _get("AUTOTUNE_LOG")


def autotune_guard_rel() -> float:
    """``AutoTuner``'s default rollback guard: a window after a move
    worse than the one before by more than this fraction rolls it back
    (HOROVOD_TPU_AUTOTUNE_GUARD_REL, default 0.10)."""
    v = _get("AUTOTUNE_GUARD_REL")
    return float(v) if v is not None else 0.10


def autotune_trial_budget() -> int:
    """``AutoTuner``'s default count of measurement windows a candidate
    is scored on (HOROVOD_TPU_AUTOTUNE_TRIAL_BUDGET, default 2)."""
    v = _get("AUTOTUNE_TRIAL_BUDGET")
    return int(v) if v is not None else 2


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


def fault_spec() -> Optional[str]:
    """Declarative per-rank fault-injection spec
    (HOROVOD_TPU_FAULT_SPEC, ``adaptation/faults.py``); None or empty
    disables injection."""
    v = _get("FAULT_SPEC")
    return v or None


def metrics_enabled() -> bool:
    """Metrics registry recording (HOROVOD_TPU_METRICS, default on; 0
    turns every mutator into one flag check)."""
    return _get("METRICS") not in ("0", "")


def exemplar_ttl_secs() -> float:
    """Seconds a histogram's exemplar (the trace id of the worst recent
    observation) stays champion before any newer one may replace it
    (HOROVOD_TPU_EXEMPLAR_TTL, default 60)."""
    v = _get("EXEMPLAR_TTL")
    if v in (None, ""):
        return 60.0
    return float(v)


def serving_port() -> int:
    """HTTP port of ``python -m horovod_tpu_torch.serving``
    (HOROVOD_TPU_SERVING_PORT, default 8400; 0 binds an ephemeral
    port)."""
    v = _get("SERVING_PORT")
    if v in (None, ""):
        return 8400
    return int(v)


def serving_queue() -> int:
    """Bounded admission-queue depth of the serving engine
    (HOROVOD_TPU_SERVING_QUEUE, default 32; past it HTTP 429)."""
    v = _get("SERVING_QUEUE")
    if v in (None, ""):
        return 32
    return int(v)


def serving_tick_budget_ms() -> Optional[float]:
    """Target decode-tick gap for chunked prefill
    (HOROVOD_TPU_SERVING_TICK_BUDGET_MS): the engine halves a prefill
    chunk's bucket while its measured cost exceeds this. None keeps the
    configured ``prefill_chunk``."""
    v = _get("SERVING_TICK_BUDGET_MS")
    if v in (None, ""):
        return None
    return float(v)


def reqtrace_dir() -> Optional[str]:
    """Directory of the per-process request traces
    (HOROVOD_TPU_REQTRACE); None or empty disables request tracing."""
    v = _get("REQTRACE")
    return v or None


def replica_id() -> Optional[int]:
    """This process's serving replica id (HOROVOD_TPU_REPLICA_ID): names
    its request-trace file and the fault spec's ``rank=``. None outside
    a fleet."""
    v = _get("REPLICA_ID")
    if v in (None, ""):
        return None
    return int(v)


def slo_ttft_ms() -> Optional[float]:
    """Default time-to-first-token SLO target, ms (HOROVOD_TPU_SLO_TTFT_MS),
    for requests with no ``slo`` field and no tenant entry."""
    v = _get("SLO_TTFT_MS")
    if v in (None, ""):
        return None
    return float(v)


def slo_tpot_ms() -> Optional[float]:
    """Default time-per-output-token SLO target, ms
    (HOROVOD_TPU_SLO_TPOT_MS), resolved as :func:`slo_ttft_ms`."""
    v = _get("SLO_TPOT_MS")
    if v in (None, ""):
        return None
    return float(v)


def slo_config() -> Optional[str]:
    """Path of the SLO and QoS config file (HOROVOD_TPU_SLO_CONFIG): JSON
    ``{"tenants": {name: {"ttft_ms", "tpot_ms", ...}}, "default": {...}}``."""
    v = _get("SLO_CONFIG")
    return v or None


def serving_reserved_slots() -> int:
    """Decode slots only the top QoS class may hold
    (HOROVOD_TPU_SERVING_RESERVED_SLOTS, default 0)."""
    v = _get("SERVING_RESERVED_SLOTS")
    if v in (None, ""):
        return 0
    return max(0, int(v))


def max_tenants() -> int:
    """Distinct tenant label values before later tenants collapse into
    ``"other"`` (HOROVOD_TPU_MAX_TENANTS, default 16)."""
    v = _get("MAX_TENANTS")
    if v in (None, ""):
        return 16
    return max(1, int(v))


# ---------------------------------------------------------------- telemetry

def blackbox_dir() -> Optional[str]:
    """Directory of the flight recorder's dumps (HOROVOD_TPU_BLACKBOX):
    each process writes ``blackbox-rank{rank}.jsonl`` there on a crash,
    SIGTERM or an injected fault. None or empty: the ring still records,
    nothing reaches disk."""
    v = _get("BLACKBOX")
    return v or None


def blackbox_window_secs() -> float:
    """Seconds of history a dump carries (HOROVOD_TPU_BLACKBOX_WINDOW,
    default 120)."""
    v = _get("BLACKBOX_WINDOW")
    if v in (None, ""):
        return 120.0
    return float(v)


def blackbox_interval_secs() -> float:
    """Cadence of the periodic in-flight dump
    (HOROVOD_TPU_BLACKBOX_INTERVAL, default 5; 0 keeps the death-path
    dumps only): a SIGKILLed process leaves its last snapshot."""
    v = _get("BLACKBOX_INTERVAL")
    if v in (None, ""):
        return 5.0
    return float(v)


def blackbox_capacity() -> int:
    """Events the flight recorder's ring holds
    (HOROVOD_TPU_BLACKBOX_EVENTS, default 4096)."""
    v = _get("BLACKBOX_EVENTS")
    if v in (None, ""):
        return 4096
    return int(v)


def history_dir() -> Optional[str]:
    """Directory of the telemetry history (HOROVOD_TPU_HISTORY): a
    sampler appends windowed registry deltas to ``history-{label}.jsonl``
    there and the health detectors watch them. None or empty disables
    the plane."""
    v = _get("HISTORY")
    return v or None


def history_interval_secs() -> float:
    """Cadence of the history sampler (HOROVOD_TPU_HISTORY_INTERVAL,
    default 5 s)."""
    v = _get("HISTORY_INTERVAL")
    if v in (None, ""):
        return 5.0
    return float(v)


def history_max_bytes() -> int:
    """Size cap of one history segment before it rotates
    (HOROVOD_TPU_HISTORY_MAX_BYTES, default 4 MiB)."""
    v = _get("HISTORY_MAX_BYTES")
    if v in (None, ""):
        return 4 * 1024 * 1024
    return int(v)


def history_segments() -> int:
    """Rotated history segments kept beside the live file
    (HOROVOD_TPU_HISTORY_SEGMENTS, default 4)."""
    v = _get("HISTORY_SEGMENTS")
    if v in (None, ""):
        return 4
    return int(v)


def health_detectors_enabled() -> bool:
    """The health detectors over the history (HOROVOD_TPU_HEALTH, on
    unless 0)."""
    return _get("HEALTH") not in ("0",)


def alert_url() -> Optional[str]:
    """Webhook every health alert is POSTed to (HOROVOD_TPU_ALERT_URL),
    fire and forget; None disables it."""
    v = _get("ALERT_URL")
    return v or None


def metrics_file() -> Optional[str]:
    """Path of the periodic JSON metrics snapshot
    (HOROVOD_TPU_METRICS_FILE). A ``{rank}`` placeholder expands to the
    process's rank; without one only rank 0 writes."""
    return _get("METRICS_FILE")


def metrics_port(rank: int = 0) -> Optional[int]:
    """Port of the Prometheus/JSON endpoint for ``rank``
    (HOROVOD_TPU_METRICS_PORT; 0 binds an ephemeral port; None disables
    it). ``9091`` is rank 0's only; ``909{rank}`` and ``9091+rank`` give
    every rank its own."""
    v = _get("METRICS_PORT")
    if v in (None, ""):
        return None
    v = v.strip()
    if "{rank}" in v:
        return int(v.replace("{rank}", str(rank)))
    if v.endswith("+rank"):
        return int(v[: -len("+rank")]) + rank
    return int(v)


def metrics_port_per_rank() -> bool:
    """True when HOROVOD_TPU_METRICS_PORT has a per-rank form, so every
    process binds its endpoint."""
    v = _get("METRICS_PORT")
    if v in (None, ""):
        return False
    v = v.strip()
    return "{rank}" in v or v.endswith("+rank")


def metrics_interval_secs() -> float:
    """Cadence of the JSON snapshot writer
    (HOROVOD_TPU_METRICS_INTERVAL, default 15 s)."""
    v = _get("METRICS_INTERVAL")
    if v in (None, ""):
        return 15.0
    return float(v)


# ------------------------------------------------------------------ fleet

def fleet_probe_interval_secs() -> float:
    """Cadence of the fleet supervisor's ``/healthz`` probes and the
    router's scrapes (HOROVOD_TPU_FLEET_PROBE_INTERVAL, default 0.25 s)."""
    v = _get("FLEET_PROBE_INTERVAL")
    if v in (None, ""):
        return 0.25
    return float(v)


def fleet_probe_failures() -> int:
    """Failed probes in a row before the supervisor kills a replica for
    a restart (HOROVOD_TPU_FLEET_PROBE_FAILURES, default 4)."""
    v = _get("FLEET_PROBE_FAILURES")
    if v in (None, ""):
        return 4
    return int(v)


def qos_scale_high() -> float:
    """Autoscaler's scale-up threshold, fleet work per decode slot
    (HOROVOD_TPU_QOS_SCALE_HIGH, default 1.5)."""
    v = _get("QOS_SCALE_HIGH")
    if v in (None, ""):
        return 1.5
    return float(v)


def qos_scale_low() -> float:
    """Autoscaler's scale-down threshold, work per slot
    (HOROVOD_TPU_QOS_SCALE_LOW, default 0.25)."""
    v = _get("QOS_SCALE_LOW")
    if v in (None, ""):
        return 0.25
    return float(v)


def qos_scale_sustain_s() -> float:
    """Seconds scale-up pressure must hold before the autoscaler acts
    (HOROVOD_TPU_QOS_SCALE_SUSTAIN_S, default 3)."""
    v = _get("QOS_SCALE_SUSTAIN_S")
    if v in (None, ""):
        return 3.0
    return float(v)


def qos_scale_cooldown_s() -> float:
    """Seconds of low load before a scale-down, and the least gap
    between two actions (HOROVOD_TPU_QOS_SCALE_COOLDOWN_S, default 15)."""
    v = _get("QOS_SCALE_COOLDOWN_S")
    if v in (None, ""):
        return 15.0
    return float(v)


def qos_scale_interval_s() -> float:
    """Autoscaler's observation period
    (HOROVOD_TPU_QOS_SCALE_INTERVAL_S, default 1 s)."""
    v = _get("QOS_SCALE_INTERVAL_S")
    if v in (None, ""):
        return 1.0
    return float(v)


def adaptation_enabled() -> bool:
    """The rank-0 adaptation policy (HOROVOD_TPU_ADAPTATION=1): the
    coordinator climbs the degradation ladder on sustained straggler
    lateness. Default off."""
    return _get("ADAPTATION") in ("1",)


def _float(name: str, default: float) -> float:
    v = _get(name)
    return float(v) if v not in (None, "") else default


def adapt_threshold_s() -> float:
    """Straggler lateness (decay-weighted mean seconds) that starts the
    policy's sustain clock (HOROVOD_TPU_ADAPT_THRESHOLD, default 0.1)."""
    return _float("ADAPT_THRESHOLD", 0.1)


def adapt_sustain_s() -> float:
    """Seconds above the threshold before each escalation
    (HOROVOD_TPU_ADAPT_SUSTAIN, default 5)."""
    return _float("ADAPT_SUSTAIN", 5.0)


def adapt_cooldown_s() -> float:
    """Seconds below threshold x de-escalation ratio before each
    de-escalation (HOROVOD_TPU_ADAPT_COOLDOWN, default 30)."""
    return _float("ADAPT_COOLDOWN", 30.0)


def adapt_interval_s() -> float:
    """The policy's evaluation period (HOROVOD_TPU_ADAPT_INTERVAL,
    default 1 s)."""
    return _float("ADAPT_INTERVAL", 1.0)


def adapt_tiers() -> Optional[str]:
    """Comma-separated ladder override (HOROVOD_TPU_ADAPT_TIERS); None
    keeps shrink, bf16, int8x256, fp8x256, evict."""
    return _get("ADAPT_TIERS")


def adapt_alert_hold_s() -> float:
    """Seconds a health alert keeps pressure on the ladder
    (HOROVOD_TPU_ADAPT_ALERT_HOLD, default 30)."""
    return _float("ADAPT_ALERT_HOLD", 30.0)


def peak_flops() -> Optional[float]:
    """Peak FLOP/s of this process's devices for the MFU gauge
    (HOROVOD_TPU_PEAK_FLOPS); None: from the device name's table."""
    v = _get("PEAK_FLOPS")
    return float(v) if v not in (None, "") else None
