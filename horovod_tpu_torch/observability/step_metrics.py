"""Per-step training telemetry: :class:`StepTimer` and MFU.

Counterpart of ``horovod_tpu/observability/step_metrics.py``, with the
same families, labels and attribution. Each step is split into

  - ``input``      the gap between the previous step's ``end()`` and this
                   step's ``begin()`` (waiting on the data pipeline),
  - ``h2d``        host-to-device staging, up to :meth:`mark_h2d_done`
                   (plus what the prefetcher credits, :meth:`credit_h2d`),
  - ``collective`` the engine's own execute seconds plus its negotiate
                   wait over the step (``hvdtpu_op_execute_seconds_total``
                   and the negotiate phase of ``hvdtpu_op_phase_seconds``,
                   every op), and
  - ``compute``    the remainder,

exported as ``hvdtpu_step_phase_seconds{phase=}`` and
``hvdtpu_step_phase_share{phase=}``, with ``hvdtpu_step_seconds``,
samples and samples/s, the collective share (and its deprecated
``allreduce`` alias), the MFU and model FLOP/s gauges, and the device
memory gauges. With the engine's timeline live the split is also
written as ``STEP_*`` spans, and each step is a flight-recorder
``step``/``step_end`` pair.

Where JAX counts a step's FLOPs from XLA's cost analysis
(``flops_of_lowered``), the port runs the step once under
``torch.utils.flop_counter.FlopCounterMode`` (:func:`flops_of_step`):
the counter sees aten ops, and the flash kernels' attention adds torch's
own SDPA formulas (``ops/flash_attention.py``), so a step on the kernels
counts what the same step through the plain attention counts. The MFU's
peak is ``HOROVOD_TPU_PEAK_FLOPS`` or the card's dense bf16 peak by its
name (:data:`_PEAK_FLOPS_BY_NAME`); the CPU has none. Device memory is
the CUDA caching allocator's, or the host's RSS on the CPU.

Recorded metrics (labeled ``framework=...`` unless noted):
  - ``hvdtpu_step_seconds`` (histogram)
  - ``hvdtpu_step_phase_seconds`` / ``hvdtpu_step_phase_share``
    (histogram / gauge, also labeled ``phase=``)
  - ``hvdtpu_samples_total`` (counter), ``hvdtpu_samples_per_second``
  - ``hvdtpu_collective_step_share`` (``hvdtpu_allreduce_step_share`` a
    deprecated alias)
  - ``hvdtpu_mfu`` / ``hvdtpu_model_flops_per_second`` (when a FLOPs
    figure is known; MFU also needs a peak)
  - ``hvdtpu_hbm_bytes_in_use`` / ``hvdtpu_hbm_peak_bytes`` (labeled
    ``device=``: ``cuda:N``, or ``host``)
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from . import registry as _reg
from ..utils import env as _env

STEP_PHASES = ("input", "h2d", "compute", "collective")

# Dense bf16 peak FLOP/s by CUDA device name (lowercase substring, the
# first match wins; None: no tabulated figure). The SXM H100 reports
# itself as ``NVIDIA H100 80GB HBM3``.
_PEAK_FLOPS_BY_NAME = (
    ("h100 pcie", 756e12),
    ("h100 nvl", None),
    ("h100", 989e12),
)


def flops_of_step(fn: Callable, *args, **kwargs) -> float:
    """Model FLOPs of one call ``fn(*args, **kwargs)``, which this runs
    once under ``torch.utils.flop_counter.FlopCounterMode`` (forward and
    backward, as far as the call runs them): pass the result as
    ``StepTimer(..., flops_per_step=...)``::

        flops = flops_of_step(step, model, opt, tokens, targets)
        timer = StepMetrics(batch_size=8, flops_per_step=flops)

    The flash attention counts by torch's SDPA formulas."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import flash_attention as _fa
    mode = FlopCounterMode(display=False)
    _fa.FLOP_COUNTERS.append(mode)
    try:
        with mode:
            fn(*args, **kwargs)
    finally:
        _fa.FLOP_COUNTERS.remove(mode)
    return float(mode.get_total_flops())


def _process_device() -> torch.device:
    """This process's device: the topology's after ``init``, else the
    current CUDA device; without a card the caller passes
    ``device="cpu"``."""
    from .. import topology as _topo
    if _topo.is_initialized():
        return _topo.device()
    if not torch.cuda.is_available():
        raise RuntimeError("StepTimer: CUDA is not available and init() "
                           "chose no device; pass device='cpu' to time a "
                           "CPU loop")
    return torch.device("cuda", torch.cuda.current_device())


def _local_peak_flops(device: torch.device) -> Optional[float]:
    """Peak FLOP/s of ``device`` (the env override first, then the name
    table); None when unknown."""
    env_peak = _env.peak_flops()
    if env_peak is not None:
        return env_peak
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for marker, peak in _PEAK_FLOPS_BY_NAME:
        if marker in name:
            return peak
    return None


def _collective_execute_seconds() -> float:
    """Execute seconds across every collective op (allreduce, allgather,
    broadcast)."""
    fam = _reg.registry().counter(
        "hvdtpu_op_execute_seconds_total",
        "Cumulative wall seconds executing fused collective groups")
    return sum(child.value for _, child in fam.items())


def _negotiate_wait_seconds() -> float:
    """Cumulative negotiate-phase seconds across all ops — the
    control-plane wait (enqueue → group delivered), which is where time
    waiting on a late peer lands."""
    fam = _reg.registry().histogram(
        "hvdtpu_op_phase_seconds",
        "Per-collective latency by lifecycle phase (negotiate = "
        "enqueue until the group is agreed/delivered; queue = "
        "delivery until XLA dispatch; execute = fused program wall "
        "time)", buckets=_reg.LATENCY_BUCKETS)
    return sum(child.sum for key, child in fam.items()
               if 'phase="negotiate"' in key)


class StepTimer:
    """Brackets one training step; records step time, samples/sec, the
    collective share of step time, and the input/h2d/compute/collective
    attribution. Cheap enough to leave on: a few ``time.perf_counter``
    calls and registry writes per step.

    ``flops_per_step`` (model FLOPs executed per step, e.g. from
    :func:`flops_of_step`) enables the ``hvdtpu_mfu`` /
    ``hvdtpu_model_flops_per_second`` gauges. ``device``: whose memory
    the HBM gauges read (default: this process's device)."""

    def __init__(self, framework: str, batch_size: Optional[int] = None,
                 flops_per_step: Optional[float] = None,
                 device=None):
        self.framework = framework
        self.device = _process_device() if device is None \
            else torch.device(device)
        self.batch_size = batch_size
        self.flops_per_step = flops_per_step
        r = _reg.registry()
        labels = {"framework": framework}
        self._h_step = r.histogram(
            "hvdtpu_step_seconds", "Training step wall time",
            buckets=_reg.LATENCY_BUCKETS).labels(**labels)
        phase_h = r.histogram(
            "hvdtpu_step_phase_seconds",
            "Per-step attribution: input (data-pipeline wait before the "
            "step), h2d (host-to-device staging, via mark_h2d_done), "
            "collective (fused execute + negotiate wait), compute (the "
            "remainder)", buckets=_reg.LATENCY_BUCKETS)
        phase_g = r.gauge(
            "hvdtpu_step_phase_share",
            "Fraction of the last step cycle (input wait + step wall "
            "time) spent in each phase")
        self._h_phase = {p: phase_h.labels(framework=framework, phase=p)
                         for p in STEP_PHASES}
        self._g_phase = {p: phase_g.labels(framework=framework, phase=p)
                         for p in STEP_PHASES}
        self._c_samples = r.counter(
            "hvdtpu_samples_total", "Training samples processed"
        ).labels(**labels)
        self._g_rate = r.gauge(
            "hvdtpu_samples_per_second",
            "Samples/sec of the most recent step").labels(**labels)
        self._g_share = r.gauge(
            "hvdtpu_collective_step_share",
            "Fraction of the last step's wall time spent executing "
            "fused collective groups (all ops)").labels(**labels)
        # DEPRECATION ALIAS: the canonical series is
        # hvdtpu_collective_step_share (it counts every collective op,
        # not just allreduce); this name stays for existing dashboards
        # and now carries the same all-ops value.
        self._g_share_legacy = r.gauge(
            "hvdtpu_allreduce_step_share",
            "DEPRECATED alias of hvdtpu_collective_step_share").labels(
            **labels)
        # MFU/FLOPs children are resolved lazily on first set: an
        # eagerly-created child would export a misleading 0.0 for
        # timers that never supply a flops figure or have no known
        # peak.
        self._fam_mfu = r.gauge(
            "hvdtpu_mfu",
            "Model FLOPs utilization of the last step: flops_per_step / "
            "step seconds / local peak FLOP/s (needs flops_per_step and "
            "a known peak)")
        self._fam_flops = r.gauge(
            "hvdtpu_model_flops_per_second",
            "Model FLOP/s of the last step (needs flops_per_step)")
        self._g_mfu = None
        self._g_flops = None
        self._g_hbm = r.gauge(
            "hvdtpu_hbm_bytes_in_use",
            "Device memory currently allocated, per local device "
            "(device='host': process RSS fallback when the backend has "
            "no memory_stats)")
        self._g_hbm_peak = r.gauge(
            "hvdtpu_hbm_peak_bytes",
            "Peak device memory allocated, per local device (host "
            "fallback: peak RSS)")
        self._peak_flops = (_local_peak_flops(self.device)
                            if flops_per_step else None)
        self._t0: Optional[float] = None
        self._t_prev_end: Optional[float] = None
        self._h2d_mark: Optional[float] = None
        self._h2d_credit = 0.0
        self._ar0 = 0.0
        self._neg0 = 0.0
        self._step_idx = 0
        self.last_step_s = 0.0
        self.last_samples_per_s = 0.0
        self.last_collective_share = 0.0
        self.last_phases = {p: 0.0 for p in STEP_PHASES}

    # Back-compat: pre-attribution callers read last_allreduce_share.
    @property
    def last_allreduce_share(self) -> float:
        return self.last_collective_share

    def begin(self) -> None:
        self._ar0 = _collective_execute_seconds()
        self._neg0 = _negotiate_wait_seconds()
        self._h2d_mark = None
        from . import flight_recorder as _fr
        _fr.recorder().note("step", (self._step_idx,))
        self._t0 = time.perf_counter()

    def mark_h2d_done(self) -> None:
        """Optional: call once the batch is staged on device — the time
        from ``begin()`` to this mark is attributed to ``h2d`` instead
        of ``compute``."""
        if self._t0 is not None:
            self._h2d_mark = time.perf_counter()

    def credit_h2d(self, seconds: float) -> None:
        """Attribute ``seconds`` of the NEXT step's pre-step gap to
        ``h2d`` instead of ``input``. The device prefetcher
        (docs/data.md#prefetch) calls this when the consumer blocked on
        a batch whose host→device copy was not fully overlapped: the
        wait happened before ``begin()``, where only the input phase
        could otherwise see it. Capped at the actual gap in ``end()``
        — crediting more than was waited cannot mint h2d time."""
        if seconds > 0:
            self._h2d_credit += seconds

    @staticmethod
    def _engine():
        """The live collective engine, or None (never creates one).
        Imported lazily: observability stays importable before ops."""
        from ..ops import collective as _coll
        return _coll._engine

    def _timeline(self):
        """The engine's timeline writer, if one is live."""
        eng = self._engine()
        return eng.timeline if eng is not None else None

    def _sample_memory(self) -> None:
        """Device memory now and at its peak: on CUDA the caching
        allocator's ``allocated_bytes.all.current`` / ``.peak``
        (``torch.cuda.memory_stats``; a CUDA device never falls back to
        the host); on the CPU JAX's host fallback, the process's RSS and
        peak RSS, labeled ``device="host"``."""
        if self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            label = f"cuda:{self.device.index}"
            self._g_hbm.labels(device=label).set(
                float(stats.get("allocated_bytes.all.current", 0)))
            self._g_hbm_peak.labels(device=label).set(
                float(stats.get("allocated_bytes.all.peak", 0)))
            return
        try:
            import resource
            rss_page = 0
            try:
                with open("/proc/self/statm") as f:
                    rss_page = int(f.read().split()[1])
            except OSError:
                pass
            page = resource.getpagesize()
            peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            if rss_page:
                self._g_hbm.labels(device="host").set(
                    float(rss_page * page))
            self._g_hbm_peak.labels(device="host").set(
                float(peak_kb) * 1024.0)
        except Exception:
            pass

    def end(self, samples: Optional[int] = None) -> None:
        if self._t0 is None:
            return
        t_end = time.perf_counter()
        t0 = self._t0
        dt = max(t_end - t0, 1e-9)
        self._t0 = None
        n = samples if samples is not None else self.batch_size
        self.last_step_s = dt
        self._h_step.observe(dt)
        if n:
            self.last_samples_per_s = n / dt
            self._c_samples.inc(n)
            self._g_rate.set(self.last_samples_per_s)

        # Attribution: input is the pre-step gap; collective is the
        # engine's own execute + negotiate-wait accounting over the
        # step; compute is what remains of the in-step wall time.
        input_s = (max(0.0, t0 - self._t_prev_end)
                   if self._t_prev_end is not None else 0.0)
        self._t_prev_end = t_end
        h2d_s = (max(0.0, self._h2d_mark - t0)
                 if self._h2d_mark is not None else 0.0)
        # Prefetcher-credited staging time: part of the pre-step gap was
        # an unoverlapped device copy, not the data source.
        credit = min(self._h2d_credit, input_s)
        self._h2d_credit = 0.0
        input_s -= credit
        h2d_s += credit
        # On CUDA a group's execute seconds come from the card's events:
        # those of the groups the card has finished count in this step.
        eng = self._engine()
        if eng is not None:
            eng.collect_timings()
        exec_s = _collective_execute_seconds() - self._ar0
        neg_s = _negotiate_wait_seconds() - self._neg0
        collective_s = min(max(exec_s + neg_s, 0.0), dt)
        compute_s = max(0.0, dt - collective_s - h2d_s)
        phases = {"input": input_s, "h2d": h2d_s,
                  "compute": compute_s, "collective": collective_s}
        cycle = input_s + dt
        for p, v in phases.items():
            self._h_phase[p].observe(v)
            self._g_phase[p].set(v / cycle if cycle > 0 else 0.0)
        self.last_phases = phases

        share = min(max(exec_s, 0.0) / dt, 1.0)
        self.last_collective_share = max(share, 0.0)
        self._g_share.set(self.last_collective_share)
        self._g_share_legacy.set(self.last_collective_share)

        if self.flops_per_step:
            rate = self.flops_per_step / dt
            if self._g_flops is None:
                self._g_flops = self._fam_flops.labels(
                    framework=self.framework)
            self._g_flops.set(rate)
            if self._peak_flops:
                if self._g_mfu is None:
                    self._g_mfu = self._fam_mfu.labels(
                        framework=self.framework)
                self._g_mfu.set(rate / self._peak_flops)
        self._sample_memory()

        # Step spans into the live trace (Python writer only) so the
        # cross-rank report can attribute input/compute per rank; and a
        # step event into the flight recorder so the postmortem knows
        # the phase a dead rank was in (docs/postmortem.md).
        idx = self._step_idx
        self._step_idx += 1
        try:
            tl = self._timeline()
        except Exception:
            tl = None
        if tl is not None:
            # perf_counter and monotonic share the clock on CPython/
            # Linux; anchor the spans on monotonic to match the writer.
            now_m = time.monotonic()
            m_end = now_m - (time.perf_counter() - t_end)
            m_t0 = m_end - dt
            if input_s > 0:
                tl.execute_span("_step", "STEP_INPUT",
                                m_t0 - input_s, m_t0)
            if h2d_s > 0:
                tl.execute_span("_step", "STEP_H2D", m_t0, m_t0 + h2d_s)
            tl.execute_span("_step", "STEP_COMPUTE", m_t0 + h2d_s,
                            m_t0 + h2d_s + compute_s)
        from . import flight_recorder as _fr
        _fr.recorder().note("step_end", (
            idx, round(dt * 1e3, 3), round(input_s * 1e3, 3),
            round(h2d_s * 1e3, 3), round(compute_s * 1e3, 3),
            round(collective_s * 1e3, 3)))

    # Context-manager sugar for the torch/TF step loop.

    def __enter__(self) -> "StepTimer":
        self.begin()
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class StepMetrics(StepTimer):
    """The torch loop's step telemetry (``framework="torch"``), as the
    JAX package's torch shim exports it: a context manager around each
    step::

        metrics = hvd.StepMetrics(batch_size=64)
        for batch in loader:
            with metrics:
                loss = train_step(batch)   # backward + optimizer.step()

    The collective share comes from the engine's own execute seconds, so
    it covers the DistributedOptimizer's allreduces wherever they
    overlap the step."""

    def __init__(self, batch_size: Optional[int] = None,
                 flops_per_step: Optional[float] = None, device=None):
        super().__init__("torch", batch_size=batch_size,
                         flops_per_step=flops_per_step, device=device)
