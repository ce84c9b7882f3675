"""Typed metrics registry: counters, gauges and log2 histograms.

Counterpart of ``horovod_tpu/observability/registry.py``, copied: the
same metric names, label semantics, bucket edges, exemplars and
snapshot format, so a metrics consumer reads both packages alike.

  - :class:`Counter`   monotone float totals.
  - :class:`Gauge`     last-write-wins values.
  - :class:`Histogram` log-bucketed distributions (latencies span six
    orders of magnitude), with the trace id of the worst recent
    observation as its exemplar.

Thread-safe (the serving engine's loop, HTTP handler threads and user
threads write concurrently: each child carries its own lock, families
share the registry lock only at creation), and near free when disabled:
every mutator starts with one module-global check (``_enabled``,
``HOROVOD_TPU_METRICS=0``). A family hands out children per label set
(``family.labels(kind="prompt")``).

Snapshot format (:func:`snapshot`): a dict keyed by metric name, each
entry ``{"type", "help", "values": {label_str: value}}``, a histogram's
value ``{"buckets": [[le, cumulative_count], ...], "sum", "count"}``
with cumulative counts ending at the +Inf bucket == count.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils import env as _env

# Resolved once at import (read-once env-knob semantics like every other
# engine knob); set_enabled() flips it for the A/B overhead bench.
_enabled = _env.metrics_enabled()
# Exemplar replacement window (HOROVOD_TPU_EXEMPLAR_TTL), also
# read-once — the per-histogram default for Histogram.exemplar.
_exemplar_ttl = _env.exemplar_ttl_secs()


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> None:
    """Flip metric recording at runtime (the overhead bench's A/B lever;
    exporters keep serving whatever was recorded)."""
    global _enabled
    _enabled = bool(value)


def log2_buckets(lo: float, hi: float) -> List[float]:
    """Power-of-two bucket bounds covering [lo, hi] — the default
    log-bucketing for latency histograms."""
    bounds = []
    b = lo
    while b <= hi * (1 + 1e-12):
        bounds.append(b)
        b *= 2.0
    return bounds


# Default latency bounds: 1 µs .. ~134 s in 27 power-of-two buckets.
LATENCY_BUCKETS = log2_buckets(1e-6, 128.0)
# Fused-group sizes: 1 .. 4096 tensors.
SIZE_BUCKETS = log2_buckets(1.0, 4096.0)
# Byte sizes: 64 B .. 4 GiB.
BYTE_BUCKETS = log2_buckets(64.0, float(4 << 30))


def _label_key(labels: Dict[str, str]) -> str:
    """Canonical label string — doubles as the snapshot dict key and the
    Prometheus exposition label block (sans braces)."""
    if not labels:
        return ""
    esc = {k: str(v).replace("\\", "\\\\").replace('"', '\\"')
           .replace("\n", "\\n") for k, v in labels.items()}
    return ",".join(f'{k}="{esc[k]}"' for k in sorted(esc))


class Counter:
    """Monotone total. ``inc`` only accepts non-negative deltas."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        if not _enabled:
            return
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Log-bucketed histogram with Prometheus cumulative semantics.

    Optionally carries one **exemplar** — the trace id of the *worst
    recent* observation (docs/metrics.md#exemplars): an ``observe``
    that passes ``exemplar=`` replaces the stored one when its value is
    at least as large, or when the incumbent is older than
    ``exemplar_ttl_s`` (default HOROVOD_TPU_EXEMPLAR_TTL, 60 s — a
    stale champion must not pin the link forever: "worst recent", not
    "worst ever"). This is what lets an aggregate p99 (TTFT, failover)
    link to one concrete, inspectable request in the serving trace
    plane (docs/serving.md#request-tracing)."""

    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count",
                 "_ex_ttl", "_ex_value", "_ex_trace", "_ex_time")

    def __init__(self, buckets: Sequence[float],
                 exemplar_ttl_s: Optional[float] = None):
        self._lock = threading.Lock()
        self._bounds = sorted(float(b) for b in buckets)
        if not self._bounds:
            raise ValueError("histogram needs at least one bucket bound")
        # One count per finite bound plus the +Inf overflow slot.
        self._counts = [0] * (len(self._bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._ex_ttl = (_exemplar_ttl if exemplar_ttl_s is None
                        else float(exemplar_ttl_s))
        self._ex_value = 0.0
        self._ex_trace: Optional[str] = None
        self._ex_time = 0.0

    def observe(self, value: float, exemplar: Optional[str] = None,
                now: Optional[float] = None) -> None:
        if not _enabled:
            return
        v = float(value)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                t = time.time() if now is None else float(now)
                if (self._ex_trace is None or v >= self._ex_value
                        or t - self._ex_time > self._ex_ttl):
                    self._ex_value = v
                    self._ex_trace = str(exemplar)
                    self._ex_time = t

    @property
    def exemplar(self) -> Optional[dict]:
        """``{"value", "trace_id", "time_unix"}`` of the worst recent
        exemplar-carrying observation, or None."""
        with self._lock:
            if self._ex_trace is None:
                return None
            return {"value": self._ex_value, "trace_id": self._ex_trace,
                    "time_unix": self._ex_time}

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> dict:
        """``{"buckets": [[le, cumulative], ...], "sum", "count"}`` with
        the +Inf bucket last and equal to ``count``; plus ``"exemplar"``
        when one was recorded."""
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
            ex = (None if self._ex_trace is None else
                  {"value": self._ex_value, "trace_id": self._ex_trace,
                   "time_unix": self._ex_time})
        out = []
        cum = 0
        for le, c in zip(self._bounds, counts[:-1]):
            cum += c
            out.append([le, cum])
        out.append([math.inf, cum + counts[-1]])
        snap = {"buckets": out, "sum": s, "count": n}
        if ex is not None:
            snap["exemplar"] = ex
        return snap


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric family handing out per-label-set children."""

    __slots__ = ("name", "kind", "help", "_buckets", "_lock", "_children")

    def __init__(self, name: str, kind: str, help_text: str,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.kind = kind
        self.help = help_text
        self._buckets = buckets
        self._lock = threading.Lock()
        self._children: Dict[str, object] = {}

    def labels(self, **labels: str):
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if self.kind == "histogram":
                        child = Histogram(self._buckets or LATENCY_BUCKETS)
                    else:
                        child = _KINDS[self.kind]()
                    self._children[key] = child
        return child

    # Unlabeled convenience surface: family acts as its own "" child.

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        self.labels().observe(value, exemplar=exemplar)

    @property
    def value(self) -> float:
        return self.labels().value

    def clear(self) -> None:
        """Drop every child — for gauge families whose label sets are
        transient (per-stalled-tensor gauges must disappear when the
        stall resolves, or the export lies forever)."""
        with self._lock:
            self._children.clear()

    def items(self) -> List[Tuple[str, object]]:
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """Process-global named registry of metric families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help_text: str,
                buckets: Optional[Sequence[float]] = None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = _Family(name, kind, help_text, buckets)
                    self._families[name] = fam
        elif fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"requested {kind}")
        return fam

    def counter(self, name: str, help_text: str = "") -> _Family:
        return self._family(name, "counter", help_text)

    def gauge(self, name: str, help_text: str = "") -> _Family:
        return self._family(name, "gauge", help_text)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Optional[Sequence[float]] = None) -> _Family:
        return self._family(name, "histogram", help_text, buckets)

    def snapshot(self, prefix: Optional[str] = None) -> dict:
        """Plain-dict snapshot of every family (see module docstring).

        ``prefix`` (a string, or a tuple of strings) restricts the
        snapshot to families whose name starts with it — the cheap
        form for per-tick consumers (the fleet sampler, shim callbacks)
        that only ever read one corner of the registry and were
        deep-copying all of it every tick."""
        out: Dict[str, dict] = {}
        with self._lock:
            fams = list(self._families.values())
        if prefix is not None:
            fams = [f for f in fams if f.name.startswith(prefix)]
        for fam in fams:
            values = {}
            for key, child in fam.items():
                if isinstance(child, Histogram):
                    values[key] = child.snapshot()
                else:
                    values[key] = child.value
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "values": values}
        return out


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every layer of the port reports into."""
    return _registry


def snapshot(prefix: Optional[str] = None) -> dict:
    """``horovod_tpu_torch.metrics_snapshot()`` — one coherent dict of every
    metric (counters/gauges as floats, histograms with monotone
    cumulative bucket sums). Safe to call from any thread at any time.
    ``prefix=`` (string or tuple) restricts to matching family names —
    use it in per-tick consumers instead of snapshotting everything.

    There is deliberately NO reset: registry totals survive engine and
    executor resets (the reason the ad-hoc per-instance counters moved
    here), and hot paths cache child handles that a swap would orphan.
    Consumers wanting per-window numbers diff two snapshots."""
    return _registry.snapshot(prefix=prefix)
