"""Telemetry of the port: the typed registry (:mod:`.registry`) and its
snapshot, the exporters (:mod:`.export`: Prometheus text, JSON files,
the HTTP endpoint), the flight recorder (:mod:`.flight_recorder`), the
history sampler and health detectors (:mod:`.history`, :mod:`.health`),
all on one telemetry thread (:mod:`.ticker`).

The three hooks below are what the serving engine, the fault injector,
the QoS plane, the speculation tuner and the request tracer call: each
is one line into the flight recorder.

The name ``registry`` stays the submodule's; the accessor is
:func:`get_registry`.
"""

from typing import Callable

from . import flight_recorder as _flight
from .export import (MetricsServer, final_metrics_flush,
                     histogram_percentiles, maybe_start_exporters,
                     prometheus_text, stop_exporters, with_percentiles,
                     write_json_snapshot)
from .flight_recorder import FlightRecorder
from .flight_recorder import recorder as get_flight_recorder
from .health import Alert, HealthMonitor
from .history import HistorySampler, HistoryWriter, load_history
from .registry import (Counter, Gauge, Histogram, MetricsRegistry, enabled,
                       set_enabled)
from .registry import registry as get_registry
from .registry import snapshot as metrics_snapshot


def flight_note(kind: str, event: tuple) -> None:
    """One breadcrumb in the flight recorder's ring
    (``flight_recorder.recorder().note(kind, event)``)."""
    _flight.recorder().note(kind, event)


def flight_dump(reason: str) -> None:
    """The final gasp before a fault kills the process: dump the ring,
    flush the metrics file and every registered flush
    (``flight_recorder.dump_on``)."""
    _flight.dump_on(reason)


def register_final_flush(fn: Callable[[], None]) -> None:
    """Run ``fn`` on every final-gasp path beside the recorder's dump
    (``flight_recorder.register_final_flush``)."""
    _flight.register_final_flush(fn)


__all__ = [
    "Alert", "Counter", "FlightRecorder", "Gauge", "HealthMonitor",
    "Histogram", "HistorySampler", "HistoryWriter", "MetricsRegistry",
    "MetricsServer", "enabled", "final_metrics_flush", "flight_dump",
    "flight_note", "get_flight_recorder", "get_registry",
    "histogram_percentiles", "load_history", "maybe_start_exporters",
    "metrics_snapshot", "prometheus_text", "register_final_flush",
    "set_enabled", "stop_exporters", "with_percentiles",
    "write_json_snapshot",
]
