"""Metrics of the port: the typed registry (:mod:`.registry`) and its
snapshot, and the flight recorder's hooks.

The JAX package's exporters (the Prometheus endpoint, the JSON file
writer) and its flight recorder are not ported yet: each of their call
sites in the port calls one of the no-op hooks below, which record
nothing.

The name ``registry`` stays the submodule's; the accessor is
:func:`get_registry`.
"""

from typing import Callable

from .registry import (Counter, Gauge, Histogram, MetricsRegistry, enabled,
                       set_enabled)
from .registry import registry as get_registry
from .registry import snapshot as metrics_snapshot


def flight_note(kind: str, event: tuple) -> None:
    """Hook for the flight recorder's breadcrumb (the JAX package's
    ``flight_recorder.recorder().note(kind, event)``). The port has no
    flight recorder yet, so it records nothing."""


def flight_dump(reason: str) -> None:
    """Hook for the flight recorder's final-gasp dump before a fault
    kills the process (JAX's ``flight_recorder.dump_on``). Records
    nothing: the port has no flight recorder yet."""


def register_final_flush(fn: Callable[[], None]) -> None:
    """Hook for the flight recorder's exit-time flush list (JAX's
    ``flight_recorder.register_final_flush``). The port's trace writers
    close themselves at exit (``atexit``), so nothing is registered."""


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "enabled",
           "flight_dump", "flight_note", "get_registry", "metrics_snapshot",
           "register_final_flush", "set_enabled"]
