"""Elastic training: survive worker loss without restarting from
scratch.

Counterpart of ``horovod_tpu/elastic`` for the part ported so far:

  - failure detection (:mod:`.failure`): the typed
    :class:`WorkerFailure` event, escalation knobs
    (:class:`FailureConfig`), and the driver-side
    :class:`FailureDetector`; worker-side escalation lives in the
    collective engine behind ``HOROVOD_TPU_FAILURE_TIMEOUT``.
  - elastic state (:mod:`.state`): :class:`ElasticState` —
    commit/rollback/restore over the checkpoint convention or the
    sharded engine, with broadcast-on-rejoin.

``generation()`` is the topology's elastic generation. Host discovery
and the elastic driver loop (``run_elastic``) wait for the port's
runner.
"""

from ..topology import generation
from .failure import (FailureConfig, FailureDetector, SlowRankFailure,
                      WorkerFailure, failure_from_event)
from .state import ElasticState

__all__ = [
    "WorkerFailure", "SlowRankFailure", "failure_from_event",
    "FailureConfig", "FailureDetector", "ElasticState", "generation",
]
