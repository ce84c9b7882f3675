"""Elastic training: survive worker loss without restarting from
scratch.

Counterpart of ``horovod_tpu/elastic``, in four pieces:

  - discovery (:mod:`.discovery`): the :class:`HostProvider` interface
    with static-hostfile, ssh-probe, and GCE-metadata/TPU-pod backends
    feeding the runner's launch plane.
  - failure detection (:mod:`.failure`): the typed
    :class:`WorkerFailure` event, escalation knobs
    (:class:`FailureConfig`), and the driver-side
    :class:`FailureDetector`; worker-side escalation lives in the
    collective engine behind ``HOROVOD_TPU_FAILURE_TIMEOUT``.
  - elastic state (:mod:`.state`): :class:`ElasticState` —
    commit/rollback/restore over the checkpoint convention or the
    sharded engine, with broadcast-on-rejoin.
  - driver loop (:mod:`.driver`): :func:`run_elastic` /
    :func:`run_elastic_command` — discover, launch a generation through
    the port's runner, detect failure, shrink/grow, re-rendezvous.

``generation()`` is the topology's elastic generation (after ``init``).
"""

from ..topology import generation
from .discovery import (HostfileProvider, HostProvider, SSHProbeProvider,
                        StaticProvider, TPUPodProvider, get_provider,
                        host_alive)
from .failure import (FailureConfig, FailureDetector, SlowRankFailure,
                      WorkerFailure, failure_from_event)
from .state import ElasticState
from .driver import run_elastic, run_elastic_command

__all__ = [
    "HostProvider", "StaticProvider", "HostfileProvider",
    "SSHProbeProvider", "TPUPodProvider", "get_provider", "host_alive",
    "WorkerFailure", "SlowRankFailure", "failure_from_event",
    "FailureConfig", "FailureDetector", "ElasticState", "run_elastic",
    "run_elastic_command", "generation",
]
