"""Per-request distributed tracing for the serving tier
(docs/serving.md#request-tracing).

Counterpart of ``horovod_tpu/serving/reqtrace.py``, on the port's
``ops/timeline_py.PyTimeline``; the files have the JAX package's format,
so its merge tool (``python -m horovod_tpu.tools.trace``) reads them.
Dapper-style: ONE trace id per client request, minted by
the router (or accepted via ``X-Request-Id``) and propagated on every
dispatch, retry and mid-stream failover hop, with each process writing
the request's spans into its own catapult file:

  =============  ==========================================================
  ``REQUEST``    router: relay start → terminal outcome (the wall the
                 latency budget is attributed against)
  ``DISPATCH``   router: one attempt against one replica, tagged with
                 the outcome (done/crash/queue_full/...)
  ``FAILOVER``   router: failure detection → first token from the
                 replacement replica (phase, from, to)
  ``QUEUE_WAIT`` engine: submit → admission (the queue share)
  ``ADMIT``      engine: block reservation + prefix-cache probe
                 (blocks, prefix-hit tokens)
  ``PREFILL``    engine: prefill forward + first sample (bucket,
                 suffix tokens, compile-if-any)
  ``DECODE``     engine: one batched decode / speculative-verify chunk
                 as experienced by this request (tokens emitted,
                 proposed vs accepted for spec)
  ``EGRESS``     server/router: writing the result back to the client
  =============  ==========================================================

Each request renders as its own named row (row name == trace id), so
the merged Perfetto view shows one request's life crossing process
lanes, and the ``serving`` report (tools/trace.py) computes per-request
latency-budget tables, slowest-request rankings and failover chains
from the same files. Tenant + SLO verdict ride the span args — the
router's ``REQUEST`` and each egress' ``EGRESS`` carry ``tenant`` and
``slo_met`` (docs/serving.md#slo), so budget tables attribute per
tenant and flag the misses.

Clock domain: serving fleets spawned by ``fleet.py`` are same-host
processes (the supervisor owns local pipes), and ``time.monotonic`` is
CLOCK_MONOTONIC — one clock for every process on the host — so each
writer records offset 0/synced and the merge realigns purely through
``start_mono_us``. A multi-host serving tier would need an NTP-style
clock handshake; the file format already carries the fields.

Hot-path budget: span emission is the PyTimeline pattern — one module
attribute check when disabled, one tuple append when enabled; all
formatting happens on the writer's drain thread. The router writes its
``REQUEST``, ``DISPATCH`` and ``FAILOVER`` spans (``router.py``), the
engine and the server theirs.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from ..observability import register_final_flush
from ..ops.timeline_py import PyTimeline
from ..utils import env as _env

_log = logging.getLogger(__name__)

# The router's writer identity. Replica writers get
# ``1 + 100 * replica_id + generation`` so every (replica, incarnation)
# pair is a distinct trace "rank" (a restarted replica must not clobber
# or alias its dead predecessor's file — the predecessor's spans are the
# failover evidence) while the router anchors the merge at rank 0.
ROUTER_RANK = 0

_writer: Optional[PyTimeline] = None
_lock = threading.Lock()


def writer() -> Optional[PyTimeline]:
    """The process's request-trace writer, or None when tracing is off.
    Hot loops fetch this once per scheduler step and guard the whole
    emission block on ``is not None``."""
    return _writer


def span(trace_id: str, name: str, t0: float, t1: float,
         args: Optional[dict] = None) -> None:
    """Emit one complete span on the request's row — a no-op (one
    attribute check) when tracing is off."""
    w = _writer
    if w is not None:
        w.request_span(str(trace_id), name, t0, t1, args)


def _final_flush() -> None:
    w = _writer
    if w is not None:
        w.close()


def start(path: str, rank: int = 0, proc: Optional[str] = None,
          world: int = 0) -> PyTimeline:
    """Open the process's request-trace writer at ``path`` (replacing
    any previous one). Same-host clock domain: the writer records
    offset-to-rank-0 as 0/synced (see module docstring)."""
    global _writer
    with _lock:
        if _writer is not None:
            _writer.close()
        tl = PyTimeline(path, rank=rank, world=world, proc=proc)
        tl.set_clock_meta(0.0, 0.0)
        _writer = tl
    register_final_flush(_final_flush)
    return tl


def stop() -> None:
    """Close and detach the writer (flushes the buffered tail)."""
    global _writer
    with _lock:
        if _writer is not None:
            _writer.close()
            _writer = None


def maybe_start(role: Optional[str] = None) -> Optional[PyTimeline]:
    """Start the writer for this serving process when
    ``HOROVOD_TPU_REQTRACE`` names a directory (idempotent; a no-op
    otherwise). ``role="router"`` names the fleet router's file; every
    other process is a replica, identified by ``HOROVOD_TPU_REPLICA_ID``
    (0 standalone) and its restart incarnation
    (``HOROVOD_TPU_ELASTIC_GENERATION``) — the incarnation rides the
    file name so a restarted replica can never truncate its dead
    predecessor's trace."""
    if _writer is not None:
        return _writer
    directory = _env.reqtrace_dir()
    if not directory:
        return None
    os.makedirs(directory, exist_ok=True)
    if role == "router":
        rank, proc = ROUTER_RANK, "router"
        fname = "reqtrace-router.trace.json"
    else:
        idx = _env.replica_id() or 0
        gen = int(os.environ.get("HOROVOD_TPU_ELASTIC_GENERATION",
                                 "0") or 0)
        rank = 1 + 100 * idx + gen
        proc = f"replica{idx}" + (f"/gen{gen}" if gen else "")
        fname = f"reqtrace-replica{idx}-gen{gen}.trace.json"
    tl = start(os.path.join(directory, fname), rank=rank, proc=proc)
    _log.info("request tracing to %s (proc %s)", tl._path, proc)
    return tl
