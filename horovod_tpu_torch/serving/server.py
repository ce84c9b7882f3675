"""Stdlib HTTP front end for the inference engine.

Counterpart of ``horovod_tpu/serving/server.py``, copied: the same
routes, bodies, status codes and headers. ``http.server.
ThreadingHTTPServer``, one handler thread per connection, all of them
funneling into the engine's thread-safe ``submit``; one scheduler loop
thread drives ``InferenceEngine.step`` (and with it every forward on the
card).

Routes:

  ``POST /generate``   {"tokens": [...], "max_new_tokens"?,
                        "temperature"?, "stream"?, "deadline_ms"?} →
                        200 {"tokens", "id", "ttft_ms", "latency_ms"}
                        (or an NDJSON token stream with "stream": true);
                        429 + ``Retry-After`` when the bounded queue is
                        full; 503 + ``Connection: close`` while
                        draining; 504 past the deadline; 400 on a bad
                        body.
  ``GET /healthz``     LIVENESS: 200 while the process can answer —
                        including during a drain (status flips to
                        "draining" but the code stays 200, so a
                        supervisor doesn't shoot a replica that is
                        cleanly finishing its work).
  ``GET /readyz``      READINESS: 200 {"status": "ready"} while
                        admitting; 503 {"status": "draining"} once a
                        drain began — the fleet router stops routing
                        here the moment this flips
                        (docs/serving.md#fleet).

Token streaming (``"stream": true``): the reply is
``application/x-ndjson`` with no Content-Length — one ``{"id": ...}``
header line, one ``{"t": <token>}`` line per generated token flushed as
it is sampled, and a final ``{"done": true, ...}`` line, then the
connection closes. A connection that closes WITHOUT a ``done`` line
means the replica died mid-generation — that is exactly the signal the
fleet router's mid-stream failover keys on.

Metrics get no route here: they go to the registry
(``horovod_tpu_torch.metrics_snapshot()``), whose exporter endpoint
waits for ROADMAP Queue 1 item 5, as in the JAX package, where one
scrape target serves every family.

Shutdown: ``install_signal_handlers`` makes SIGTERM/SIGINT request a
graceful drain — admission stops (``/readyz`` flips 503), every
ACCEPTED request completes (queued ones included — acceptance is a
promise, see ``InferenceEngine.drain``), then the process exits 0.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
import time
from typing import Optional

from ..observability import registry as _obs
from ..utils import env as _env
from . import reqtrace as _rt
from . import slo as _slo
from .engine import (DEADLINE_ERROR, DrainingError, InferenceEngine,
                     QueueFullError)
from .qos import QuotaExceededError

_log = logging.getLogger(__name__)

# A generation can legitimately take a while under load; handlers wait
# this long on the ticket before giving up with a 504.
REQUEST_TIMEOUT_S = 600.0


def _http_metrics():
    return _obs.registry().counter(
        "hvdtpu_serving_http_requests_total",
        "HTTP requests served, by route and status code")


class ServingServer:
    """HTTP front + scheduler loop around one :class:`InferenceEngine`.

    ``port=0`` binds an ephemeral port (tests); default comes from
    ``HOROVOD_TPU_SERVING_PORT``.
    """

    def __init__(self, engine: InferenceEngine,
                 port: Optional[int] = None, host: str = "0.0.0.0"):
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer

        self.engine = engine
        self._stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        self._http = _http_metrics()
        # Live /generate handlers: shutdown() must not close the process
        # under a handler still flushing a drained generation to its
        # client — that would turn a zero-drop drain into a dropped
        # response at the socket layer.
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, payload: dict, route: str,
                       headers: Optional[dict] = None) -> None:
                # Count BEFORE writing: the client may observe the
                # response (and assert on the metric) the instant the
                # body lands.
                outer._http.labels(route=route, code=str(code)).inc()
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                    if k.lower() == "connection" \
                            and str(v).lower() == "close":
                        self.close_connection = True
                self.end_headers()
                self.wfile.write(body)

            def _drop_health(self) -> bool:
                """drop_health fault (docs/adaptation.md): hang up on
                the probe without any status line — the supervisor's
                probe timeout, not the HTTP code, must catch it."""
                inj = outer.engine._inj
                if inj is not None and inj.drop_health_active():
                    self.close_connection = True
                    return True
                return False

            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?")[0]
                eng = outer.engine
                if path == "/healthz":
                    if self._drop_health():
                        return
                    # Liveness: 200 even while draining — the process
                    # is alive and finishing promised work.
                    self._reply(200, {
                        "status": ("draining" if outer._stop.is_set()
                                   else "serving"),
                        "active_requests": eng.active_count,
                        "queue_depth": eng.queue_depth,
                        "batch_slots": eng.config.max_batch_slots,
                        "kv_blocks_free": eng._alloc.free,
                        "kv_blocks_total": eng._alloc.total,
                        # the fleet router hashes prompt prefixes at
                        # this granularity to score cache warmth
                        "block_size": eng.config.block_size,
                        "prefix_cache": eng._prefix is not None,
                        # live session leases — the router pins these
                        # sessions here (docs/serving.md#session-affinity)
                        "sessions": eng.session_ids(),
                        "session_leases": eng.config.session_leases,
                        # per-QoS-class queued/active counts + the
                        # interactive slot reservation — the router's
                        # class-aware scoring reads these
                        # (docs/serving.md#qos)
                        "qos_classes": eng.class_counts(),
                        "reserved_slots": eng.config.reserved_slots,
                    }, "healthz")
                    return
                if path == "/readyz":
                    if self._drop_health():
                        return
                    if outer._stop.is_set():
                        self._reply(503, {"status": "draining"},
                                    "readyz",
                                    headers={"Connection": "close"})
                    else:
                        self._reply(200, {"status": "ready"}, "readyz")
                    return
                self._reply(404, {"error": "not found"}, "other")

            def do_POST(self):  # noqa: N802 (http.server API)
                if self.path.split("?")[0] != "/generate":
                    self._reply(404, {"error": "not found"}, "other")
                    return
                with outer._inflight_lock:
                    outer._inflight += 1
                try:
                    self._generate()
                finally:
                    with outer._inflight_lock:
                        outer._inflight -= 1

            def _generate(self) -> None:
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    tokens = body["tokens"]
                    if not isinstance(tokens, list):
                        raise ValueError("'tokens' must be a list")
                    stream = bool(body.get("stream", False))
                    deadline_ms = body.get(
                        "deadline_ms",
                        self.headers.get("X-Request-Deadline-Ms"))
                    deadline_s = None if deadline_ms in (None, "") \
                        else float(deadline_ms) / 1e3
                    # Tenant + SLO attribution: router forwards the
                    # tenant in X-Tenant (body "tenant" for plain
                    # clients); "slo" is always body-borne
                    # (docs/serving.md#slo).
                    tenant = self.headers.get("X-Tenant") \
                        or body.get("tenant")
                    _slo.parse_slo(body.get("slo"))
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    self._reply(400, {"error": f"bad request: {e}"},
                                "generate")
                    return
                if deadline_s is not None and deadline_s <= 0:
                    if tenant or body.get("slo") is not None:
                        _slo.record_shed(_slo.resolve_tenant(tenant),
                                         "deadline")
                    self._reply(504, {"error": DEADLINE_ERROR},
                                "generate")
                    return
                # One request identity end-to-end: the router ships its
                # trace id in X-Request-Id (body "request_id" for plain
                # clients); absent, the engine mints one
                # (docs/serving.md#request-tracing).
                trace_id = self.headers.get("X-Request-Id") \
                    or body.get("request_id")
                # Conversation identity for session affinity: the
                # router forwards it in X-Session-Id (body
                # "session_id" for plain clients).
                session_id = self.headers.get("X-Session-Id") \
                    or body.get("session_id")
                try:
                    req = outer.engine.submit(
                        tokens,
                        max_new_tokens=body.get("max_new_tokens"),
                        temperature=body.get("temperature"),
                        deadline_s=deadline_s,
                        trace_id=trace_id,
                        session_id=session_id,
                        tenant=tenant,
                        slo=body.get("slo"))
                except QuotaExceededError as e:
                    # Quota 429: Retry-After from the tenant's own
                    # measured drain rate (docs/serving.md#qos), not
                    # the global queue estimate.
                    self._reply(429, {"error": str(e)}, "generate",
                                headers={"Retry-After":
                                         e.retry_after_s})
                    return
                except QueueFullError as e:
                    self._reply(429, {"error": str(e)}, "generate",
                                headers={"Retry-After":
                                         outer.engine.retry_after_s()})
                    return
                except DrainingError as e:
                    # Draining: this replica will never take the
                    # request — close the connection so clients (and
                    # the router) re-resolve instead of reusing a
                    # socket into a dying server.
                    self._reply(503, {"error": str(e)}, "generate",
                                headers={"Connection": "close"})
                    return
                except ValueError as e:
                    self._reply(400, {"error": str(e)}, "generate")
                    return
                wait_s = REQUEST_TIMEOUT_S if deadline_s is None \
                    else min(REQUEST_TIMEOUT_S, deadline_s + 5.0)
                if stream:
                    self._stream(req, wait_s)
                    return
                try:
                    out = req.result(timeout=wait_s)
                except TimeoutError as e:
                    self._reply(504, {"error": str(e)}, "generate")
                    return
                except RuntimeError as e:
                    code = 504 if DEADLINE_ERROR in str(e) else 503
                    self._reply(code, {"error": str(e)}, "generate")
                    return
                t_egress = time.monotonic()
                reply = {
                    "id": req.id,
                    "trace_id": req.trace_id,
                    "tokens": out,
                    "ttft_ms": round(req.ttft_s * 1e3, 3),
                    "latency_ms": round(
                        (req.t_done - req.t_submit) * 1e3, 3),
                }
                egress_args = {"tokens": len(out)}
                if req.tenant:
                    reply["tenant"] = req.tenant
                    egress_args["tenant"] = req.tenant
                if req.slo_verdict is not None:
                    reply["slo"] = req.slo_verdict
                    egress_args["slo_met"] = \
                        req.slo_verdict["slo_met"]
                self._reply(200, reply, "generate")
                _rt.span(req.trace_id, "EGRESS", t_egress,
                         time.monotonic(), egress_args)

            def _stream(self, req, wait_s: float) -> None:
                """NDJSON token stream: header line, one line per
                token as it lands, terminal ``done`` line. No
                Content-Length — the close is the framing."""
                outer._http.labels(route="generate", code="200").inc()
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Cache-Control", "no-store")
                self.close_connection = True
                self.end_headers()

                def line(obj) -> None:
                    self.wfile.write(json.dumps(obj).encode() + b"\n")
                    self.wfile.flush()

                t_end = time.monotonic() + wait_s
                try:
                    line({"id": req.id, "trace_id": req.trace_id})
                    idx = 0
                    while True:
                        fresh = req.next_tokens(
                            idx, timeout=max(0.0,
                                             t_end - time.monotonic()))
                        for t in fresh:
                            line({"t": int(t)})
                        idx += len(fresh)
                        if req.done and not fresh:
                            break
                    meta = {"done": True, "status": req.status,
                            "n": idx, "trace_id": req.trace_id}
                    if req.status == "completed":
                        meta["ttft_ms"] = round(req.ttft_s * 1e3, 3)
                        meta["latency_ms"] = round(
                            (req.t_done - req.t_submit) * 1e3, 3)
                    else:
                        meta["error"] = req.error
                    egress_args = {"tokens": idx}
                    if req.tenant:
                        meta["tenant"] = req.tenant
                        egress_args["tenant"] = req.tenant
                    if req.slo_verdict is not None:
                        meta["slo"] = req.slo_verdict
                        egress_args["slo_met"] = \
                            req.slo_verdict["slo_met"]
                    t_egress = time.monotonic()
                    line(meta)
                    _rt.span(req.trace_id, "EGRESS", t_egress,
                             time.monotonic(), egress_args)
                except TimeoutError:
                    line({"done": True, "status": "failed",
                          "error": "stream timed out", "n": idx})
                except (BrokenPipeError, ConnectionResetError,
                        OSError):
                    # Client hung up mid-stream; the generation keeps
                    # decoding (its slot finishes normally) — nothing
                    # to clean up here.
                    pass

            def log_message(self, *args):  # silence per-request stderr
                pass

        port = _env.serving_port() if port is None else int(port)
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd-tpu-serving-http",
            daemon=True)

    # -------------------------------------------------------- lifecycle

    def start(self) -> None:
        """Start the HTTP listener and the scheduler loop thread."""
        self._http_thread.start()
        self._loop_thread = threading.Thread(
            target=self._loop, name="hvd-tpu-serving-sched", daemon=True)
        self._loop_thread.start()
        _log.info("serving on :%d (/generate, /healthz, /readyz)",
                  self.port)

    def _loop(self) -> None:
        eng = self.engine
        while not self._stop.is_set():
            if not eng.step():
                eng.wait_for_work(0.05)

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT → graceful drain: the serve loop stops, every
        accepted request finishes, and the process exits cleanly."""
        def _on_signal(signum, frame):
            self.request_stop()

        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)

    def request_stop(self) -> None:
        self._stop.set()
        with self.engine._work:
            self.engine._work.notify_all()

    def serve_forever(self) -> None:
        """Block until a stop is requested, then drain and shut down."""
        if self._loop_thread is None:
            self.start()
        while not self._stop.wait(0.1):
            pass
        self.shutdown()

    def shutdown(self) -> None:
        """Drain (finish every accepted request) and stop."""
        self._stop.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=30.0)
        self.engine.drain()
        # Let handler threads flush the drained results to their
        # clients before tearing the listener (and the process) down.
        t_end = time.monotonic() + 10.0
        while time.monotonic() < t_end:
            with self._inflight_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.02)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._http_thread.join(timeout=5.0)
        _log.info("serving drained and stopped")
