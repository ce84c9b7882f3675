"""Metrics export: Prometheus text exposition, JSON snapshot files, and
the HTTP endpoint.

Counterpart of ``horovod_tpu/observability/export.py``, copied: three
surfaces over the one registry snapshot (``registry.py``).

  - ``horovod_tpu_torch.metrics_snapshot()``: the in-process dict.
  - ``HOROVOD_TPU_METRICS_FILE=/path.json``: the shared telemetry
    thread rewrites the file (tmp + rename) every
    ``HOROVOD_TPU_METRICS_INTERVAL`` seconds (default 15), plus one
    final flush at exit. A ``{rank}`` placeholder gives each rank its
    file; without it only rank 0 writes.
  - ``HOROVOD_TPU_METRICS_PORT=9091``: rank 0 serves Prometheus text
    (version 0.0.4; OpenMetrics with exemplars when the scraper asks
    for it) at ``/metrics`` and the JSON snapshot, with percentiles, at
    ``/metrics.json`` (``?prefix=a_,b_`` selects families), over stdlib
    ``http.server``. Port 0 binds an ephemeral port, which
    :func:`server_port` reports: a serving replica announces it as
    ``metrics=:PORT`` on its ready line, and the fleet's router scrapes
    its load from there.

Everything starts from :func:`maybe_start_exporters` (``init`` calls
it; so do the serving replica and the fleet supervisor), idempotent and
a no-op when neither variable is set.
"""

from __future__ import annotations

import atexit
import json
import logging
import math
import os
import threading
from typing import Optional

from ..utils import env as _env
from . import registry as _reg

_log = logging.getLogger(__name__)

METRICS_FILE_ENV = "HOROVOD_TPU_METRICS_FILE"
METRICS_PORT_ENV = "HOROVOD_TPU_METRICS_PORT"
METRICS_INTERVAL_ENV = "HOROVOD_TPU_METRICS_INTERVAL"


# --------------------------------------------------------------------------
# Prometheus text exposition
# --------------------------------------------------------------------------

def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _exemplar_suffix(val: dict, le, prev_le) -> str:
    """OpenMetrics exemplar annotation for one ``_bucket`` line — the
    exemplar belongs on the bucket *containing* its value (spec: an
    exemplar's value must lie within the bucket's range). Empty string
    when this bucket doesn't own it."""
    ex = val.get("exemplar")
    if not ex:
        return ""
    v = ex["value"]
    hi = math.inf if isinstance(le, str) else float(le)
    lo = -math.inf if prev_le is None else (
        math.inf if isinstance(prev_le, str) else float(prev_le))
    if not (lo < v <= hi or (math.isinf(hi) and v > lo)):
        return ""
    tid = str(ex["trace_id"]).replace("\\", "\\\\").replace('"', '\\"')
    return (f' # {{trace_id="{tid}"}} {_fmt(v)}'
            f' {_fmt(round(ex.get("time_unix", 0.0), 3))}')


def prometheus_text(snap: Optional[dict] = None, *,
                    exemplars: bool = False,
                    percentiles: bool = True) -> str:
    """Render a registry snapshot as Prometheus text exposition format
    (version 0.0.4): ``# HELP`` / ``# TYPE`` headers, ``_bucket`` series
    with cumulative ``le`` labels ending at ``+Inf``, ``_sum`` and
    ``_count`` per histogram.

    ``percentiles=True`` (default) additionally emits ``{name}_p50`` /
    ``{name}_p90`` / ``{name}_p99`` gauge series per histogram — the
    same log-bucket estimate ``/metrics.json`` already serves, so
    scrape-only consumers (dashboards with no recording rules) see the
    percentile view too.

    ``exemplars=True`` appends each histogram's worst-recent exemplar
    (docs/metrics.md#exemplars) to the ``_bucket`` line containing its
    value, in OpenMetrics syntax (``# {trace_id="..."} value ts``) —
    the endpoint enables this when the scraper negotiates
    ``application/openmetrics-text`` (v0.0.4 has no exemplar syntax)."""
    snap = snap if snap is not None else _reg.snapshot()
    lines = []
    for name in sorted(snap):
        fam = snap[name]
        if fam["help"]:
            esc = fam["help"].replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {name} {esc}")
        lines.append(f"# TYPE {name} {fam['type']}")
        pct_lines = {q: [] for q in ("p50", "p90", "p99")}
        for label_key in sorted(fam["values"]):
            val = fam["values"][label_key]
            if fam["type"] == "histogram":
                prev_le = None
                for le, cum in val["buckets"]:
                    lab = (label_key + "," if label_key else "") \
                        + f'le="{_fmt(le)}"'
                    ex = (_exemplar_suffix(val, le, prev_le)
                          if exemplars else "")
                    lines.append(f"{name}_bucket{{{lab}}} {cum}{ex}")
                    prev_le = le
                block = f"{{{label_key}}}" if label_key else ""
                lines.append(f"{name}_sum{block} {_fmt(val['sum'])}")
                lines.append(f"{name}_count{block} {val['count']}")
                if percentiles:
                    pct = histogram_percentiles(val, (0.5, 0.9, 0.99))
                    for q, v in pct.items():
                        pct_lines[q].append(
                            f"{name}_{q}{block} {_fmt(v)}")
            else:
                block = f"{{{label_key}}}" if label_key else ""
                lines.append(f"{name}{block} {_fmt(val)}")
        for q in ("p50", "p90", "p99"):
            if pct_lines[q]:
                lines.append(
                    f"# TYPE {name}_{q} gauge")
                lines.extend(pct_lines[q])
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# Percentile estimation from log-bucketed histogram snapshots
# --------------------------------------------------------------------------

def histogram_percentiles(hist: dict, qs=(0.5, 0.9, 0.99)) -> dict:
    """Estimate percentiles from a histogram snapshot
    (``{"buckets": [[le, cumulative], ...], "count", ...}`` — the
    registry's format, with ``le`` possibly the string "+Inf" when the
    snapshot came through strict JSON).

    Prometheus-style linear interpolation within the containing bucket:
    exact to within one bucket width — the resolution the log-bucketed
    layout was chosen for. The +Inf bucket has no upper bound, so a
    percentile landing there returns the largest finite bound (a known
    underestimate; the export cannot do better without raw samples).
    Returns ``{"p50": v, ...}`` keyed by percentile name, or {} for an
    empty histogram.

    Used by both the trace report (tools/trace.py routes its lateness
    samples through the same bucket layout) and the HTTP endpoint's
    ``/metrics.json`` view, so offline and live numbers come from one
    estimator."""
    count = hist.get("count", 0)
    buckets = hist.get("buckets") or []
    if not count or not buckets:
        return {}
    bounds = [math.inf if isinstance(le, str) else float(le)
              for le, _ in buckets]
    cums = [c for _, c in buckets]
    finite = [b for b in bounds if not math.isinf(b)]
    top = finite[-1] if finite else 0.0
    out = {}
    for q in qs:
        target = q * count
        v = top
        for i, cum in enumerate(cums):
            if cum >= target:
                hi = bounds[i]
                lo = bounds[i - 1] if i > 0 else 0.0
                prev = cums[i - 1] if i > 0 else 0
                if math.isinf(hi):
                    v = top
                elif cum == prev:
                    v = hi
                else:
                    v = lo + (hi - lo) * (target - prev) / (cum - prev)
                break
        name = f"p{q * 100:g}".replace(".", "_")
        out[name] = v
    return out


def with_percentiles(snap: dict, qs=(0.5, 0.9, 0.99)) -> dict:
    """Add a ``"percentiles"`` dict to every histogram value of a
    (json-safe) snapshot — the endpoint's JSON view, so dashboards get
    p50/p90/p99 without re-implementing bucket math."""
    for fam in snap.values():
        if fam["type"] != "histogram":
            continue
        for val in fam["values"].values():
            val["percentiles"] = histogram_percentiles(val, qs)
    return snap


# --------------------------------------------------------------------------
# JSON snapshot file
# --------------------------------------------------------------------------

def json_safe_snapshot(prefix=None) -> dict:
    """Registry snapshot with ``inf`` bucket bounds replaced by the
    string "+Inf" — strict JSON (``json.dumps`` would emit the invalid
    bare ``Infinity`` literal otherwise). ``prefix=`` filters families
    like :func:`registry.snapshot` (a str or a tuple of prefixes) —
    per-tick consumers (the fleet history sampler scraping
    ``/metrics.json?prefix=hvdtpu_serving_,hvdtpu_slo_``) should never
    serialize the whole registry."""
    snap = _reg.snapshot(prefix=prefix)
    for fam in snap.values():
        if fam["type"] != "histogram":
            continue
        for val in fam["values"].values():
            val["buckets"] = [["+Inf" if math.isinf(le) else le, c]
                              for le, c in val["buckets"]]
    return snap


def write_json_snapshot(path: str) -> None:
    """One atomic JSON snapshot write (tmp + rename — a scraper reading
    mid-write must never see a torn file)."""
    snap = json_safe_snapshot()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _resolved_file_path() -> Optional[str]:
    path = _env.metrics_file()
    if not path:
        return None
    rank = _process_index()
    if "{rank}" in path:
        return path.replace("{rank}", str(rank))
    return path if rank == 0 else None


def _process_index() -> int:
    """This process's rank once ``init`` ran; 0 before it and in a
    process that never calls it (a serving replica, the supervisor)."""
    from .. import topology as _topo
    return _topo._get().rank if _topo.is_initialized() else 0


class _JsonWriter:
    """Periodic JSON snapshot writes, scheduled on the ONE shared
    telemetry timer thread (observability/ticker.py), never a thread of its own."""

    def __init__(self, path: str, interval_s: float):
        self._path = path
        from . import ticker as _ticker
        self._handle = _ticker.ticker().add(
            "metrics-file", interval_s, self._write, final=self._write)

    def _write(self):
        try:
            write_json_snapshot(self._path)
        except OSError as e:  # never fail the job over telemetry
            _log.warning("metrics snapshot write failed: %s", e)

    def stop(self):
        from . import ticker as _ticker
        _ticker.ticker().remove(self._handle)  # runs the final flush


# --------------------------------------------------------------------------
# HTTP endpoint (stdlib only)
# --------------------------------------------------------------------------

class MetricsServer:
    """Prometheus + JSON endpoint over ``http.server`` (no new deps).

    ``/metrics``       → text exposition (Content-Type the Prometheus
                         scraper expects, version 0.0.4)
    ``/metrics.json``  → the raw snapshot dict
    """

    def __init__(self, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                route, _, query = self.path.partition("?")
                params = dict(
                    kv.split("=", 1) for kv in query.split("&")
                    if "=" in kv)
                prefix = params.get("prefix") or None
                if prefix and "," in prefix:
                    # Comma-separated prefixes select a union of
                    # families (the fleet history sampler scrapes
                    # ?prefix=hvdtpu_serving_,hvdtpu_slo_) — the
                    # registry accepts a tuple.
                    prefix = tuple(p for p in prefix.split(",") if p)
                if route == "/metrics":
                    # Content negotiation: a scraper that asks for
                    # OpenMetrics gets exemplars (# {trace_id=...}
                    # syntax) and the EOF marker; v0.0.4 text has no
                    # exemplar syntax, so the default stays clean.
                    accept = self.headers.get("Accept", "")
                    om = "openmetrics" in accept
                    text = prometheus_text(
                        _reg.snapshot(prefix=prefix), exemplars=om)
                    if om:
                        body = (text + "# EOF\n").encode()
                        ctype = ("application/openmetrics-text; "
                                 "version=1.0.0; charset=utf-8")
                    else:
                        body = text.encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif route == "/metrics.json":
                    body = json.dumps(
                        with_percentiles(json_safe_snapshot(prefix)),
                        sort_keys=True).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr
                pass

        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="hvd-tpu-metrics-http",
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


# --------------------------------------------------------------------------
# Lifecycle
# --------------------------------------------------------------------------

_lock = threading.Lock()
_json_writer: Optional[_JsonWriter] = None
_server: Optional[MetricsServer] = None
_started = False


def maybe_start_exporters() -> None:
    """Start whichever exporters the env configures (idempotent; called
    by ``init()``). A plain HTTP port is rank-0 only — one scrape
    target per job, like the reference's rank-0 timeline file; the
    per-rank port forms (``{rank}`` placeholder / ``base+rank``) bind an
    endpoint on EVERY process so multi-process jobs are scrapeable per
    rank. JSON files are per-process when the path has a ``{rank}``
    placeholder."""
    global _json_writer, _server, _started
    if not _reg.enabled():
        return
    with _lock:
        if _started:
            return
        _started = True
        path = _resolved_file_path()
        if path:
            _json_writer = _JsonWriter(path, _env.metrics_interval_secs())
        rank = _process_index()
        port = _env.metrics_port(rank)
        if port is not None and (rank == 0 or _env.metrics_port_per_rank()):
            try:
                _server = MetricsServer(port)
                _log.info("metrics endpoint on :%d (/metrics, "
                          "/metrics.json)", _server.port)
            except OSError as e:
                _log.warning("metrics endpoint failed to bind: %s", e)
        if _json_writer is not None or _server is not None:
            atexit.register(stop_exporters)


def final_metrics_flush() -> None:
    """Final-gasp snapshot write (docs/postmortem.md): rewrite the
    configured HOROVOD_TPU_METRICS_FILE with the current registry state
    RIGHT NOW — called from the flight recorder's crash hooks so the
    file is never stale-at-death (the periodic writer's last pass can
    be up to one interval old, and a SIGKILLed process never reaches
    its stop() flush). Works whether or not the periodic writer was
    started; a no-op when no file is configured."""
    path = _resolved_file_path()
    if not path:
        return
    try:
        write_json_snapshot(path)
    except OSError as e:  # never fail a death path over telemetry
        _log.warning("final metrics flush failed: %s", e)


def server_port() -> Optional[int]:
    """Port of the live metrics endpoint, or None when none is bound.
    HOROVOD_TPU_METRICS_PORT=0 binds an ephemeral port — this is how a
    caller (the serving replica announcing itself to the fleet
    supervisor, docs/serving.md#fleet) learns which one."""
    with _lock:
        return _server.port if _server is not None else None


def stop_exporters() -> None:
    """Stop the exporters, flushing one final JSON snapshot."""
    global _json_writer, _server, _started
    with _lock:
        if _json_writer is not None:
            _json_writer.stop()
            _json_writer = None
        if _server is not None:
            _server.stop()
            _server = None
        _started = False
