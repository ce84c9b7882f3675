"""Telemetry history: the durable, queryable signal store behind the
health plane.

Counterpart of ``horovod_tpu/observability/history.py``, copied: the
files are byte-compatible, so ``python -m horovod_tpu.tools.health``
and JAX's :func:`load_history` read a port process's history.

  - A sampler (one task on the shared telemetry thread, ``ticker.py``)
    snapshots the registry every ``HOROVOD_TPU_HISTORY_INTERVAL``
    (default 5 s) and reduces consecutive snapshots to per-window
    series: counter rates, gauge values, and histogram deltas as
    windowed ``|p50``/``|p99`` (the log-bucket estimator), exact
    ``|mean`` (from sum and count) and ``|rate``.
  - Each sample appends one JSON line to
    ``<HOROVOD_TPU_HISTORY>/history-{label}.jsonl``: header first,
    flushed per line (a SIGKILL leaves a valid prefix), size-capped
    with rotation (``.1`` .. ``.N``, oldest deleted), and a final
    sample registered with the flight recorder's death paths.
  - The same series feed the health detectors (``health.py``) live.

Series keys: ``{family}{{label_block}}`` for counters (rate/s) and
gauges (last value); histogram series add ``|p50``, ``|p99``,
``|mean`` or ``|rate``. A sampler reads any snapshot-shaped source:
the local registry, or a replica's scraped ``/metrics.json`` (the fleet
supervisor keeps ``history-replica{i}.jsonl`` for each replica, so its
trends outlive it: ``serving/fleet.py``).
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..utils import env as _env
from . import registry as _reg
from .export import histogram_percentiles

_log = logging.getLogger(__name__)

SCHEMA_VERSION = 1

# Recording lever, one module-global check like registry._enabled: a
# disabled sampler skips its tick (the task stays scheduled).
_enabled = True


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> None:
    global _enabled
    _enabled = bool(value)


# --------------------------------------------------------------------------
# Snapshot deltas → flat series
# --------------------------------------------------------------------------

def _series_key(name: str, label_key: str) -> str:
    return f"{name}{{{label_key}}}" if label_key else name


def _delta_hist(prev: Optional[dict], cur: dict) -> Optional[dict]:
    """Windowed histogram: bucket/sum/count deltas between two
    cumulative snapshots (prev None = everything is new). Returns a
    snapshot-shaped dict for the percentile estimator, or None when
    nothing landed in the window. Tolerates "+Inf" string bounds
    (snapshots that crossed strict JSON)."""
    pc = {b[0] if isinstance(b[0], str) else float(b[0]): b[1]
          for b in (prev or {}).get("buckets", [])}
    dcount = cur.get("count", 0) - (prev or {}).get("count", 0)
    if dcount <= 0:
        return None
    buckets = []
    for le, cum in cur.get("buckets", []):
        key = le if isinstance(le, str) else float(le)
        buckets.append([le, cum - pc.get(key, 0)])
    return {"buckets": buckets, "count": dcount,
            "sum": cur.get("sum", 0.0) - (prev or {}).get("sum", 0.0)}


def series_from_snapshots(prev: Optional[dict], cur: dict,
                          dt_s: float) -> Dict[str, float]:
    """Reduce two consecutive registry snapshots to this window's flat
    series dict (see module docstring for the key scheme)."""
    dt_s = max(dt_s, 1e-9)
    out: Dict[str, float] = {}
    for name, fam in cur.items():
        kind = fam.get("type")
        pvals = ((prev or {}).get(name) or {}).get("values", {})
        for label_key, val in fam.get("values", {}).items():
            key = _series_key(name, label_key)
            if kind == "gauge":
                out[key] = float(val)
            elif kind == "counter":
                d = float(val) - float(pvals.get(label_key, 0.0))
                if d < 0:
                    # Counter reset (a scraped replica restarted):
                    # Prometheus rate semantics — the new value IS the
                    # delta since the reset.
                    d = float(val)
                out[key] = d / dt_s
            elif kind == "histogram":
                prev_hist = pvals.get(label_key)
                if (prev_hist and val.get("count", 0)
                        < prev_hist.get("count", 0)):
                    prev_hist = None  # reset: everything is new
                d = _delta_hist(prev_hist, val)
                if d is None:
                    continue
                pct = histogram_percentiles(d, (0.5, 0.99))
                out[f"{key}|p50"] = pct.get("p50", 0.0)
                out[f"{key}|p99"] = pct.get("p99", 0.0)
                out[f"{key}|mean"] = d["sum"] / d["count"]
                out[f"{key}|rate"] = d["count"] / dt_s
    return out


# --------------------------------------------------------------------------
# Crash-safe rotating writer
# --------------------------------------------------------------------------

class HistoryWriter:
    """Append-only JSONL with header line + per-line flush and bounded
    segment rotation — ``history-{label}.jsonl`` is the live segment,
    ``.jsonl.1`` the most recent rotated one, ``.jsonl.{N}`` the
    oldest. Total on-disk bound: ``(segments + 1) * max_bytes``."""

    def __init__(self, directory: str, label: str, *,
                 max_bytes: Optional[int] = None,
                 segments: Optional[int] = None,
                 meta: Optional[Callable[[], dict]] = None):
        self.directory = directory
        self.label = label
        self.path = os.path.join(directory, f"history-{label}.jsonl")
        self._max_bytes = (max_bytes if max_bytes is not None
                           else _env.history_max_bytes())
        self._segments = (segments if segments is not None
                          else _env.history_segments())
        self._meta = meta
        self._lock = threading.Lock()
        self._f = None
        self._size = 0

    def _header(self) -> dict:
        h = {"history": SCHEMA_VERSION, "label": self.label,
             "time_unix": time.time(),
             "mono_us": int(time.monotonic() * 1e6)}
        if self._meta is not None:
            try:
                h.update(self._meta())
            except Exception:  # pragma: no cover - defensive
                pass
        return h

    def _open(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        self._f = open(self.path, "w")
        line = json.dumps(self._header()) + "\n"
        self._f.write(line)
        self._f.flush()
        self._size = len(line)

    def _rotate(self) -> None:
        """Shift the segment chain up by one and start a fresh live
        file (with a fresh header — the clock offset may have synced
        since the last segment opened)."""
        self._f.close()
        self._f = None
        oldest = f"{self.path}.{self._segments}"
        if os.path.exists(oldest):
            os.unlink(oldest)
        for i in range(self._segments - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        if self._segments > 0:
            os.replace(self.path, f"{self.path}.1")
        self._open()

    def append(self, sample: dict) -> None:
        """One sample line; flushed immediately (crash-safe prefix)."""
        line = json.dumps(sample) + "\n"
        with self._lock:
            if self._f is None:
                self._open()
            elif self._size + len(line) > self._max_bytes:
                self._rotate()
            self._f.write(line)
            self._f.flush()
            self._size += len(line)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


# --------------------------------------------------------------------------
# The sampler
# --------------------------------------------------------------------------

def _default_meta() -> dict:
    """Header fields for a training rank: identity and the clock
    fields, read from the flight recorder when a segment opens."""
    from . import flight_recorder as _flight
    rec = _flight.recorder()
    meta = {"rank": max(rec.rank, 0), "world": rec.world,
            "generation": rec.generation}
    meta.update(rec.clock)
    return meta


class HistorySampler:
    """Periodic snapshot→delta→append pipeline, one ticker task.

    ``source`` returns a registry-shaped snapshot dict (default: the
    local registry, optionally prefix-filtered). ``monitor`` (a
    :class:`~.health.HealthMonitor`) receives every tick's series —
    the live detector plane."""

    def __init__(self, directory: str, label: str, *,
                 interval_s: Optional[float] = None,
                 source: Optional[Callable[[], dict]] = None,
                 monitor=None,
                 prefix: Optional[str] = None,
                 writer: Optional[HistoryWriter] = None,
                 meta: Optional[Callable[[], dict]] = None):
        self.interval_s = (interval_s if interval_s is not None
                           else _env.history_interval_secs())
        self._source = source or (
            lambda: _reg.registry().snapshot(prefix=prefix))
        self.monitor = monitor
        self.writer = writer or HistoryWriter(
            directory, label, meta=meta or _default_meta)
        self._prev: Optional[dict] = None
        self._prev_t = 0.0
        r = _reg.registry()
        self._m_samples = r.counter(
            "hvdtpu_history_samples_total",
            "Telemetry history samples appended, by history label"
        ).labels(label=label)
        self._m_errors = r.counter(
            "hvdtpu_history_sample_errors_total",
            "History sampler ticks that failed (source unreachable / "
            "write error) — the file simply has a gap").labels()
        self._handle: Optional[int] = None

    # ------------------------------------------------------------- tick

    def tick(self) -> Optional[dict]:
        """One sample: snapshot, delta, append, feed the detectors.
        Returns the sample (tests), None when disabled or first tick
        (nothing to delta against)."""
        if not _enabled:
            return None
        now = time.monotonic()
        try:
            snap = self._source()
        except Exception as e:
            self._m_errors.inc()
            _log.warning("history source failed: %s", e)
            return None
        prev, self._prev = self._prev, snap
        prev_t, self._prev_t = self._prev_t, now
        if prev is None:
            return None
        series = series_from_snapshots(prev, snap, now - prev_t)
        sample = {"t_us": int(now * 1e6),
                  "u": round(time.time(), 3),
                  "dt_s": round(now - prev_t, 3),
                  "s": {k: _json_safe(v) for k, v in series.items()}}
        try:
            self.writer.append(sample)
            self._m_samples.inc()
        except OSError as e:
            self._m_errors.inc()
            _log.warning("history append failed: %s", e)
        if self.monitor is not None:
            try:
                self.monitor.observe(series, t=now, t_unix=time.time())
            except Exception as e:  # detectors must never kill sampling
                _log.warning("health detectors failed: %s", e)
        return sample

    # -------------------------------------------------------- lifecycle

    def start(self) -> "HistorySampler":
        from . import ticker as _ticker
        if self._handle is None:
            self._handle = _ticker.ticker().add(
                f"history-{self.writer.label}", self.interval_s,
                self.tick, final=self.final_flush)
        return self

    def stop(self) -> None:
        from . import ticker as _ticker
        if self._handle is not None:
            handle, self._handle = self._handle, None
            _ticker.ticker().remove(handle)  # runs final_flush
        self.writer.close()

    def final_flush(self) -> None:
        """Final-gasp: capture the current window RIGHT NOW — also
        registered with the flight recorder's death paths, so the last
        seconds before a crash reach the history file."""
        try:
            self.tick()
        except Exception:  # pragma: no cover - defensive
            pass


_sampler: Optional[HistorySampler] = None
_lock = threading.Lock()


def sampler() -> Optional[HistorySampler]:
    """The process's env-configured history sampler, if one started."""
    return _sampler


def maybe_start_sampler() -> Optional[HistorySampler]:
    """Start the env-configured history sampler + detector plane
    (called by ``init()``; idempotent, no-op without
    ``HOROVOD_TPU_HISTORY``)."""
    global _sampler
    directory = _env.history_dir()
    if not directory or not _reg.enabled():
        return None
    if _env.replica_id() is not None:
        # Serving-fleet replicas are sampled BY the supervisor (scraped
        # into history-replica{i}.jsonl, serving/fleet.py) so their
        # trends survive replica death; a process-local sampler here
        # would add a second, rank-named file that dies with the
        # replica and collides across replicas.
        return None
    with _lock:
        if _sampler is not None:
            return _sampler
        monitor = None
        if _env.health_detectors_enabled():
            from . import health as _health
            monitor = _health.default_monitor()
        rank = _process_index()
        _sampler = HistorySampler(directory, f"rank{rank}",
                                  monitor=monitor).start()
        from . import flight_recorder as _flight
        _flight.register_final_flush(_sampler.final_flush)
        _log.info("telemetry history to %s every %.1fs (detectors %s)",
                  _sampler.writer.path, _sampler.interval_s,
                  "on" if monitor else "off")
    return _sampler


def stop_sampler() -> None:
    global _sampler
    with _lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None


def _process_index() -> int:
    from .. import topology as _topo
    if _topo.is_initialized():
        return _topo._get().rank
    return int(os.environ.get("HOROVOD_TPU_PROCESS_ID", "0") or 0)


def _json_safe(v: float):
    if isinstance(v, float):
        if math.isnan(v) or math.isinf(v):
            return None
        return round(v, 9)
    return v


# --------------------------------------------------------------------------
# Loading + merging (the tools/health side)
# --------------------------------------------------------------------------

class HistoryFile:
    """One label's merged history: header meta + samples ordered by
    aligned (rank-0-clock) time."""

    def __init__(self, label: str, meta: dict, samples: List[dict]):
        self.label = label
        self.meta = meta
        self.samples = samples

    @property
    def rank(self) -> Optional[int]:
        return self.meta.get("rank")

    def series(self) -> Dict[str, List[Tuple[float, float]]]:
        """``{series_key: [(t_seconds_aligned, value), ...]}`` with
        None values dropped."""
        out: Dict[str, List[Tuple[float, float]]] = {}
        for s in self.samples:
            t = s.get("t_aligned_us", s.get("t_us", 0)) / 1e6
            for k, v in (s.get("s") or {}).items():
                if v is None:
                    continue
                out.setdefault(k, []).append((t, float(v)))
        return out


def read_segment(path: str) -> Tuple[dict, List[dict]]:
    """One segment: (header, samples). Tolerates a torn tail — a
    SIGKILL mid-append leaves a valid prefix plus at most one partial
    line, which is skipped (and any undecodable line after it)."""
    header: dict = {}
    samples: List[dict] = []
    try:
        with open(path) as f:
            for i, line in enumerate(f):
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue  # torn tail (or mid-file corruption): skip
                if i == 0 and "history" in obj:
                    header = obj
                else:
                    samples.append(obj)
    except OSError:
        pass
    return header, samples


def _segment_paths(live_path: str) -> List[str]:
    """Oldest → newest: ``.{N}`` .. ``.1`` then the live file."""
    out = []
    i = 1
    while os.path.exists(f"{live_path}.{i}"):
        out.append(f"{live_path}.{i}")
        i += 1
    out.reverse()
    if os.path.exists(live_path):
        out.append(live_path)
    return out


def load_label(live_path: str) -> Optional[HistoryFile]:
    """All segments of one label, concatenated oldest-first, sample
    times aligned onto rank 0's clock via each segment's own header
    offset (segments may have re-synced between rotations)."""
    label = os.path.basename(live_path)
    if label.startswith("history-"):
        label = label[len("history-"):]
    if label.endswith(".jsonl"):
        label = label[: -len(".jsonl")]
    meta: dict = {}
    samples: List[dict] = []
    for seg in _segment_paths(live_path):
        header, segment_samples = read_segment(seg)
        offset = float(header.get("offset_to_rank0_us", 0.0))
        for s in segment_samples:
            if "t_us" in s:
                s["t_aligned_us"] = s["t_us"] + offset
        if header:
            meta = header  # newest header wins (freshest clock sync)
        samples.extend(segment_samples)
    if not meta and not samples:
        return None
    samples.sort(key=lambda s: s.get("t_aligned_us", s.get("t_us", 0)))
    return HistoryFile(label, meta, samples)


def load_history(inputs: List[str]) -> List[HistoryFile]:
    """Load every history label under the given files/directories —
    a directory expands to its ``history-*.jsonl`` live files (rotated
    segments are folded into their label automatically)."""
    live_paths: List[str] = []
    for p in inputs:
        if os.path.isdir(p):
            import glob as _glob
            live_paths.extend(sorted(
                f for f in _glob.glob(os.path.join(p, "history-*.jsonl"))))
        else:
            live_paths.append(p)
    out = []
    for lp in live_paths:
        hf = load_label(lp)
        if hf is not None:
            out.append(hf)
    if not out:
        raise FileNotFoundError(
            f"no history files found under {inputs} (expected "
            "history-<label>.jsonl, see docs/health.md)")
    return out
