"""The port's health detectors and telemetry history
(``observability/health.py``, ``history.py``, ``ticker.py``) against
JAX's: the detectors fire the same alerts at the same samples of the
same series, the monitor routes the stock specs alike, snapshot deltas
reduce to the same rates and windowed means, the writer rotates and
survives a torn tail as JAX's does, and JAX's ``load_history`` reads a
port writer's and sampler's files. Host Python only."""

import json
import math
import threading
import time

import numpy as np
import pytest

from horovod_tpu.observability import health as jhealth
from horovod_tpu.observability import history as jhist
from horovod_tpu.observability import ticker as jticker
from horovod_tpu_torch.observability import health as thealth
from horovod_tpu_torch.observability import history as thist
from horovod_tpu_torch.observability import registry as treg
from horovod_tpu_torch.observability import ticker as tticker


def _series(kind, seed, n=80):
    """A seeded series of one shape: level shifts up or down, a lone
    spike, stationary noise, a leak, noisy-flat, a decline, rate spikes
    or a slow drip."""
    rs = np.random.RandomState(seed)
    t = np.arange(n, dtype=float)
    if kind == "shift_up":
        v = np.where(t < 40, 0.010, 0.013) + rs.normal(0, 2e-4, n)
    elif kind == "shift_down":
        v = np.where(t < 30, 0.45, 0.30) + rs.normal(0, 1e-3, n)
    elif kind == "spike":
        v = np.where(t == 30, 0.05, 0.01) + rs.normal(0, 2e-4, n)
    elif kind == "noise":
        v = 0.01 + rs.normal(0, 5e-4, n)
    elif kind == "leak":
        v = 1e6 + 5e4 * t + rs.normal(0, 1e3, n)
    elif kind == "flat":
        v = 1e6 + rs.normal(0, 2e5, n)
    elif kind == "decline":
        v = 1e6 - 1e4 * t
    elif kind == "restarts":
        v = np.where(rs.uniform(size=n) < 0.15, 0.1, 0.0)
    else:                                            # "drip"
        v = np.full(n, 0.005)
        t = t * 200.0
    return [(float(a), float(b)) for a, b in zip(t, v)]


DETECTORS = {
    "ewma_up": lambda m: m.EwmaDetector("up"),
    "ewma_down": lambda m: m.EwmaDetector("down", min_rel=0.1),
    "ewma_guarded": lambda m: m.EwmaDetector(
        "up", min_rel=0.15, min_abs=0.05, min_baseline=0.02),
    "trend": lambda m: m.TrendDetector(),
    "trend_queue": lambda m: m.TrendDetector(min_rel=0.5, min_abs=4.0),
    "rate": lambda m: m.RateDetector(threshold=3.0, window_s=100.0),
}
KINDS = ["shift_up", "shift_down", "spike", "noise", "leak", "flat",
         "decline", "restarts", "drip"]


def _fired(mod, det_name, series):
    det = DETECTORS[det_name](mod)
    return [(i, ev) for i, (t, v) in enumerate(series)
            if (ev := det.update(t, v))]


@pytest.mark.parametrize("det_name", sorted(DETECTORS))
@pytest.mark.parametrize("kind", KINDS)
def test_detectors_fire_as_jax(det_name, kind):
    for seed in (1, 2):
        series = _series(kind, seed)
        got = _fired(thealth, det_name, series)
        assert got == _fired(jhealth, det_name, series)


def test_the_detectors_see_what_they_are_for():
    assert _fired(thealth, "ewma_up", _series("shift_up", 7))[0][0] in range(
        40, 44)
    assert not _fired(thealth, "ewma_up", _series("noise", 13))
    assert _fired(thealth, "ewma_down", _series("shift_down", 1))[0][0] == 30
    assert _fired(thealth, "trend", _series("leak", 11))[0][0] < 15
    assert not _fired(thealth, "trend", _series("flat", 17))
    assert not _fired(thealth, "rate", _series("drip", 0))


def _monitor_run(mod, seed):
    rs = np.random.RandomState(seed)
    mon = mod.HealthMonitor(emit=False, replica=2, refire_s=10.0)
    for t in range(60):
        series = {
            'hvdtpu_step_seconds{framework="t"}|mean':
                (0.010 if t < 30 else 0.014) + rs.normal(0, 1e-4),
            "hvdtpu_hbm_bytes_in_use": 1e9 + 2e7 * t + rs.normal(0, 1e5),
            "hvdtpu_serving_queue_depth": float(rs.randint(0, 3)),
            'hvdtpu_fleet_replica_restarts_total{replica="1",why="crash"}':
                1.0 if t in (40, 41, 42) else 0.0,
            'hvdtpu_numerics_fingerprints_total{event="computed"}': 1.0,
            "hvdtpu_unwatched": float(t),
            "hvdtpu_mfu": None,
        }
        mon.observe(series, t=float(t), t_unix=1000.0 + t)
    return [a.to_dict() for a in mon.alerts]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_monitor_alerts_match_jax(seed):
    got = _monitor_run(thealth, seed)
    assert got == _monitor_run(jhealth, seed)
    kinds = {a["kind"] for a in got}
    assert {"step_time_regression", "hbm_leak", "restart_spike"} <= kinds
    assert all(a["replica"] == 2 for a in got)


def test_default_specs_and_kinds_match_jax():
    assert thealth.ALERT_KINDS == jhealth.ALERT_KINDS
    assert thealth.POLICY_ALERT_KINDS == jhealth.POLICY_ALERT_KINDS
    got = [(s.kind, s.severity, s.families, s.suffix, s.labels)
           for s in thealth.default_specs()]
    assert got == [(s.kind, s.severity, s.families, s.suffix, s.labels)
                   for s in jhealth.default_specs()]


def test_emitted_alert_fans_out(monkeypatch):
    from horovod_tpu_torch.observability import flight_recorder as tfr
    seen = []
    thealth.drain_policy_alerts()
    mon = thealth.HealthMonitor(rank=1, alert_sink=seen.append,
                                refire_s=1e9)
    for t in range(30):
        mon.observe({'hvdtpu_step_seconds{framework="t"}|mean':
                     0.010 if t < 20 else 0.013}, t=float(t))
    assert [a.kind for a in seen] == ["step_time_regression"]
    assert tfr.recorder()._ring[-1][1] == "alert"
    snap = treg.snapshot()["hvdtpu_health_alerts_total"]["values"]
    assert snap['kind="step_time_regression",severity="warning"'] >= 1
    assert [a["kind"] for a in thealth.drain_policy_alerts()] == [
        "step_time_regression"]
    assert thealth.drain_policy_alerts() == []
    direct = mon.fire("rank_divergence", "critical", "fp", 1.0, t=0.0)
    assert direct.kind == "rank_divergence"
    assert mon.fire("rank_divergence", "critical", "fp", 1.0, t=1.0) is None


def _snapshots(seed):
    """Two consecutive registry snapshots of the port's registry: a
    counter that grows and one that resets, a gauge, a histogram with
    observations in the window and one without."""
    rs = np.random.RandomState(seed)
    reg = treg.MetricsRegistry()
    c = reg.counter("hvdtpu_x_total")
    r = reg.counter("hvdtpu_reset_total")
    g = reg.gauge("hvdtpu_q")
    h = reg.histogram("hvdtpu_s_seconds", buckets=treg.LATENCY_BUCKETS)
    h2 = reg.histogram("hvdtpu_idle_seconds", buckets=treg.LATENCY_BUCKETS)
    c.labels(k="a").inc(5)
    r.labels().inc(100)
    h2.labels().observe(0.5)
    for v in rs.lognormal(-4, 1, 20):
        h.labels(route="g").observe(float(v))
    prev = reg.snapshot()
    c.labels(k="a").inc(float(rs.randint(1, 40)))
    c.labels(k="b").inc(3)
    g.labels().set(float(rs.uniform(0, 8)))
    for v in rs.lognormal(-3, 1, 30):
        h.labels(route="g").observe(float(v))
    cur = reg.snapshot()
    cur["hvdtpu_reset_total"]["values"][""] = 7.0    # a restarted replica
    return prev, cur


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("strict", [False, True])
def test_series_from_snapshots_match_jax(seed, strict):
    prev, cur = _snapshots(seed)
    if strict:       # the scraped /metrics.json form: "+Inf" bounds
        for snap in (prev, cur):
            for fam in snap.values():
                for val in fam["values"].values():
                    if isinstance(val, dict):
                        val["buckets"] = [
                            ["+Inf" if math.isinf(le) else le, n]
                            for le, n in val["buckets"]]
    got = thist.series_from_snapshots(prev, cur, 2.5)
    assert got == jhist.series_from_snapshots(prev, cur, 2.5)
    assert got["hvdtpu_reset_total"] == 7.0 / 2.5
    assert got['hvdtpu_x_total{k="b"}'] == 3 / 2.5
    win = cur["hvdtpu_s_seconds"]["values"]['route="g"']
    old = prev["hvdtpu_s_seconds"]["values"]['route="g"']
    assert got['hvdtpu_s_seconds{route="g"}|mean'] == pytest.approx(
        (win["sum"] - old["sum"]) / 30)
    assert not any(k.startswith("hvdtpu_idle_seconds") for k in got)


def _write(directory, label, n, max_bytes, segments, meta):
    w = thist.HistoryWriter(str(directory), label, max_bytes=max_bytes,
                            segments=segments, meta=meta)
    for i in range(n):
        w.append({"t_us": i, "u": 1000.0 + i, "dt_s": 1.0,
                  "s": {"a": float(i), "b{x=\"1\"}|p99": i / 7}})
    w.close()


@pytest.mark.parametrize("max_bytes,segments", [(400, 2), (1000, 3),
                                                (10 ** 6, 4)])
def test_rotation_reads_back_in_jax(tmp_path, max_bytes, segments):
    _write(tmp_path, "rank0", 60, max_bytes, segments,
           lambda: {"rank": 0, "offset_to_rank0_us": 250.0})
    segs = sorted(tmp_path.glob("history-rank0.jsonl.*"))
    assert len(segs) == (segments if max_bytes < 10 ** 4 else 0)
    for p in [tmp_path / "history-rank0.jsonl"] + segs:
        assert p.stat().st_size <= max_bytes + 200
        assert json.loads(p.open().readline())["history"] == 1
    got = thist.load_history([str(tmp_path)])
    want = jhist.load_history([str(tmp_path)])
    assert [(f.label, f.meta, f.samples) for f in got] == \
        [(f.label, f.meta, f.samples) for f in want]
    ts = [s["t_us"] for s in want[0].samples]
    assert ts == sorted(ts) and ts[-1] == 59
    assert want[0].samples[0]["t_aligned_us"] == ts[0] + 250.0
    assert want[0].series() == got[0].series()


def test_torn_tail_tolerated_by_both(tmp_path):
    _write(tmp_path, "replica0", 5, 10 ** 6, 4, lambda: {"replica": 0})
    path = tmp_path / "history-replica0.jsonl"
    with open(path, "a") as f:
        f.write('{"t_us": 5, "s": {"a": 5')
    for mod in (thist, jhist):
        hf = mod.load_label(str(path))
        assert [s["t_us"] for s in hf.samples] == [0, 1, 2, 3, 4]
    with pytest.raises(FileNotFoundError):
        thist.load_history([str(tmp_path / "none")])


def test_sampler_file_read_by_jax(tmp_path):
    reg = treg.registry()
    c = reg.counter("hvdtpu_histtest_total").labels()
    h = reg.histogram("hvdtpu_histtest_seconds").labels()
    seen = []

    class Monitor:
        def observe(self, series, t, t_unix):
            seen.append(series)

    s = thist.HistorySampler(str(tmp_path), "rank0", interval_s=3600,
                             prefix="hvdtpu_histtest_", monitor=Monitor())
    assert s.tick() is None                 # nothing to delta against
    c.inc(10)
    h.observe(0.25)
    h.observe(0.5)
    sample = s.tick()
    s.writer.close()
    assert sample["s"]["hvdtpu_histtest_seconds|mean"] == 0.375
    assert seen and seen[0]["hvdtpu_histtest_total"] > 0
    hf = jhist.load_history([str(tmp_path)])[0]
    assert hf.label == "rank0" and hf.meta["history"] == 1
    assert hf.samples[0]["s"] == sample["s"]
    thist.set_enabled(False)
    try:
        assert s.tick() is None
    finally:
        thist.set_enabled(True)


def test_json_writer_and_samplers_share_one_thread(tmp_path, monkeypatch):
    from horovod_tpu_torch.observability import export as texport
    texport.stop_exporters()
    monkeypatch.setenv("HOROVOD_TPU_METRICS_FILE", str(tmp_path / "m.json"))
    monkeypatch.setenv("HOROVOD_TPU_METRICS_INTERVAL", "0.05")
    a = b = None
    try:
        texport.maybe_start_exporters()
        a = thist.HistorySampler(str(tmp_path), "a", interval_s=0.05).start()
        b = thist.HistorySampler(str(tmp_path), "b", interval_s=0.05).start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                (tmp_path / "m.json").exists()
                and (tmp_path / "history-b.jsonl").exists()):
            time.sleep(0.02)
        names = [t.name for t in threading.enumerate()]
        assert names.count(tticker.THREAD_NAME) == 1
        # JAX's ticker may run in the same process: its thread counts
        # apart (its own one-thread test counts by its name)
        assert tticker.THREAD_NAME != jticker.THREAD_NAME
        assert (tmp_path / "history-a.jsonl").exists()
    finally:
        for s in (a, b):
            if s is not None:
                s.stop()
        texport.stop_exporters()


def test_ticker_survives_a_raising_task():
    tk = tticker.Ticker()
    hits = []

    def bad():
        raise RuntimeError("x")

    try:
        tk.add("bad", 0.05, bad)
        h = tk.add("good", 0.05, lambda: hits.append(1),
                   final=lambda: hits.append("final"))
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and len(hits) < 3:
            time.sleep(0.01)
        assert len(hits) >= 3
        tk.remove(h)
        assert hits[-1] == "final" and "good" not in tk.tasks().values()
    finally:
        tk.stop()


def test_replica_process_starts_no_sampler(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_HISTORY", str(tmp_path))
    monkeypatch.setenv("HOROVOD_TPU_REPLICA_ID", "1")
    assert thist.maybe_start_sampler() is None
