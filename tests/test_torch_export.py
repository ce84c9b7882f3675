"""The port's metrics exporters (``observability/export.py``) against
JAX's: the same registry contents, exemplars included, render the same
Prometheus text, the same ``json_safe_snapshot(prefix=)`` and the same
percentiles; the ``/metrics`` and ``/metrics.json?prefix=`` endpoint
serves them; the env knobs parse alike; the file writer and the final
flush write strict JSON. Host Python only: no model, no device."""

import copy
import http.client
import json
import math

import numpy as np
import pytest

from horovod_tpu.observability import export as jexport
from horovod_tpu.observability import registry as jreg
from horovod_tpu.utils import env as jenv
from horovod_tpu_torch.observability import export as texport
from horovod_tpu_torch.observability import registry as treg
from horovod_tpu_torch.utils import env as tenv

PREFIX = "hvdtpu_exporttest_"
TIMEOUT_S = 30


def _populate(reg_mod, registry, seed, prefix=PREFIX):
    """The same families, labels, observations and exemplars in either
    package's registry, drawn from one numpy seed."""
    rs = np.random.RandomState(seed)
    c = registry.counter(prefix + "requests_total",
                         "Requests by outcome\nsecond line \\ escaped")
    for outcome in ("completed", "failed", "expired"):
        c.labels(outcome=outcome).inc(float(rs.randint(0, 50)))
    g = registry.gauge(prefix + "queue_depth", "Queue depth")
    g.labels().set(float(rs.randint(0, 9)))
    g.labels(replica="1").set(float(rs.uniform(0, 3)))
    h = registry.histogram(prefix + "latency_seconds", "Latency",
                           buckets=reg_mod.LATENCY_BUCKETS)
    for k in range(40):
        h.labels(route="generate").observe(
            float(rs.lognormal(-4, 1.5)),
            exemplar=f"trace-{seed}-{k}" if k % 7 == 0 else None)
    h.labels(route="healthz").observe(float(rs.uniform(0, 1e-3)))
    registry.histogram(prefix + "empty_seconds", "never observed")
    registry.counter(prefix + "nohelp_total").labels().inc(3)
    return registry


def _no_times(snap):
    """A snapshot with each exemplar's wall-clock time removed: the only
    field two registries filled at different instants can differ in."""
    snap = copy.deepcopy(snap)
    for fam in snap.values():
        if fam["type"] != "histogram":
            continue
        for val in fam["values"].values():
            if val.get("exemplar"):
                val["exemplar"].pop("time_unix", None)
    return snap


@pytest.fixture(scope="module")
def snapshots():
    jsnap = _populate(jreg, jreg.MetricsRegistry(), 3).snapshot()
    tsnap = _populate(treg, treg.MetricsRegistry(), 3).snapshot()
    return jsnap, tsnap


def test_same_registry_contents_give_the_same_snapshot(snapshots):
    jsnap, tsnap = snapshots
    assert _no_times(tsnap) == _no_times(jsnap)
    ex = tsnap[PREFIX + "latency_seconds"]["values"]['route="generate"']
    assert ex["exemplar"]["trace_id"].startswith("trace-3-")


@pytest.mark.parametrize("exemplars", [False, True])
@pytest.mark.parametrize("percentiles", [False, True])
def test_prometheus_text_matches_jax(snapshots, exemplars, percentiles):
    _, tsnap = snapshots
    got = texport.prometheus_text(copy.deepcopy(tsnap), exemplars=exemplars,
                                  percentiles=percentiles)
    want = jexport.prometheus_text(copy.deepcopy(tsnap), exemplars=exemplars,
                                   percentiles=percentiles)
    assert got == want
    assert ("# {trace_id=" in got) == exemplars
    assert (f"{PREFIX}latency_seconds_p99" in got) == percentiles
    assert f'# HELP {PREFIX}requests_total Requests by outcome\\n' in got


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("qs", [(0.5, 0.9, 0.99), (0.25, 0.999), (1.0,)])
def test_histogram_percentiles_match_jax(seed, qs):
    snap = _populate(treg, treg.MetricsRegistry(), seed).snapshot()
    for val in snap[PREFIX + "latency_seconds"]["values"].values():
        got = texport.histogram_percentiles(val, qs)
        assert got and got == jexport.histogram_percentiles(val, qs)
        # the strict-JSON form ("+Inf" bounds) reads the same
        strict = dict(val, buckets=[["+Inf" if math.isinf(le) else le, c]
                                    for le, c in val["buckets"]])
        assert texport.histogram_percentiles(strict, qs) == got
    assert texport.histogram_percentiles({"count": 0, "buckets": []}) == {}


def test_json_safe_snapshot_prefix_matches_jax():
    _populate(jreg, jreg.registry(), 5, prefix=PREFIX + "a_")
    _populate(treg, treg.registry(), 5, prefix=PREFIX + "a_")
    _populate(jreg, jreg.registry(), 6, prefix=PREFIX + "b_")
    _populate(treg, treg.registry(), 6, prefix=PREFIX + "b_")
    for prefix in (PREFIX + "a_", (PREFIX + "a_", PREFIX + "b_")):
        got = texport.json_safe_snapshot(prefix)
        want = jexport.json_safe_snapshot(prefix)
        assert _no_times(got) == _no_times(want)
        json.dumps(got, allow_nan=False)     # strict JSON
        assert all(k.startswith(prefix) for k in got)
    got = texport.with_percentiles(texport.json_safe_snapshot(PREFIX + "a_"))
    want = jexport.with_percentiles(jexport.json_safe_snapshot(PREFIX + "a_"))
    assert _no_times(got) == _no_times(want)
    lat = got[PREFIX + "a_latency_seconds"]["values"]['route="generate"']
    assert lat["buckets"][-1][0] == "+Inf" and set(lat["percentiles"]) == {
        "p50", "p90", "p99"}


def _get(port, path, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_metrics_server_serves_text_and_prefixed_json():
    _populate(treg, treg.registry(), 7, prefix=PREFIX + "srv_")
    _populate(treg, treg.registry(), 8, prefix=PREFIX + "srv2_")
    srv = texport.MetricsServer(0)
    try:
        status, ctype, body = _get(
            srv.port, f"/metrics.json?prefix={PREFIX}srv_,{PREFIX}srv2_")
        assert status == 200 and ctype == "application/json"
        got = json.loads(body)
        want = json.loads(json.dumps(jexport.with_percentiles(
            texport.json_safe_snapshot((PREFIX + "srv_", PREFIX + "srv2_")))))
        assert _no_times(got) == _no_times(want)
        assert {k[:len(PREFIX) + 4] for k in got} == {PREFIX + "srv_",
                                                      PREFIX + "srv2"}
        status, ctype, body = _get(srv.port, f"/metrics?prefix={PREFIX}srv_")
        assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert body.decode() == texport.prometheus_text(
            treg.snapshot(prefix=PREFIX + "srv_"))
        assert b"trace_id" not in body
        status, ctype, body = _get(
            srv.port, f"/metrics?prefix={PREFIX}srv_",
            {"Accept": "application/openmetrics-text"})
        assert ctype.startswith("application/openmetrics-text")
        assert body.endswith(b"# EOF\n") and b'# {trace_id="trace-7-' in body
        assert _get(srv.port, "/nothing")[0] == 404
    finally:
        srv.stop()


@pytest.mark.parametrize("value,rank", [
    (None, 0), ("", 0), ("9091", 0), ("9091", 2), ("909{rank}", 3),
    ("9091+rank", 0), ("9091+rank", 5), (" 0 ", 0)])
def test_metrics_port_forms_parse_as_jax(monkeypatch, value, rank):
    if value is None:
        monkeypatch.delenv("HOROVOD_TPU_METRICS_PORT", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_TPU_METRICS_PORT", value)
    assert tenv.metrics_port(rank) == jenv.metrics_port(rank)
    assert tenv.metrics_port_per_rank() == jenv.metrics_port_per_rank()


KNOBS = [
    ("BLACKBOX", "/tmp/bb"), ("BLACKBOX_WINDOW", "7.5"),
    ("BLACKBOX_INTERVAL", "0"), ("BLACKBOX_EVENTS", "99"),
    ("HISTORY", "/tmp/h"), ("HISTORY_INTERVAL", "0.5"),
    ("HISTORY_MAX_BYTES", "1000"), ("HISTORY_SEGMENTS", "2"),
    ("HEALTH", "0"), ("ALERT_URL", "http://localhost:1/x"),
    ("METRICS_FILE", "/tmp/m-{rank}.json"), ("METRICS_INTERVAL", "2"),
    ("FLEET_PROBE_INTERVAL", "0.1"), ("FLEET_PROBE_FAILURES", "7"),
    ("QOS_SCALE_HIGH", "2.5"), ("QOS_SCALE_LOW", "0.1"),
    ("QOS_SCALE_SUSTAIN_S", "1"), ("QOS_SCALE_COOLDOWN_S", "4"),
    ("QOS_SCALE_INTERVAL_S", "0.5")]
FUNCS = {
    "BLACKBOX": "blackbox_dir", "BLACKBOX_WINDOW": "blackbox_window_secs",
    "BLACKBOX_INTERVAL": "blackbox_interval_secs",
    "BLACKBOX_EVENTS": "blackbox_capacity", "HISTORY": "history_dir",
    "HISTORY_INTERVAL": "history_interval_secs",
    "HISTORY_MAX_BYTES": "history_max_bytes",
    "HISTORY_SEGMENTS": "history_segments",
    "HEALTH": "health_detectors_enabled", "ALERT_URL": "alert_url",
    "METRICS_FILE": "metrics_file",
    "METRICS_INTERVAL": "metrics_interval_secs",
    "FLEET_PROBE_INTERVAL": "fleet_probe_interval_secs",
    "FLEET_PROBE_FAILURES": "fleet_probe_failures",
    "QOS_SCALE_HIGH": "qos_scale_high", "QOS_SCALE_LOW": "qos_scale_low",
    "QOS_SCALE_SUSTAIN_S": "qos_scale_sustain_s",
    "QOS_SCALE_COOLDOWN_S": "qos_scale_cooldown_s",
    "QOS_SCALE_INTERVAL_S": "qos_scale_interval_s"}


@pytest.mark.parametrize("name,value", KNOBS, ids=[k for k, _ in KNOBS])
def test_env_knobs_match_jax(monkeypatch, name, value):
    fn = FUNCS[name]
    monkeypatch.delenv("HOROVOD_TPU_" + name, raising=False)
    monkeypatch.delenv("HOROVOD_" + name, raising=False)
    assert getattr(tenv, fn)() == getattr(jenv, fn)()     # the default
    monkeypatch.setenv("HOROVOD_TPU_" + name, value)
    assert getattr(tenv, fn)() == getattr(jenv, fn)()


def test_json_file_writer_and_final_flush(tmp_path, monkeypatch):
    _populate(treg, treg.registry(), 9, prefix=PREFIX + "file_")
    path = tmp_path / "m.json"
    texport.write_json_snapshot(str(path))
    snap = json.loads(path.read_text())
    assert snap[PREFIX + "file_requests_total"]["type"] == "counter"
    assert not list(tmp_path.glob("*.tmp.*"))
    path.unlink()
    monkeypatch.setenv("HOROVOD_TPU_METRICS_FILE", str(tmp_path / "f.json"))
    texport.final_metrics_flush()
    bounds = json.loads((tmp_path / "f.json").read_text())[
        PREFIX + "file_latency_seconds"]["values"]['route="generate"'][
        "buckets"]
    assert bounds[-1][0] == "+Inf" and not math.isinf(bounds[0][0])


def test_maybe_start_exporters_binds_and_stops(tmp_path, monkeypatch):
    texport.stop_exporters()
    monkeypatch.setenv("HOROVOD_TPU_METRICS_PORT", "0")
    monkeypatch.setenv("HOROVOD_TPU_METRICS_FILE", str(tmp_path / "w.json"))
    monkeypatch.setenv("HOROVOD_TPU_METRICS_INTERVAL", "3600")
    try:
        texport.maybe_start_exporters()
        texport.maybe_start_exporters()            # idempotent
        port = texport.server_port()
        assert port and _get(port, "/metrics.json")[0] == 200
    finally:
        texport.stop_exporters()                   # flushes the file
    assert texport.server_port() is None
    assert json.loads((tmp_path / "w.json").read_text())
