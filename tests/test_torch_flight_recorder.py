"""The port's flight recorder (``observability/flight_recorder.py``)
against JAX's: the ring and its enable switch, the window, the dump's
header and event schema (the same events dump to the same JSONL but for
times), the hooks the rest of the port calls, ``init``'s event, and the
final gasps: an injected ``replica_crash_at`` fault's dump read by
JAX's ``python -m horovod_tpu.tools.postmortem``, which names the rank
and ``fault_crash``, an uncaught exception and SIGTERM."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from horovod_tpu.observability import flight_recorder as jfr
from horovod_tpu.tools import postmortem
import horovod_tpu_torch as thvd
from horovod_tpu_torch import observability as tobs
from horovod_tpu_torch.observability import flight_recorder as tfr

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120


def _load(path):
    header, events = None, []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        obj = json.loads(line)
        if header is None and obj.get("blackbox"):
            header = obj
        else:
            events.append(obj)
    return header, events


def _record(mod, rec):
    rec.configure(rank=3, world=4, generation=1)
    rec.set_clock_meta(0.25, 0.001, True)
    rec.note("init", (3, 4, 1))
    rec.note("serving", ("drain", 2))
    rec.note("request", ("admit", "trace-1", "slot=0 blocks=2 cached=0"))
    rec.note("serving_replica", ("spawn", 1, "gen=0"))
    rec.note("fault", ("replica_crash", 5))
    rec.note("alert", ("restart_spike", "critical", "s", 1, 3.0, 0.0))
    rec.note("qos", ("shed", "trace-2", "class=bulk"))   # no schema
    rec.note("failure", (2, "heartbeat_timeout", "gone"))


def test_fields_are_jax_fields():
    assert tfr._FIELDS == jfr._FIELDS


def test_ring_is_bounded():
    rec = tfr.FlightRecorder(capacity=8)
    for i in range(100):
        rec.note("step", (i,))
    assert len(rec._ring) == 8 and rec._ring[-1][2] == (99,)


def test_set_enabled_gates_recording():
    rec = tfr.FlightRecorder(capacity=8)
    tfr.set_enabled(False)
    try:
        rec.note("step", (1,))
        rec.group_deliver(0, "allreduce", 1)
        rec.group_done(0, "allreduce", 1, 0.0, 0.0, 0.0)
        rec.group_error(0, "allreduce", 1, "x")
    finally:
        tfr.set_enabled(True)
    assert len(rec._ring) == 0


def test_dump_without_directory_is_none(monkeypatch):
    monkeypatch.delenv("HOROVOD_TPU_BLACKBOX", raising=False)
    rec = tfr.FlightRecorder(capacity=8)
    rec.note("step", (1,))
    assert rec.dump("test") is None


def test_dump_schema_matches_jax(tmp_path):
    got_path = tfr.FlightRecorder(capacity=32)
    want_path = jfr.FlightRecorder(capacity=32)
    _record(tfr, got_path)
    _record(jfr, want_path)
    gh, ge = _load(got_path.dump("unit", directory=str(tmp_path / "t")))
    wh, we = _load(want_path.dump("unit", directory=str(tmp_path / "j")))
    for h in (gh, wh):
        for k in ("time_unix", "mono_us"):
            h.pop(k)
    assert gh == wh
    assert gh["rank"] == 3 and gh["offset_to_rank0_us"] == 250000.0
    assert [{k: v for k, v in e.items() if k != "t_us"} for e in ge] == \
        [{k: v for k, v in e.items() if k != "t_us"} for e in we]
    assert ge[-1]["failure_kind"] == "heartbeat_timeout"
    assert ge[-2]["payload"] == ["shed", "trace-2", "class=bulk"]
    assert Path(tmp_path / "t" / "blackbox-rank3.jsonl").exists()


def test_window_drops_old_events(tmp_path):
    rec = tfr.FlightRecorder(capacity=128)
    rec.configure(0, 1)
    rec._ring.append((time.monotonic() - 3600.0, "step", (0,)))
    rec.note("step", (1,))
    _, events = _load(rec.dump("w", directory=str(tmp_path), window_s=60.0))
    assert [e["idx"] for e in events] == [1]


def test_dump_counts_in_the_registry(tmp_path):
    rec = tfr.FlightRecorder(capacity=8)
    rec.configure(0, 1)
    rec.dump("metric_test", directory=str(tmp_path))
    vals = thvd.metrics_snapshot()["hvdtpu_blackbox_dumps_total"]["values"]
    assert vals['reason="metric_test"'] >= 1


def test_hooks_reach_the_recorder(tmp_path, monkeypatch):
    tfr.reset()
    flushed = []
    try:
        tobs.flight_note("serving", ("drain", 1))
        assert tfr.recorder()._ring[-1][1:] == ("serving", ("drain", 1))

        def flush():
            flushed.append(True)

        tobs.register_final_flush(flush)
        tobs.register_final_flush(flush)            # once per callable
        monkeypatch.setenv("HOROVOD_TPU_BLACKBOX", str(tmp_path))
        tobs.flight_dump("fault_crash")
        header, events = _load(tmp_path / "blackbox-rank0.jsonl")
        assert header["reason"] == "fault_crash"
        assert events[-1]["kind"] == "serving" and flushed == [True]
    finally:
        tfr._final_flush_hooks.clear()
        tfr.reset()


def test_init_configures_and_notes(monkeypatch):
    thvd.shutdown()
    tfr.reset()
    monkeypatch.setenv("HOROVOD_TPU_ELASTIC_GENERATION", "2")
    try:
        thvd.init(device="cpu")
        rec = tfr.recorder()
        assert (rec.rank, rec.world, rec.generation) == (0, 1, 2)
        assert rec._ring[-1][1:] == ("init", (0, 1, 2))
    finally:
        thvd.shutdown()
        tfr.reset()


_CRASH = """
import os
from horovod_tpu_torch.adaptation import faults
from horovod_tpu_torch.observability import flight_note, flight_recorder
gen = int(os.environ["HOROVOD_TPU_ELASTIC_GENERATION"])
flight_recorder.recorder().configure(rank=1, world=0, generation=gen)
flight_recorder.maybe_install_hooks()
flight_note("request", ("admit", "req-a", "slot=0 blocks=2 cached=0"))
flight_note("request", ("first_token", "req-a", "ttft_ms=3.0"))
flight_note("request", ("admit", "req-b", "slot=1 blocks=1 cached=0"))
inj = faults.injector()   # None when no clause matches this incarnation
for _ in range(10 if inj is not None else 0):
    inj.on_serving_decode()
print("SURVIVED")
"""


def test_replica_crash_dump_names_the_rank(tmp_path):
    env = dict(os.environ, HOROVOD_TPU_BLACKBOX=str(tmp_path),
               HOROVOD_TPU_REPLICA_ID="1", HOROVOD_TPU_ELASTIC_GENERATION="0",
               HOROVOD_TPU_FAULT_SPEC="rank=1:replica_crash_at=4:gen=0")
    proc = subprocess.run([sys.executable, "-c", _CRASH], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert "SURVIVED" not in proc.stdout
    header, events = _load(tmp_path / "blackbox-rank1.jsonl")
    assert header["reason"] == "fault_crash" and header["rank"] == 1
    assert events[-1] == dict(events[-1], kind="fault",
                              fault="replica_crash", tick=4)
    out = tmp_path / "pm.json"
    pm = subprocess.run(
        [sys.executable, "-m", "horovod_tpu.tools.postmortem", str(tmp_path),
         "--json", str(out)], env=dict(os.environ, JAX_PLATFORMS="cpu"),
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert pm.returncode == 0, pm.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["died_first"]["rank"] == 1
    assert report["per_rank"]["1"]["reason"] == "fault_crash"
    assert "serving replica crash" in report["died_first"]["phase"]
    infl = {r["trace"] for r in report["per_rank"]["1"]["inflight_requests"]}
    assert infl == {"req-a", "req-b"}
    assert "rank 1" in pm.stdout
    # a later incarnation does not match the gen=0 clause
    env["HOROVOD_TPU_ELASTIC_GENERATION"] = "1"
    proc = subprocess.run([sys.executable, "-c", _CRASH], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0 and "SURVIVED" in proc.stdout


_GASP = """
import sys, time
from horovod_tpu_torch.observability import flight_note, flight_recorder
from horovod_tpu_torch.observability import registry
flight_recorder.recorder().configure(rank=0, world=1)
flight_recorder.maybe_install_hooks()
registry.registry().counter("hvdtpu_gasp_total").labels().inc(5)
flight_note("serving", ("drain", 3))
if sys.argv[1] == "raise":
    raise RuntimeError("boom in the replica")
print("PARKED", flush=True)
time.sleep(120)
"""


@pytest.mark.parametrize("how", ["raise", "sigterm"])
def test_final_gasp_dumps_and_flushes(tmp_path, how):
    env = dict(os.environ, HOROVOD_TPU_BLACKBOX=str(tmp_path),
               HOROVOD_TPU_METRICS_FILE=str(tmp_path / "metrics.json"),
               HOROVOD_TPU_METRICS_INTERVAL="3600")
    proc = subprocess.Popen([sys.executable, "-c", _GASP, how], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        if how == "sigterm":
            assert proc.stdout.readline().strip() == "PARKED"
            proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT_S)
    assert proc.returncode != 0
    header, events = _load(tmp_path / "blackbox-rank0.jsonl")
    assert header["reason"] == {"raise": "exception", "sigterm": "sigterm"}[
        how]
    if how == "raise":
        assert "boom in the replica" in header["error"] and "boom" in err
    assert events[-1]["kind"] == "serving"
    metrics = json.loads((tmp_path / "metrics.json").read_text())
    assert metrics["hvdtpu_gasp_total"]["values"][""] == 5
    # JAX's reader parses the dump
    assert postmortem.load_dump(
        str(tmp_path / "blackbox-rank0.jsonl")) is not None
