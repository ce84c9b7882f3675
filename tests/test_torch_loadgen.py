"""The port's load generator (``serving/loadgen.py``) against JAX's: a
seed gives the same schedule and checksum for several tenant mixes and
both arrival processes, save/load round-trips, ``run_schedule`` keeps
offered == sent + dropped, and ``summarize`` rolls the same run dict up
alike. Host Python only (an injected sender stands in for the router)."""

import threading
import time

import pytest

from horovod_tpu.serving import loadgen as jlg
from horovod_tpu_torch.serving import loadgen as tlg

MIXES = {
    "one": [dict(name="chat")],
    "two": [dict(name="chat", weight=3.0, prompt_len=(4, 12),
                 max_new_tokens=8, slo={"ttft_ms": 200}),
            dict(name="batch", weight=1.0, prompt_len=(32, 64),
                 max_new_tokens=32, priority="bulk", vocab=1000)],
    "smoke": [dict(name="flagship", prompt_len=(32, 1024),
                   max_new_tokens=64, vocab=32000)],
    "three": [dict(name="a", weight=0.5, prompt_len=(1, 1)),
              dict(name="b", weight=0.0),
              dict(name="c", weight=2.0, prompt_len=(8, 9),
                   slo={"ttft_ms": 50, "tpot_ms": 5},
                   priority="interactive")],
}


def _mix(mod, name):
    return [mod.TenantSpec(**kw) for kw in MIXES[name]]


@pytest.mark.parametrize("process", ["poisson", "constant"])
@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_schedule_and_checksum_match_jax(seed, mix, process):
    got = tlg.build_schedule(3.0, 20.0, seed, _mix(tlg, mix), process)
    want = jlg.build_schedule(3.0, 20.0, seed, _mix(jlg, mix), process)
    assert [a.to_dict() for a in got] == [a.to_dict() for a in want]
    assert tlg.schedule_checksum(got) == jlg.schedule_checksum(want)
    assert got and all(0 < a.t_s <= 20.0 for a in got)


@pytest.mark.parametrize("args,match", [
    ((0.0, 1.0, 0, "one", "poisson"), "rate_rps"),
    ((1.0, 0.0, 0, "one", "poisson"), "duration_s"),
    ((1.0, 1.0, 0, None, "poisson"), "TenantSpec"),
    ((1.0, 1.0, 0, "one", "burst"), "arrival process")])
def test_bad_schedules_fail_alike(args, match):
    rate, dur, seed, mix, process = args
    for mod in (tlg, jlg):
        with pytest.raises(ValueError, match=match):
            mod.build_schedule(rate, dur, seed,
                               _mix(mod, mix) if mix else [], process)


def test_save_load_round_trip_reads_in_jax(tmp_path):
    sched = tlg.build_schedule(5.0, 10.0, 3, _mix(tlg, "two"))
    path = str(tmp_path / "s.jsonl")
    tlg.save_schedule(sched, path)
    assert tlg.load_schedule(path) == sched
    assert jlg.schedule_checksum(jlg.load_schedule(path)) == \
        tlg.schedule_checksum(sched)


def _fake_sender(lock, state):
    """A stand-in router: unary replies keyed by arrival, some refused,
    each slow enough (0.1 s at 60 arrivals a second) that the in-flight
    cap of 2 drops arrivals."""
    def send(arrival):
        with lock:
            state["n"] += 1
            n = state["n"]
        time.sleep(0.1)
        if n % 5 == 0:
            return {"_http_status": 429, "error": "queue full"}
        if n % 7 == 0:
            return {"_http_status": 504, "error": "deadline exceeded"}
        if n % 11 == 0:
            return {"_error": "connection refused", "_http_status": 0}
        return {"_http_status": 200, "ttft_ms": float(n),
                "latency_ms": 10.0 * n, "trace_id": f"t{n}",
                "tenant": arrival.tenant,
                "slo": {"slo_met": n % 3 != 0}}
    return send


def test_run_schedule_and_summarize_match_jax():
    sched = tlg.build_schedule(60.0, 1.0, 4, _mix(tlg, "three"))
    run = tlg.run_schedule(sched, max_inflight=2, timeout_s=30,
                           sender=_fake_sender(threading.Lock(), {"n": 0}))
    assert run["offered"] == len(sched) == run["sent"] + run["dropped"]
    assert run["dropped"] >= 1
    assert run["drop_reasons"] == {tlg.DROP_REASON_INFLIGHT: run["dropped"]}
    statuses = {r["status"] for r in run["results"]}
    assert {"completed", "dropped"} <= statuses
    for classes in (None, {"a": "bulk", "c": "interactive"}):
        got = tlg.summarize(run, classes)
        assert got == jlg.summarize(run, classes)
        assert got["totals"]["offered"] == len(sched)
    assert "by_class" in tlg.summarize(run)


def test_summarize_counts_every_status():
    run = {"offered": 6, "sent": 5, "dropped": 1, "results": [
        {"tenant": "x", "status": "completed", "ttft_ms": 5.0,
         "latency_ms": 50.0, "slo": {"slo_met": True}},
        {"tenant": "x", "status": "completed", "ttft_ms": 9.0,
         "latency_ms": 90.0, "slo": {"slo_met": False}},
        {"tenant": "x", "status": "rejected"},
        {"tenant": "y", "status": "deadline"},
        {"tenant": "y", "status": "error"},
        {"tenant": "y", "status": "dropped", "priority": "bulk"}]}
    got = tlg.summarize(run)
    assert got == jlg.summarize(run)
    assert got["tenants"]["x"]["goodput"] == 1
    assert got["tenants"]["y"]["failed"] == 1
    assert got["totals"]["goodput_frac"] == round(1 / 6, 4)
