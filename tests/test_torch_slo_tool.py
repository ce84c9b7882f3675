"""The port's goodput tool (``horovod_tpu_torch/tools/slo.py``, over the
port's history reader and loadgen) against JAX's: every tool case of
``tests/test_slo.py`` (knee detection, no knee, the baseline's exit
code) on the same loadgen run files, a parity case that feeds the same
files (runs, a BENCH_SLO-shaped sweep with its QoS block, a fleet
history with ``hvdtpu_slo_*`` series) to both tools' ``build_report``
and ``format_report``, and their CLI options."""

import json

from horovod_tpu.tools import slo as _jax_slo_tool
from horovod_tpu_torch.observability import history as _history
from horovod_tpu_torch.tools import slo as _slo_tool


class TestSloTool:
    def _fake_run(self, goodput_frac, p99, rps, name):
        n = 20
        good = int(round(n * goodput_frac))
        results = []
        for i in range(n):
            met = i < good
            results.append({
                "tenant": "t", "t_s": i * 0.05,
                "status": "completed",
                "ttft_ms": p99 if not met else p99 / 10,
                "latency_ms": p99, "slo": {"slo_met": met}})
        return {"offered": n, "sent": n, "dropped": 0,
                "drop_reasons": {}, "wall_s": 1.0,
                "offered_rps": rps, "name": name,
                "results": results}

    def test_knee_detection(self, tmp_path):
        paths = []
        for i, (frac, p99, rps) in enumerate(
                [(1.0, 50, 4), (0.95, 200, 10), (0.5, 2000, 25)]):
            p = tmp_path / f"run{i}.json"
            p.write_text(json.dumps(
                self._fake_run(frac, p99, rps, f"rps{rps}")))
            paths.append(str(p))
        report = _slo_tool.build_report(paths, target_ttft_ms=500.0)
        assert [a["name"] for a in report["arms"]] \
            == ["rps4", "rps10", "rps25"]
        assert report["knee"]["name"] == "rps25"
        text = _slo_tool.format_report(report)
        assert "<-- knee" in text and "rps25" in text

    def test_no_knee(self, tmp_path):
        p = tmp_path / "run.json"
        p.write_text(json.dumps(self._fake_run(1.0, 50, 4, "rps4")))
        report = _slo_tool.build_report([str(p)],
                                        target_ttft_ms=500.0)
        assert report["knee"] is None
        assert "no knee" in _slo_tool.format_report(report)

    def test_baseline_regression_exit_code(self, tmp_path,
                                           capsys):
        cur = tmp_path / "cur.json"
        base = tmp_path / "base.json"
        cur.write_text(json.dumps(self._fake_run(0.6, 900, 10,
                                                 "rps10")))
        base.write_text(json.dumps(self._fake_run(1.0, 60, 10,
                                                  "rps10")))
        rc = _slo_tool.main([str(cur), "--baseline", str(base)])
        assert rc == 3
        assert "REGRESSED" in capsys.readouterr().out
        # And the other way round is clean (an improvement).
        rc = _slo_tool.main([str(base), "--baseline", str(cur)])
        assert rc == 0


def _sweep_doc():
    run = TestSloTool()._fake_run
    arms = {}
    for frac, p99, rps in [(1.0, 40, 2), (0.8, 700, 12)]:
        arm = _slo_tool._arm_from_run(f"rps{rps}",
                                      run(frac, p99, rps, f"rps{rps}"))
        arm["by_class"] = {"interactive": {"offered": 20, "goodput": 15,
                                           "slo_violations": 5,
                                           "shed": 1}}
        arms[f"rps{rps}"] = arm
    return {"sweep": arms, "qos": {
        "interactive_p99_inflation_qos": 1.2,
        "interactive_p99_inflation_baseline": 3.4, "reserved_slots": 2,
        "interactive_only": {"name": "io", "tenants": {"a": {"shed": 2}}},
        "autoscale": {"sweep": {}, "scale_events": [
            {"direction": "up", "why": "queue"},
            {"direction": "up", "why": "queue"}]}}}


def _slo_history(directory):
    w = _history.HistoryWriter(
        str(directory), "replica0",
        meta=lambda: {"replica": 0, "offset_to_rank0_us": 0.0,
                      "clock_synced": True})
    for i in range(20):
        w.append({"t_us": 1_000_000 + i * 100_000, "u": 1000.0 + i,
                  "dt_s": 0.1,
                  "s": {'hvdtpu_slo_goodput_total{tenant="gold"}': 10.0,
                        'hvdtpu_slo_ttft_seconds{tenant="gold"}|p99':
                            0.2 + i / 100}})
    w.close()


def test_parity_build_and_format(tmp_path):
    run = TestSloTool()._fake_run
    paths = []
    for i, (frac, p99, rps) in enumerate([(1.0, 50, 4), (0.5, 2000, 25)]):
        p = tmp_path / f"run{i}.json"
        p.write_text(json.dumps(run(frac, p99, rps, f"rps{rps}")))
        paths.append(str(p))
    bench = tmp_path / "BENCH_SLO.json"
    bench.write_text(json.dumps(_sweep_doc()))
    _slo_history(tmp_path / "hist")
    kw = dict(target_ttft_ms=500.0, history_dir=str(tmp_path / "hist"),
              qos=True)
    ours = _slo_tool.build_report(paths + [str(bench)], **kw)
    theirs = _jax_slo_tool.build_report(paths + [str(bench)], **kw)
    assert ours == theirs and ours["qos"] and ours["history"]
    assert _slo_tool.format_report(ours) == \
        _jax_slo_tool.format_report(theirs)
    base = _slo_tool.load_arms([paths[0]])
    assert _slo_tool.compare_baseline(ours["arms"], base) == \
        _jax_slo_tool.compare_baseline(theirs["arms"], base)


def test_cli_options_match_jax():
    """The same positional arguments and flags as JAX's CLI."""
    from _torch_tools_workers import cli_options
    ours = cli_options(_slo_tool.main, ["x"])
    assert ours and ours == cli_options(_jax_slo_tool.main, ["x"])
