"""The port's health tool (``horovod_tpu_torch/tools/health.py``, over
the port's history reader and detectors) against JAX's: every case of
``tests/test_health_tool.py`` on the same synthetic history files,
written by the port's ``HistoryWriter`` (merged reports, sparklines,
offline detector verdicts, the regression ranking, torn tails, the
``--baseline`` A/B and its exit codes through ``python -m
horovod_tpu_torch.tools.health``), and a parity case that feeds the same
files, these and the history a 2-rank gloo run of the port's sampler
wrote, to both tools' ``analyze`` / ``compare_baseline`` and
``format_report``: the dicts and the text are equal."""

import json
import subprocess
import sys
import os

import pytest

from horovod_tpu.observability import history as _jax_history
from horovod_tpu.tools import health as _jax_tool
from horovod_tpu_torch.observability import history as _history
from horovod_tpu_torch.tools import health as _tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_run(directory, *, step_s=0.010, leak=False, ranks=2,
               samples=40, shift_at=None):
    """Synthesize a run's history dir: per-rank files with a step-time
    |mean series (optionally shifting at sample `shift_at`), an HBM
    gauge (optionally leaking), and a throughput counter rate."""
    for rank in range(ranks):
        w = _history.HistoryWriter(
            str(directory), f"rank{rank}",
            meta=lambda r=rank: {"rank": r, "world": ranks,
                                 "offset_to_rank0_us": 0.0,
                                 "clock_synced": True})
        for i in range(samples):
            v = step_s
            if shift_at is not None and i >= shift_at:
                v = step_s * 1.3
            hbm = 1e6 + (5e4 * i if leak else 0.0)
            w.append({"t_us": 1_000_000 + i * 100_000,
                      "u": 1000.0 + i, "dt_s": 0.1,
                      "s": {'hvdtpu_step_seconds{framework="t"}|mean': v,
                            'hvdtpu_hbm_bytes_in_use{device="host"}':
                                hbm,
                            "hvdtpu_samples_total": 320.0}})
        w.close()


class TestAnalyze:
    def test_healthy_run_reports_no_alerts(self, tmp_path):
        _write_run(tmp_path)
        report = _tool.analyze(_history.load_history([str(tmp_path)]))
        assert len(report["labels"]) == 2
        assert report["alerts"] == []
        assert report["top_regressions"] == []
        text = _tool.format_report(report)
        assert "healthy" in text

    def test_regression_fires_verdict_and_ranks_top(self, tmp_path):
        _write_run(tmp_path, shift_at=25)
        report = _tool.analyze(_history.load_history([str(tmp_path)]))
        kinds = {a["kind"] for a in report["alerts"]}
        assert kinds == {"step_time_regression"}
        assert {a["label"] for a in report["alerts"]} == {"rank0",
                                                         "rank1"}
        top = report["top_regressions"][0]
        assert "step_seconds" in top["series"]
        assert top["change_frac"] == pytest.approx(0.3, abs=0.05)

    def test_leak_verdict_names_offender_and_window(self, tmp_path):
        _write_run(tmp_path, leak=True, ranks=1)
        report = _tool.analyze(_history.load_history([str(tmp_path)]))
        leaks = [a for a in report["alerts"] if a["kind"] == "hbm_leak"]
        assert leaks
        assert leaks[0]["rank"] == 0
        assert leaks[0]["window_s"] > 0
        # The leaking series gets a sparkline even though HBM is a
        # headline family anyway; check the spark rendering shape.
        rows = report["sparklines"]["rank0"]
        key = 'hvdtpu_hbm_bytes_in_use{device="host"}'
        assert key in rows
        assert set(rows[key]["spark"]) <= set(_tool.SPARK_BLOCKS)

    def test_sparkline_resamples_long_series(self):
        assert len(_tool.sparkline(list(range(1000)), width=40)) == 40
        assert _tool.sparkline([1.0, 1.0, 1.0]) == "▁▁▁"
        assert _tool.sparkline([]) == ""


class TestBaseline:
    def test_identical_runs_report_no_regressions(self, tmp_path):
        _write_run(tmp_path / "a")
        _write_run(tmp_path / "b")
        cur = _history.load_history([str(tmp_path / "a")])
        base = _history.load_history([str(tmp_path / "b")])
        b = _tool.compare_baseline(cur, base)
        assert b["verdict"] == "no_regressions"
        assert b["regressions"] == []
        assert b["series_compared"] > 0

    def test_injected_regression_ranks_step_time_top(self, tmp_path):
        """ACCEPTANCE: a 20% step-time regression vs baseline ranks
        step time as the top regression."""
        _write_run(tmp_path / "base", step_s=0.010)
        _write_run(tmp_path / "cur", step_s=0.012)
        cur = _history.load_history([str(tmp_path / "cur")])
        base = _history.load_history([str(tmp_path / "base")])
        b = _tool.compare_baseline(cur, base)
        assert b["verdict"] == "regressions"
        top = b["regressions"][0]
        assert "step_seconds" in top["series"]
        assert top["change_frac"] == pytest.approx(0.2, abs=0.02)

    def test_improvement_is_not_a_regression(self, tmp_path):
        _write_run(tmp_path / "base", step_s=0.012)
        _write_run(tmp_path / "cur", step_s=0.010)
        cur = _history.load_history([str(tmp_path / "cur")])
        base = _history.load_history([str(tmp_path / "base")])
        b = _tool.compare_baseline(cur, base)
        assert b["verdict"] == "no_regressions"
        assert b["improvements"]


def _write_slo_run(directory, *, goodput_rps=10.0, violations_rps=0.5,
                   samples=40):
    """Synthesize a serving replica's history with the hvdtpu_slo_*
    families the fleet sampler scrapes (counters land as per-second
    rates under the bare series key)."""
    w = _history.HistoryWriter(
        str(directory), "replica0",
        meta=lambda: {"replica": 0, "generation": 0,
                      "role": "serving_replica",
                      "offset_to_rank0_us": 0.0,
                      "clock_synced": True})
    for i in range(samples):
        w.append({"t_us": 1_000_000 + i * 100_000,
                  "u": 1000.0 + i, "dt_s": 0.1,
                  "s": {'hvdtpu_slo_goodput_total{tenant="gold"}':
                            goodput_rps,
                        'hvdtpu_slo_violations_total'
                        '{reason="ttft",tenant="gold"}':
                            violations_rps}})
    w.close()


class TestSloSeries:
    def test_goodput_series_gets_headline_sparkline(self, tmp_path):
        _write_slo_run(tmp_path)
        report = _tool.analyze(_history.load_history([str(tmp_path)]))
        rows = report["sparklines"]["replica0"]
        assert 'hvdtpu_slo_goodput_total{tenant="gold"}' in rows
        assert ('hvdtpu_slo_violations_total'
                '{reason="ttft",tenant="gold"}') in rows

    def test_direction_semantics(self):
        # Goodput falling is worse; violations rising is worse. The
        # goodput marker must win over the generic counter suffix.
        assert _tool._direction(
            'hvdtpu_slo_goodput_total{tenant="a"}') == -1
        assert _tool._direction(
            'hvdtpu_slo_violations_total{reason="ttft",tenant="a"}') \
            == 1

    def test_goodput_drop_is_a_baseline_regression(self, tmp_path):
        _write_slo_run(tmp_path / "base", goodput_rps=10.0)
        _write_slo_run(tmp_path / "cur", goodput_rps=6.0)
        cur = _history.load_history([str(tmp_path / "cur")])
        base = _history.load_history([str(tmp_path / "base")])
        b = _tool.compare_baseline(cur, base)
        assert b["verdict"] == "regressions"
        assert any("slo_goodput" in r["series"]
                   for r in b["regressions"])


class TestCLI:
    def _run(self, *argv):
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.tools.health",
             *argv], capture_output=True, text=True, timeout=120,
            cwd=ROOT)
        return proc

    def test_cli_json_end_to_end(self, tmp_path):
        _write_run(tmp_path, shift_at=25)
        proc = self._run(str(tmp_path), "--json")
        assert proc.returncode == 0, proc.stderr[-2000:]
        report = json.loads(proc.stdout)
        assert report["alerts"]
        assert report["top_regressions"]

    def test_cli_baseline_text(self, tmp_path):
        _write_run(tmp_path / "base", step_s=0.010)
        _write_run(tmp_path / "cur", step_s=0.012)
        proc = self._run(str(tmp_path / "cur"), "--baseline",
                         str(tmp_path / "base"))
        # A baseline diff that FOUND regressions exits 3 — the CI-gate
        # contract (docs/health.md#baseline).
        assert proc.returncode == 3, proc.stderr[-2000:]
        assert "REGRESSED" in proc.stdout
        assert "step_seconds" in proc.stdout

    def test_cli_baseline_clean_exits_0(self, tmp_path):
        """ACCEPTANCE (CI shape): two identical benches diffed with
        --baseline --json exit 0 with verdict no_regressions — the
        exact invocation a perf gate runs."""
        _write_run(tmp_path / "a", step_s=0.010)
        _write_run(tmp_path / "b", step_s=0.010)
        proc = self._run(str(tmp_path / "a"), "--baseline",
                         str(tmp_path / "b"), "--json")
        assert proc.returncode == 0, proc.stderr[-2000:]
        report = json.loads(proc.stdout)
        assert report["baseline"]["verdict"] == "no_regressions"
        assert report["baseline"]["regressions"] == []

    def test_cli_baseline_regressed_json_exits_3(self, tmp_path):
        _write_run(tmp_path / "base", step_s=0.010)
        _write_run(tmp_path / "cur", step_s=0.013)
        proc = self._run(str(tmp_path / "cur"), "--baseline",
                         str(tmp_path / "base"), "--json")
        assert proc.returncode == 3
        report = json.loads(proc.stdout)
        assert report["baseline"]["verdict"] == "regressions"

    def test_cli_missing_dir_exits_2(self, tmp_path):
        proc = self._run(str(tmp_path / "nope"))
        assert proc.returncode == 2
        assert "no history files" in proc.stderr

    def test_cli_tolerates_torn_tail(self, tmp_path):
        _write_run(tmp_path, ranks=1)
        with open(tmp_path / "history-rank0.jsonl", "a") as f:
            f.write('{"t_us": 99, "s": {"torn')
        proc = self._run(str(tmp_path), "--json")
        assert proc.returncode == 0, proc.stderr[-2000:]
        report = json.loads(proc.stdout)
        assert report["labels"][0]["samples"] == 40


# --------------------------------------------------------------------------
# Parity with JAX's tool on the same files
# --------------------------------------------------------------------------

def _both(cur, base=None):
    ours = _tool.analyze(_history.load_history(cur))
    theirs = _jax_tool.analyze(_jax_history.load_history(cur))
    if base is not None:
        ours["baseline"] = _tool.compare_baseline(
            _history.load_history(cur), _history.load_history(base))
        theirs["baseline"] = _jax_tool.compare_baseline(
            _jax_history.load_history(cur), _jax_history.load_history(base))
    assert ours == theirs
    assert _tool.format_report(ours) == _jax_tool.format_report(theirs)
    return ours


SYNTHETIC = {
    "healthy": lambda d: _write_run(d),
    "shift": lambda d: _write_run(d, shift_at=25),
    "leak": lambda d: _write_run(d, leak=True, ranks=1),
    "slo": lambda d: _write_slo_run(d),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_parity_on_synthetic_history(tmp_path, case):
    SYNTHETIC[case](tmp_path / "cur")
    _write_run(tmp_path / "base", step_s=0.011)
    _both([str(tmp_path / "cur")], [str(tmp_path / "base")])


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    import _torch_tools_workers as workers
    out = tmp_path_factory.mktemp("gloo_tools")
    workers.run(str(out))
    return out


def test_parity_on_a_gloo_run_of_the_port(gloo_run):
    """The history the port's sampler wrote on both ranks of a gloo job:
    one label a rank, the step families sparked, and both tools' reports
    (and a baseline of the run against itself: no regression) equal."""
    d = str(gloo_run / "history")
    report = _both([d], [d])
    assert [lab["label"] for lab in report["labels"]] == ["rank0", "rank1"]
    assert all(lab["samples"] >= 4 for lab in report["labels"])
    assert any("hvdtpu_step_seconds" in k
               for k in report["sparklines"]["rank0"])
    assert report["baseline"]["verdict"] == "no_regressions"


def test_cli_options_match_jax():
    """The same positional arguments and flags as JAX's CLI."""
    from _torch_tools_workers import cli_options
    ours = cli_options(_tool._main, ["x"])
    assert ours and ours == cli_options(_jax_tool._main, ["x"])
