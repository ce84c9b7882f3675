"""The port's trace tool (``horovod_tpu_torch/tools/trace.py``) against
JAX's: every case of ``tests/test_trace_tool.py`` on the same synthetic
per-rank captures (adversarial clocks, clock sources, phase
attribution, group fallback, truncated captures, the CLI, bound
verdicts, the percentile estimator over the port's registry), a parity
case that feeds the same files to both tools' ``analyze`` /
``serving_report`` and ``format_report``, and deviation 47: a port
timeline's ``GLOO_*`` (``NCCL_*`` on the card) spans are execute time to
the port's tool, where JAX's counts ``XLA_*`` alone and finds none."""

import json

import numpy as np
import pytest

from horovod_tpu.tools import trace as jax_trace
from horovod_tpu_torch.observability import histogram_percentiles
from horovod_tpu_torch.observability.registry import (LATENCY_BUCKETS,
                                                      Histogram)
from horovod_tpu_torch.tools import trace as trace_tool

MS = 1000  # µs per ms


def _write_trace(path, rank, world, events, start_mono_us, offset_us,
                 synced=True, meta_in_trace=True, sidecar=False):
    """A per-rank catapult file the way PyTimeline lays it out: meta
    header, process_name per tensor, B/E phase events."""
    out = []
    if meta_in_trace:
        out.append({"name": "horovod_tpu_trace_meta", "ph": "M",
                    "pid": 0, "tid": 0,
                    "args": {"rank": rank, "world": world,
                             "start_mono_us": start_mono_us,
                             "offset_to_rank0_us": offset_us,
                             "rtt_us": 40.0, "clock_synced": synced}})
    pids = {}
    for e in events:
        tensor = e.pop("tensor")
        if tensor not in pids:
            pids[tensor] = len(pids)
            out.append({"name": "process_name", "ph": "M",
                        "pid": pids[tensor], "args": {"name": tensor}})
        e["pid"] = pids[tensor]
        e.setdefault("tid", 0)
        out.append(e)
    path.write_text(json.dumps(out))
    if sidecar:
        sc = {"rank": rank, "world": world,
              "start_mono_us": start_mono_us,
              "offset_to_rank0_us": offset_us, "rtt_us": 40.0,
              "clock_synced": synced}
        (path.parent / (path.name + ".clock.json")).write_text(
            json.dumps(sc))


def _collective_events(tensor, group, arrival_us, neg_dur_us,
                       exec_dur_us=500):
    """One collective's lifecycle on one rank, in LOCAL trace ts."""
    t = arrival_us
    return [
        {"tensor": tensor, "ph": "B", "ts": t,
         "name": "NEGOTIATE_ALLREDUCE"},
        {"tensor": tensor, "ph": "E", "ts": t + neg_dur_us,
         "args": {"group": group}},
        {"tensor": tensor, "ph": "B", "ts": t + neg_dur_us,
         "name": "ALLREDUCE"},
        {"tensor": tensor, "ph": "B", "ts": t + neg_dur_us + 10,
         "name": "XLA_ALLREDUCE"},
        {"tensor": tensor, "ph": "E",
         "ts": t + neg_dur_us + 10 + exec_dur_us},
        {"tensor": tensor, "ph": "E",
         "ts": t + neg_dur_us + 20 + exec_dur_us},
    ]


def _make_cluster(tmp_path, skews_us, late_rank, late_by_us,
                  jitters_us=None, n_groups=10, sidecar_only=False):
    """World of len(skews_us) ranks. Rank clocks are skewed by
    ``skews_us`` (local = global + skew); recorded offsets are the true
    correction (-skew) plus per-rank ``jitters_us`` (sync error).
    ``late_rank`` arrives ``late_by_us`` after everyone in every group.
    Ground-truth global arrival of group g on a punctual rank:
    g * 10ms."""
    world = len(skews_us)
    jitters_us = jitters_us or [0.0] * world
    paths = []
    for rank, skew in enumerate(skews_us):
        start_global = 0
        start_mono = start_global + skew
        events = []
        for g in range(n_groups):
            arrive_global = g * 10 * MS + \
                (late_by_us if rank == late_rank else 0)
            # Local trace ts = global - start_global (the skew lives in
            # start_mono_us, exactly as a real capture records it).
            events += _collective_events(
                f"t.{g}", group=g, arrival_us=arrive_global - start_global,
                neg_dur_us=(late_by_us if rank != late_rank else 100))
        _write_trace(tmp_path / f"trace.{rank}.json", rank, world, events,
                     start_mono_us=start_mono,
                     offset_us=-skew + jitters_us[rank],
                     meta_in_trace=not sidecar_only, sidecar=sidecar_only)
        paths.append(str(tmp_path / f"trace.{rank}.json"))
    return paths


class TestAdversarialClocks:
    """±50 ms skews + jittered offsets: ordering and attribution must
    come out right after realignment."""

    SKEWS = [0.0, 50 * MS, -50 * MS, 17 * MS]
    JITTERS = [0.0, 1500.0, -2000.0, 900.0]   # sync error, µs
    LATE, LATE_BY = 2, 80 * MS                # rank 2 is 80 ms late

    def _traces(self, tmp_path):
        paths = _make_cluster(tmp_path, self.SKEWS, self.LATE,
                              self.LATE_BY, jitters_us=self.JITTERS)
        return trace_tool.load_traces([str(tmp_path / "trace.{rank}.json")])

    def test_merged_ordering_matches_ground_truth(self, tmp_path):
        traces = self._traces(tmp_path)
        out = tmp_path / "merged.json"
        trace_tool.merge_traces(traces, str(out))
        merged = json.loads(out.read_text())
        # One Perfetto process per rank, tensors as named threads.
        procs = {e["pid"]: e["args"]["name"] for e in merged
                 if e.get("name") == "process_name"}
        assert procs == {r: f"rank {r}" for r in range(4)}
        threads = [e for e in merged if e.get("name") == "thread_name"]
        assert {e["args"]["name"] for e in threads} >= {"t.0", "t.9"}
        # Realigned NEGOTIATE starts: within every group, the late
        # rank's tick is last, and all punctual ranks agree within the
        # injected sync jitter despite ±50 ms raw skew.
        starts = {}   # (rank, group-index by order) -> ts
        per_rank_counts = {r: 0 for r in range(4)}
        for e in merged:
            if e.get("ph") == "B" and e.get("name") == "NEGOTIATE_ALLREDUCE":
                r = e["pid"]
                starts[(r, per_rank_counts[r])] = e["ts"]
                per_rank_counts[r] += 1
        tol = 2 * max(abs(j) for j in self.JITTERS)
        for g in range(10):
            arr = {r: starts[(r, g)] for r in range(4)}
            assert max(arr, key=lambda r: arr[r]) == self.LATE
            punctual = [arr[r] for r in range(4) if r != self.LATE]
            assert max(punctual) - min(punctual) <= tol
            assert arr[self.LATE] - min(punctual) == pytest.approx(
                self.LATE_BY, abs=tol)

    def test_lateness_attribution_within_tolerance(self, tmp_path):
        traces = self._traces(tmp_path)
        report = trace_tool.analyze(traces, top=5)
        assert report["groups_scored"] == 10
        top = report["top_straggler"]
        assert top["rank"] == self.LATE
        # Within 2x of the injected 80 ms (log-bucket estimator + jitter).
        assert self.LATE_BY / 1e6 / 2 <= top["p50_s"] <= self.LATE_BY / 1e6 * 2
        assert top["groups_last"] == 10
        # The skew is injected UPSTREAM of the collective path (pure
        # arrival lateness), and the report says so.
        assert top["loses_most_in"] == "upstream(compute/input)"
        # Punctual ranks show ~zero lateness — the ±50 ms raw skews were
        # corrected away.
        for r in range(4):
            if r != self.LATE:
                assert report["per_rank"][str(r)]["lateness"]["p50_s"] \
                    < 0.01
        # Every worst group is attributed to the late rank.
        assert {g["critical_rank"] for g in report["worst_groups"]} \
            == {self.LATE}

    def test_unsynced_clock_flagged_in_report(self, tmp_path):
        paths = _make_cluster(tmp_path, [0.0, 30 * MS], late_rank=1,
                              late_by_us=0, n_groups=3)
        traces = trace_tool.load_traces(paths)
        traces[1].meta["clock_synced"] = False
        report = trace_tool.analyze(traces)
        assert report["clock"]["1"]["synced"] is False
        assert "unsynced" in trace_tool.format_report(report)


class TestClockMetaSources:
    def test_sidecar_fallback(self, tmp_path):
        """Native-writer captures carry clock meta only in the sidecar;
        the loader must pick it up."""
        paths = _make_cluster(tmp_path, [0.0, 40 * MS], late_rank=1,
                              late_by_us=20 * MS, n_groups=4,
                              sidecar_only=True)
        traces = trace_tool.load_traces(paths)
        assert traces[1].meta["offset_to_rank0_us"] == -40 * MS
        report = trace_tool.analyze(traces)
        assert report["top_straggler"]["rank"] == 1
        assert report["top_straggler"]["p50_s"] == pytest.approx(
            0.020, rel=1.0)

    def test_headerless_traces_fall_back_to_position(self, tmp_path):
        for i in range(2):
            _write_trace(tmp_path / f"t.{i}.json", rank=i, world=2,
                         events=_collective_events("a", 0, 100, 50),
                         start_mono_us=0, offset_us=0.0,
                         meta_in_trace=False)
        traces = trace_tool.load_traces(
            [str(tmp_path / "t.0.json"), str(tmp_path / "t.1.json")])
        assert [t.rank for t in traces] == [0, 1]

    def test_duplicate_rank_rejected(self, tmp_path):
        for name in ("a.json", "b.json"):
            _write_trace(tmp_path / name, rank=0, world=2,
                         events=_collective_events("a", 0, 100, 50),
                         start_mono_us=0, offset_us=0.0)
        with pytest.raises(ValueError, match="duplicate rank"):
            trace_tool.load_traces([str(tmp_path / "a.json"),
                                    str(tmp_path / "b.json")])


class TestPhaseAttribution:
    def test_execute_heavy_rank_attributed_to_execute(self, tmp_path):
        """A rank slow INSIDE the collective path (long XLA spans) is
        attributed to the execute phase, not 'upstream'."""
        world = 2
        for rank in range(world):
            events = []
            for g in range(6):
                events += _collective_events(
                    f"t.{g}", group=g, arrival_us=g * 10 * MS,
                    neg_dur_us=100,
                    exec_dur_us=(40 * MS if rank == 1 else 500))
            _write_trace(tmp_path / f"p.{rank}.json", rank, world, events,
                         start_mono_us=0, offset_us=0.0)
        traces = trace_tool.load_traces([str(tmp_path / "p.{rank}.json")])
        report = trace_tool.analyze(traces)
        assert report["per_rank"]["1"]["loses_most_in"] == "execute"
        assert report["per_rank"]["1"]["phase_mean_s"]["execute"] \
            == pytest.approx(0.040, rel=0.1)


class TestGroupFallback:
    def test_occurrence_pairing_without_group_ids(self, tmp_path):
        """Traces without recorded group seqs (the native C++ writer)
        pair NEGOTIATE spans by per-tensor occurrence order."""
        world = 2
        for rank in range(world):
            events = []
            for step in range(4):   # name reused every step
                late = 15 * MS if rank == 1 else 0
                evs = _collective_events(
                    "grad.w", group=None, arrival_us=step * 30 * MS + late,
                    neg_dur_us=100)
                for e in evs:
                    e.get("args", {}).pop("group", None)
                events += evs
            _write_trace(tmp_path / f"o.{rank}.json", rank, world, events,
                         start_mono_us=0, offset_us=0.0)
        traces = trace_tool.load_traces([str(tmp_path / "o.{rank}.json")])
        report = trace_tool.analyze(traces)
        assert report["groups_scored"] == 4
        assert report["top_straggler"]["rank"] == 1
        assert report["top_straggler"]["p50_s"] == pytest.approx(
            0.015, rel=1.0)


class TestTruncatedCapture:
    def test_killed_writer_tail_is_tolerated(self, tmp_path):
        """A rank killed mid-stream leaves an unterminated file with a
        possibly-unclosed span; the loader and analyzer must survive."""
        _write_trace(tmp_path / "k.0.json", 0, 2,
                     _collective_events("a", 0, 100, 50),
                     start_mono_us=0, offset_us=0.0)
        # Rank 1: valid prefix, then an unclosed B and a trailing comma.
        full = json.loads((tmp_path / "k.0.json").read_text())
        body = ",\n".join(json.dumps(e) for e in full[:-1])
        (tmp_path / "k.1.json").write_text(
            "[\n" + body.replace('"rank": 0', '"rank": 1') + ",\n")
        traces = trace_tool.load_traces([str(tmp_path / "k.{rank}.json")])
        report = trace_tool.analyze(traces)
        assert report["groups_scored"] >= 1


class TestCli:
    def test_merge_cli_writes_trace_and_report(self, tmp_path, capsys):
        _make_cluster(tmp_path, [0.0, 10 * MS], late_rank=1,
                      late_by_us=25 * MS, n_groups=5)
        out = tmp_path / "merged.json"
        rep = tmp_path / "report.json"
        trace_tool._main(["merge", str(tmp_path / "trace.{rank}.json"),
                          "-o", str(out), "--report", str(rep)])
        printed = capsys.readouterr().out
        assert "Top straggler: rank 1" in printed
        merged = json.loads(out.read_text())          # valid catapult JSON
        assert any(e.get("name") == "NEGOTIATE_ALLREDUCE" for e in merged)
        report = json.loads(rep.read_text())
        assert report["top_straggler"]["rank"] == 1

    def test_report_cli(self, tmp_path, capsys):
        _make_cluster(tmp_path, [0.0, 0.0], late_rank=0, late_by_us=0,
                      n_groups=2)
        trace_tool._main(["report", str(tmp_path / "trace.{rank}.json")])
        assert "fused groups scored" in capsys.readouterr().out

    def test_template_with_no_matches_errors(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            trace_tool.load_traces([str(tmp_path / "none.{rank}.json")])


class TestClockMetaDegrade:
    """Satellite: a missing or corrupt .clock.json sidecar degrades to
    zero offset with a warning in the report header — it must never
    fail the whole merge."""

    def _cluster_with_broken_sidecar(self, tmp_path, breakage):
        paths = _make_cluster(tmp_path, [0.0, 0.0], late_rank=1,
                              late_by_us=20 * MS, n_groups=4,
                              sidecar_only=True)
        victim = tmp_path / "trace.1.json.clock.json"
        if breakage == "missing":
            victim.unlink()
        else:
            victim.write_text('{"rank": 1, "world"')   # torn json
        return paths

    @pytest.mark.parametrize("breakage", ["missing", "corrupt"])
    def test_merge_and_report_survive(self, tmp_path, breakage):
        paths = self._cluster_with_broken_sidecar(tmp_path, breakage)
        traces = trace_tool.load_traces(paths)
        assert traces[1].clock_missing is True
        # Positional rank fallback kept the right identity.
        assert [t.rank for t in traces] == [0, 1]
        out = tmp_path / "merged.json"
        trace_tool.merge_traces(traces, str(out))     # no exception
        json.loads(out.read_text())
        report = trace_tool.analyze(traces)
        assert report["clock"]["1"]["meta_missing"] is True
        text = trace_tool.format_report(report)
        assert "no clock metadata" in text
        assert "zero-offset fallback" in text

    def test_intact_sidecars_not_flagged(self, tmp_path):
        paths = _make_cluster(tmp_path, [0.0, 0.0], late_rank=1,
                              late_by_us=10 * MS, n_groups=3,
                              sidecar_only=True)
        traces = trace_tool.load_traces(paths)
        report = trace_tool.analyze(traces)
        assert not any(c["meta_missing"]
                       for c in report["clock"].values())
        assert "no clock metadata" not in trace_tool.format_report(report)


def _step_spans(input_us, compute_us, n_steps, t0_us=0, gap_us=None):
    """StepTimer's STEP_* complete spans on the _step pseudo-process,
    as step_metrics emits them."""
    gap_us = gap_us if gap_us is not None else input_us
    out = []
    t = t0_us
    for _ in range(n_steps):
        t += gap_us
        if input_us:
            out.append({"tensor": "_step", "ph": "X", "ts": t - input_us,
                        "dur": input_us, "name": "STEP_INPUT"})
        out.append({"tensor": "_step", "ph": "X", "ts": t,
                    "dur": compute_us, "name": "STEP_COMPUTE"})
        t += compute_us
    return out


class TestBoundVerdicts:
    """Tentpole: per-rank and run-level input-bound vs compute-bound vs
    comm-bound verdicts from the STEP_* attribution spans."""

    def _cluster(self, tmp_path, input_us, compute_us, neg_us,
                 n_groups=5):
        world = 2
        for rank in range(world):
            events = []
            for g in range(n_groups):
                events += _collective_events(
                    f"t.{g}", group=g, arrival_us=g * 50 * MS,
                    neg_dur_us=neg_us)
            events += _step_spans(input_us, compute_us, n_groups)
            _write_trace(tmp_path / f"v.{rank}.json", rank, world,
                         events, start_mono_us=0, offset_us=0.0)
        traces = trace_tool.load_traces([str(tmp_path / "v.{rank}.json")])
        return trace_tool.analyze(traces)

    def test_input_dominated_run_is_input_bound(self, tmp_path):
        report = self._cluster(tmp_path, input_us=40 * MS,
                               compute_us=5 * MS, neg_us=100)
        assert report["bound"] == "input-bound"
        for r in ("0", "1"):
            assert report["per_rank"][r]["verdict"] == "input-bound"
            assert report["per_rank"][r]["phase_share"]["input"] > 0.5

    def test_compute_dominated_run_is_compute_bound(self, tmp_path):
        report = self._cluster(tmp_path, input_us=100,
                               compute_us=40 * MS, neg_us=100)
        assert report["bound"] == "compute-bound"
        assert report["per_rank"]["0"]["verdict"] == "compute-bound"

    def test_comm_dominated_run_is_comm_bound(self, tmp_path):
        # Long negotiate waits (a straggler fleet) dwarf input+compute.
        report = self._cluster(tmp_path, input_us=100,
                               compute_us=1 * MS, neg_us=60 * MS)
        assert report["bound"] == "comm-bound"
        assert report["per_rank"]["0"]["verdict"] == "comm-bound"
        assert report["fleet_share"]["comm"] > 0.5

    def test_no_step_spans_means_no_run_verdict(self, tmp_path):
        """Without StepTimer instrumentation the trace only contains
        collective spans — claiming comm-bound would be vacuous."""
        world = 2
        for rank in range(world):
            events = []
            for g in range(4):
                events += _collective_events(
                    f"t.{g}", group=g, arrival_us=g * 10 * MS,
                    neg_dur_us=100)
            _write_trace(tmp_path / f"n.{rank}.json", rank, world,
                         events, start_mono_us=0, offset_us=0.0)
        traces = trace_tool.load_traces([str(tmp_path / "n.{rank}.json")])
        report = trace_tool.analyze(traces)
        assert report["bound"] is None
        assert report["fleet_share"] is None

    def test_deviation_verdict_without_step_spans(self, tmp_path):
        """An execute-heavy rank still gets a comm-bound verdict from
        the deviation attribution even without step spans."""
        world = 2
        for rank in range(world):
            events = []
            for g in range(6):
                events += _collective_events(
                    f"t.{g}", group=g, arrival_us=g * 10 * MS,
                    neg_dur_us=100,
                    exec_dur_us=(40 * MS if rank == 1 else 500))
            _write_trace(tmp_path / f"d.{rank}.json", rank, world,
                         events, start_mono_us=0, offset_us=0.0)
        traces = trace_tool.load_traces([str(tmp_path / "d.{rank}.json")])
        report = trace_tool.analyze(traces)
        assert report["per_rank"]["1"]["verdict"] == "comm-bound"
        # Report renders the verdict column.
        assert "comm-bound" in trace_tool.format_report(report)


class TestHistogramPercentiles:
    """Satellite: p50/p90/p99 estimation from log-bucketed snapshots,
    exact to within one bucket width, shared by the trace report and the
    Prometheus endpoint's JSON view."""

    def _assert_within_bucket_width(self, est, exact):
        # The containing bucket's width bounds the interpolation error.
        bounds = [0.0] + list(LATENCY_BUCKETS)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if lo <= exact <= hi:
                assert abs(est - exact) <= (hi - lo) + 1e-12, \
                    (est, exact, lo, hi)
                return
        assert est <= LATENCY_BUCKETS[-1]   # beyond the finite range

    @pytest.mark.parametrize("dist", ["uniform", "lognormal", "bimodal"])
    def test_against_exact_percentiles(self, dist):
        rng = np.random.RandomState(7)
        if dist == "uniform":
            samples = rng.uniform(1e-4, 5e-2, 4000)
        elif dist == "lognormal":
            samples = np.exp(rng.normal(-7.0, 1.5, 4000))
        else:
            # Modes sized so no tested percentile lands exactly on the
            # inter-mode mass boundary (where any bucket estimator and
            # sample interpolation legitimately diverge by the gap).
            samples = np.concatenate([rng.uniform(1e-5, 2e-5, 1800),
                                      rng.uniform(1e-2, 2e-2, 2200)])
        h = Histogram(LATENCY_BUCKETS)
        for v in samples:
            h.observe(float(v))
        pct = histogram_percentiles(h.snapshot(), qs=(0.5, 0.9, 0.99))
        for q, key in [(50, "p50"), (90, "p90"), (99, "p99")]:
            self._assert_within_bucket_width(
                pct[key], float(np.percentile(samples, q)))

    def test_json_safe_plus_inf_buckets(self):
        """The endpoint path feeds snapshots whose +Inf bound became the
        string "+Inf" (strict JSON); the estimator must accept them."""
        h = Histogram(LATENCY_BUCKETS)
        for v in [1e-3] * 10:
            h.observe(v)
        snap = h.snapshot()
        snap["buckets"] = [["+Inf" if b[0] == float("inf") else b[0], b[1]]
                           for b in snap["buckets"]]
        pct = histogram_percentiles(snap)
        self._assert_within_bucket_width(pct["p50"], 1e-3)

    def test_empty_histogram(self):
        assert histogram_percentiles({"buckets": [], "count": 0}) == {}

    def test_overflow_bucket_returns_top_bound(self):
        h = Histogram([1e-3, 1e-2])
        for v in [5.0] * 8:     # all beyond the finite bounds
            h.observe(v)
        pct = histogram_percentiles(h.snapshot(), qs=(0.5,))
        assert pct["p50"] == 1e-2


# --------------------------------------------------------------------------
# Parity with JAX's tool, and deviation 47
# --------------------------------------------------------------------------

def _same(paths, top=5):
    ours = trace_tool.analyze(trace_tool.load_traces(paths), top=top)
    theirs = jax_trace.analyze(jax_trace.load_traces(paths), top=top)
    assert ours == theirs
    assert trace_tool.format_report(ours) == jax_trace.format_report(theirs)
    return ours


def _bound_cluster(tmp_path, prefix):
    per_rank = []
    for r in range(2):
        ev = _step_spans(3000, 5000, 6)
        for g in range(6):
            ev += _collective_events(f"t.{g}", group=g,
                                     arrival_us=g * 10 * MS + 400 * r,
                                     neg_dur_us=300 + 200 * r)
        per_rank.append(ev)
    for r, ev in enumerate(per_rank):
        _write_trace(tmp_path / f"{prefix}.{r}.json", r, 2, ev,
                     start_mono_us=0, offset_us=0.0)
    return [str(tmp_path / f"{prefix}.{{rank}}.json")]


SYNTHETIC = {
    "adversarial": lambda p: _make_cluster(
        p, TestAdversarialClocks.SKEWS, TestAdversarialClocks.LATE,
        TestAdversarialClocks.LATE_BY,
        jitters_us=TestAdversarialClocks.JITTERS),
    "sidecar_only": lambda p: _make_cluster(
        p, [0.0, 30 * MS], 1, 20 * MS, sidecar_only=True),
    "bound_verdicts": lambda p: _bound_cluster(p, "b"),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_parity_on_synthetic_captures(tmp_path, case):
    paths = SYNTHETIC[case](tmp_path)
    if len(paths) > 1:
        paths = [str(tmp_path / "trace.{rank}.json")]
    _same(paths)


def test_parity_serving_report(tmp_path):
    """Request traces (the router's REQUEST/FAILOVER, a replica's
    QUEUE_WAIT/PREFILL/DECODE/EGRESS rows) give both tools one budget."""
    def row(proc, spans, offset):
        out = [{"name": "horovod_tpu_trace_meta", "ph": "M", "pid": 0,
                "tid": 0, "args": {"proc": proc, "start_mono_us": 0,
                                   "offset_to_rank0_us": offset,
                                   "clock_synced": True}},
               {"name": "process_name", "ph": "M", "pid": 0,
                "args": {"name": "req-1"}}]
        out += [{"name": n, "ph": "X", "pid": 0, "ts": t, "dur": d,
                 "args": a} for n, t, d, a in spans]
        return out

    (tmp_path / "router.trace.json").write_text(json.dumps(row("router", [
        ("REQUEST", 0, 90 * MS, {"tenant": "t0"}),
        ("FAILOVER", 30 * MS, 25 * MS, {"phase": "decode", "from": 1,
                                        "to": 0})], 0.0)))
    (tmp_path / "replica1.trace.json").write_text(json.dumps(row(
        "replica1", [("QUEUE_WAIT", 1 * MS, 2 * MS, {}),
                     ("PREFILL", 3 * MS, 10 * MS, {"tokens": 64}),
                     ("DECODE", 13 * MS, 17 * MS, {})], 500.0)))
    (tmp_path / "replica0.trace.json").write_text(json.dumps(row(
        "replica0", [("PREFILL", 45 * MS, 12 * MS, {"tokens": 80}),
                     ("DECODE", 57 * MS, 30 * MS, {}),
                     ("EGRESS", 87 * MS, 2 * MS, {"slo_met": True})],
        -300.0)))
    ours = trace_tool.serving_report(
        trace_tool.load_traces([str(tmp_path)]))
    theirs = jax_trace.serving_report(jax_trace.load_traces([str(tmp_path)]))
    assert ours == theirs and ours["n_failovers"] == 1
    assert trace_tool.format_serving_report(ours) == \
        jax_trace.format_serving_report(theirs)


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    import _torch_tools_workers as workers
    out = tmp_path_factory.mktemp("gloo_tools")
    workers.run(str(out))
    return out


def _execute_seconds(path):
    """The sum of a port timeline's GLOO_/NCCL_ span durations, read
    straight from the file."""
    from horovod_tpu_torch.ops.timeline_py import load_timeline
    return sum(e["dur"] for e in load_timeline(path)
               if e.get("ph") == "X"
               and e.get("name", "").startswith(("GLOO_", "NCCL_"))) / 1e6


def test_deviation_47_port_timeline_execute_seconds(gloo_run):
    """JAX's tool gives a port timeline 0 execute seconds; the port's
    gives the sum of its GLOO_ spans, on every rank."""
    paths = [str(gloo_run / "timeline.{rank}.json")]
    ours = trace_tool.load_traces(paths)
    theirs = jax_trace.load_traces(paths)
    for t, j in zip(ours, theirs):
        want = _execute_seconds(t.path)
        assert want > 0
        assert trace_tool._phase_stats(t)[1]["execute"] == \
            pytest.approx(want, rel=1e-9)
        assert jax_trace._phase_stats(j)[1]["execute"] == 0.0
    ours_r = trace_tool.analyze(ours)
    theirs_r = jax_trace.analyze(theirs)
    for r in ("0", "1"):
        assert ours_r["per_rank"][r]["phase_mean_s"]["execute"] > 0
        assert theirs_r["per_rank"][r]["phase_mean_s"]["execute"] == 0.0


def test_parity_on_a_gloo_run_of_the_port(gloo_run, tmp_path):
    """With the port's GLOO_ spans renamed XLA_, JAX's report of the
    port's own timelines is the port tool's report of the originals;
    ``merge`` aligns both ranks' files alike."""
    paths = []
    for r in range(2):
        src = gloo_run / f"timeline.{r}.json"
        txt = src.read_text().replace('"GLOO_', '"XLA_')
        (tmp_path / f"x.{r}.json").write_text(txt)
        (tmp_path / f"x.{r}.json.clock.json").write_text(
            (gloo_run / f"timeline.{r}.json.clock.json").read_text())
        paths.append(str(src))
    ours = trace_tool.analyze(trace_tool.load_traces(paths), top=3)
    theirs = jax_trace.analyze(
        jax_trace.load_traces([str(tmp_path / "x.{rank}.json")]), top=3)
    assert ours["groups_scored"] > 0
    assert ours == theirs
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    trace_tool.merge_traces(trace_tool.load_traces(paths), str(a))
    jax_trace.merge_traces(jax_trace.load_traces(paths), str(b))
    assert json.loads(a.read_text()) == json.loads(b.read_text())


def test_cli_options_match_jax():
    """The same subcommands, positional arguments and flags as JAX's."""
    from _torch_tools_workers import cli_options
    ours = cli_options(trace_tool._main, ["report", "x"])
    assert ours and ours == cli_options(jax_trace._main, ["report", "x"])
