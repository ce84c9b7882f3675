"""The port's postmortem CLI (``horovod_tpu_torch/tools/postmortem.py``)
against JAX's: every case of ``tests/test_postmortem_tool.py`` on the
same synthetic per-rank dumps (truncated dumps, missing ranks, clock
skew, the adaptation ladder, the CLI), and a parity case that feeds the
same files, JAX's synthetic fixtures and the dumps a 2-rank gloo run of
the port wrote (rank 1 crashing at an enqueue tick), to both tools'
``analyze`` and ``format_report``: the dicts and the text are equal."""

import json

import pytest

from horovod_tpu.tools import postmortem as jax_postmortem
from horovod_tpu_torch.tools import postmortem

US = 1_000_000  # µs per second


def _write_dump(path, rank, world, events, *, reason="sigterm",
                offset_us=0.0, synced=True, mono_us=100 * US,
                generation=0, error=None):
    """One blackbox file the way FlightRecorder.dump lays it out."""
    header = {"blackbox": 1, "rank": rank, "world": world,
              "generation": generation, "reason": reason, "error": error,
              "time_unix": 1700000000.0, "mono_us": mono_us,
              "window_s": 120.0, "events": len(events),
              "offset_to_rank0_us": offset_us, "rtt_us": 40.0,
              "clock_synced": synced}
    lines = [json.dumps(header)]
    lines += [json.dumps(e) for e in events]
    path.write_text("\n".join(lines) + "\n")
    return path


def _groups(n, t0_us=0, step_us=10000, extra_open=None):
    """n completed groups (deliver+done), optionally one delivered-but-
    never-completed seq after them."""
    out = []
    for s in range(n):
        t = t0_us + s * step_us
        out.append({"t_us": t, "kind": "group_deliver", "seq": s,
                    "op": "allreduce", "n": 4})
        out.append({"t_us": t + 2000, "kind": "group_done", "seq": s,
                    "op": "allreduce", "n": 4, "queue_ms": 0.1,
                    "exec_ms": 1.5})
    if extra_open is not None:
        out.append({"t_us": t0_us + n * step_us, "kind": "group_deliver",
                    "seq": extra_open, "op": "allreduce", "n": 4})
    return out


class TestLoader:
    def test_truncated_dump_parses_valid_prefix(self, tmp_path):
        p = _write_dump(tmp_path / "blackbox-rank0.jsonl", 0, 2,
                        _groups(3))
        # Kill mid-line: append a torn JSON line.
        with open(p, "a") as f:
            f.write('{"t_us": 999, "kind": "group_del')
        dump = postmortem.load_dump(str(p))
        assert dump.rank == 0
        assert len(dump.events) == 6
        assert dump.truncated is True

    def test_headerless_dump_uses_filename_rank(self, tmp_path):
        p = tmp_path / "blackbox-rank7.jsonl"
        p.write_text(json.dumps(
            {"t_us": 1, "kind": "step", "idx": 0}) + "\n")
        dump = postmortem.load_dump(str(p))
        assert dump.rank == 7
        assert dump.truncated is True

    def test_empty_file_returns_none(self, tmp_path):
        p = tmp_path / "blackbox-rank0.jsonl"
        p.write_text("")
        assert postmortem.load_dump(str(p)) is None

    def test_discover_directory_and_missing(self, tmp_path):
        _write_dump(tmp_path / "blackbox-rank0.jsonl", 0, 1, _groups(1))
        assert len(postmortem.discover([str(tmp_path)])) == 1
        with pytest.raises(FileNotFoundError):
            postmortem.discover([str(tmp_path / "nope")])


class TestAnalysis:
    def test_crashed_rank_named_with_phase_and_divergence(self, tmp_path):
        """Rank 1 dumped at an injected crash after 5 groups; ranks 0/2/3
        were SIGTERMed later with a 6th group begun but never completed.
        The verdict must name rank 1, its death phase, and seq 5 as the
        divergence point."""
        world = 4
        for r in (0, 2, 3):
            events = _groups(6 if False else 5, extra_open=5)
            events.append({"t_us": 60000, "kind": "step", "idx": 5})
            events.append({"t_us": 65000, "kind": "failure", "rank": 1,
                           "failure_kind": "heartbeat_timeout",
                           "detail": "rank 1 gone"})
            _write_dump(tmp_path / f"blackbox-rank{r}.jsonl", r, world,
                        events, reason="sigterm", mono_us=200 * US)
        crash_events = _groups(5)
        crash_events.append({"t_us": 52000, "kind": "fault",
                             "fault": "crash", "tick": 5})
        _write_dump(tmp_path / "blackbox-rank1.jsonl", 1, world,
                    crash_events, reason="fault_crash",
                    mono_us=150 * US)

        dumps = [postmortem.load_dump(str(tmp_path / f))
                 for f in sorted(p.name for p in tmp_path.iterdir())]
        report = postmortem.analyze([d for d in dumps if d])
        assert report["world"] == 4
        assert report["ranks_missing"] == []
        assert report["died_first"]["rank"] == 1
        assert report["died_first"]["how"] == "fault_crash"
        assert "fault injection" in report["died_first"]["phase"]
        assert report["common_last_group_seq"] == 4
        assert report["first_divergent_group_seq"] == 5
        # Survivor evidence recorded too.
        assert report["failure_votes"] == {"1": 3}
        text = postmortem.format_report(report)
        assert "rank 1 went first" in text
        assert "First divergent group seq: 5" in text

    def test_missing_rank_is_primary_suspect(self, tmp_path):
        """No dump at all from rank 2 (hard SIGKILL): the report names
        it from absence + survivor votes."""
        world = 3
        for r in (0, 1):
            _write_dump(tmp_path / f"blackbox-rank{r}.jsonl", r, world,
                        _groups(4), reason="sigterm")
        dumps = [postmortem.load_dump(str(p))
                 for p in sorted(tmp_path.iterdir())]
        report = postmortem.analyze(dumps)
        assert report["ranks_missing"] == [2]
        assert report["died_first"]["rank"] == 2
        assert "no dump" in report["died_first"]["how"]
        text = postmortem.format_report(report)
        assert "died without a final gasp" in text

    def test_divergent_last_seqs(self, tmp_path):
        """Ranks stopped at different completed seqs: divergence is the
        floor + 1."""
        _write_dump(tmp_path / "blackbox-rank0.jsonl", 0, 2, _groups(8))
        _write_dump(tmp_path / "blackbox-rank1.jsonl", 1, 2, _groups(5),
                    reason="exception", error="RuntimeError: boom")
        dumps = [postmortem.load_dump(str(p))
                 for p in sorted(tmp_path.iterdir())]
        report = postmortem.analyze(dumps)
        assert report["common_last_group_seq"] == 5 - 1
        assert report["first_divergent_group_seq"] == 5
        # exception beats sigterm as origin evidence
        assert report["died_first"]["rank"] == 1

    def test_no_divergence_when_everyone_stopped_clean(self, tmp_path):
        for r in range(2):
            _write_dump(tmp_path / f"blackbox-rank{r}.jsonl", r, 2,
                        _groups(3), reason="sigterm")
        dumps = [postmortem.load_dump(str(p))
                 for p in sorted(tmp_path.iterdir())]
        report = postmortem.analyze(dumps)
        assert report["first_divergent_group_seq"] is None
        assert "No divergence recorded" in postmortem.format_report(report)

    def test_clock_alignment_orders_deaths(self, tmp_path):
        """Rank 1's local clock is 50 s behind rank 0's; with the
        recorded offset its (later) local dump time still lands AFTER
        rank 0's on the aligned clock, so rank 0 died first."""
        _write_dump(tmp_path / "blackbox-rank0.jsonl", 0, 2, _groups(2),
                    reason="sigterm", mono_us=100 * US)
        _write_dump(tmp_path / "blackbox-rank1.jsonl", 1, 2, _groups(2),
                    reason="sigterm", mono_us=60 * US,
                    offset_us=50.0 * US)
        dumps = [postmortem.load_dump(str(p))
                 for p in sorted(tmp_path.iterdir())]
        report = postmortem.analyze(dumps)
        assert report["died_first"]["rank"] == 0

    def test_adaptation_ladder_replayed(self, tmp_path):
        events = _groups(3)
        events.append({"t_us": 5000, "kind": "adapt",
                       "action": "escalate", "tier": 1, "name": "shrink",
                       "rank": 2, "lateness_ms": 120.0})
        events.append({"t_us": 15000, "kind": "adapt",
                       "action": "escalate", "tier": 2, "name": "bf16",
                       "rank": 2, "lateness_ms": 130.0})
        events.append({"t_us": 25000, "kind": "adapt",
                       "action": "escalate", "tier": 2, "name": "evict",
                       "rank": 2, "lateness_ms": 140.0})
        _write_dump(tmp_path / "blackbox-rank0.jsonl", 0, 2, events,
                    reason="eviction")
        _write_dump(tmp_path / "blackbox-rank1.jsonl", 1, 2, _groups(3),
                    reason="sigterm")
        dumps = [postmortem.load_dump(str(p))
                 for p in sorted(tmp_path.iterdir())]
        report = postmortem.analyze(dumps)
        ladder = report["adaptation_at_death"]
        assert ladder["tier"] == 2
        assert ladder["active_tiers"] == ["shrink", "bf16"]
        assert ladder["evicted_ranks"] == [2]
        assert "tier 2 (shrink, bf16)" in postmortem.format_report(report)


class TestCli:
    def test_cli_on_directory_writes_json(self, tmp_path, capsys):
        for r in range(2):
            _write_dump(tmp_path / f"blackbox-rank{r}.jsonl", r, 2,
                        _groups(3), reason="sigterm")
        out = tmp_path / "report.json"
        postmortem._main([str(tmp_path), "--json", str(out)])
        printed = capsys.readouterr().out
        assert "Post-mortem — world size 2" in printed
        report = json.loads(out.read_text())
        assert report["ranks_dumped"] == [0, 1]

    def test_cli_tolerates_truncated_input(self, tmp_path, capsys):
        p = _write_dump(tmp_path / "blackbox-rank0.jsonl", 0, 1,
                        _groups(2))
        with open(p, "a") as f:
            f.write('{"torn')
        postmortem._main([str(tmp_path)])
        assert "truncated dump" in capsys.readouterr().out


# --------------------------------------------------------------------------
# Parity with JAX's tool on the same files
# --------------------------------------------------------------------------

def _synthetic_crash(d):
    for r in (0, 2, 3):
        events = _groups(5, extra_open=5)
        events.append({"t_us": 60000, "kind": "step", "idx": 5})
        events.append({"t_us": 65000, "kind": "failure", "rank": 1,
                       "failure_kind": "heartbeat_timeout",
                       "detail": "rank 1 gone"})
        _write_dump(d / f"blackbox-rank{r}.jsonl", r, 4, events,
                    mono_us=200 * US)
    events = _groups(5)
    events.append({"t_us": 52000, "kind": "fault", "fault": "crash",
                   "tick": 5})
    _write_dump(d / "blackbox-rank1.jsonl", 1, 4, events,
                reason="fault_crash", mono_us=150 * US)


def _synthetic_missing(d):
    for r in (0, 1):
        _write_dump(d / f"blackbox-rank{r}.jsonl", r, 3, _groups(4))


def _synthetic_skew_ladder_torn(d):
    events = _groups(3)
    events.append({"t_us": 5000, "kind": "adapt", "action": "escalate",
                   "tier": 1, "name": "shrink", "rank": 2})
    events.append({"t_us": 9000, "kind": "numerics", "event": "nonfinite",
                   "step": 2, "who": 1, "value": 3, "detail": "grad"})
    events.append({"t_us": 9500, "kind": "request", "event": "admit",
                   "trace": "req-a"})
    events.append({"t_us": 9600, "kind": "data", "event": "cursor_commit",
                   "epoch": 1, "offset": 64})
    _write_dump(d / "blackbox-rank0.jsonl", 0, 2, events,
                reason="exception", error="RuntimeError: boom")
    p = _write_dump(d / "blackbox-rank1.jsonl", 1, 2, _groups(2),
                    mono_us=60 * US, offset_us=50.0 * US, synced=False)
    with open(p, "a") as f:
        f.write('{"t_us": 1, "kind": "gro')


SYNTHETIC = {"crash": _synthetic_crash, "missing": _synthetic_missing,
             "skew_ladder_torn": _synthetic_skew_ladder_torn}


def _assert_same_report(directory):
    ours = postmortem.analyze(
        [postmortem.load_dump(p) for p in postmortem.discover([directory])])
    theirs = jax_postmortem.analyze(
        [jax_postmortem.load_dump(p)
         for p in jax_postmortem.discover([directory])])
    assert ours == theirs
    assert postmortem.format_report(ours) == \
        jax_postmortem.format_report(theirs)
    return ours


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_parity_on_synthetic_dumps(tmp_path, case):
    SYNTHETIC[case](tmp_path)
    _assert_same_report(str(tmp_path))


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    import _torch_tools_workers as workers
    out = tmp_path_factory.mktemp("gloo_tools")
    codes = workers.run(str(out))
    return out, codes


def test_parity_on_a_gloo_run_of_the_port(gloo_run):
    """Rank 1 of a 2-rank gloo job dies at its ``crash_at`` tick (the
    injector's final gasp, then SIGKILL); rank 0's engine fails on the
    closed pair and it exits. Both tools name rank 1, the fault and the
    group after the last one both ranks completed."""
    out, codes = gloo_run
    assert codes[1] == -9
    report = _assert_same_report(str(out / "bb"))
    assert report["died_first"]["rank"] == 1
    assert report["died_first"]["how"] == "fault_crash"
    assert "fault injection" in report["died_first"]["phase"]
    assert report["first_divergent_group_seq"] == \
        report["common_last_group_seq"] + 1


def test_cli_options_match_jax():
    """The same positional arguments and flags as JAX's CLI."""
    from _torch_tools_workers import cli_options
    ours = cli_options(postmortem._main, ["x"])
    assert ours and ours == cli_options(jax_postmortem._main, ["x"])
