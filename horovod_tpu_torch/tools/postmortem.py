"""Post-mortem diagnosis CLI over flight-recorder dumps
(docs/postmortem.md): the port's copy of
``horovod_tpu/tools/postmortem.py``, whose reports it gives on the same
files.

``horovod_tpu_torch/observability/flight_recorder.py`` leaves one
``blackbox-rank{rank}.jsonl`` per rank in the HOROVOD_TPU_BLACKBOX
directory when a rank crashes, is SIGTERMed, escalates a stall, or is
evicted. Each dump is a clock header (carrying the
``offset_to_rank0_us`` fields from the control-plane handshake)
followed by the last N seconds of structured events. This tool merges
the per-rank dumps onto rank 0's clock — the same alignment
``tools/trace`` applies to per-rank timelines — and answers the 3am
questions:

  - What was the LAST fused collective group each rank completed?
  - Where did the fleet DIVERGE — the first group sequence number not
    completed by every rank?
  - Which rank died (or stalled) FIRST, and in which phase (inside a
    collective, mid-step in compute/input, at a fault injection)?
  - What was the adaptation ladder doing at the time of death?
  - Did the NUMBERS go bad before the process did — the first
    nonfinite (step, rank) and any cross-rank divergence fingerprint
    mismatches the numerics plane recorded (docs/numerics.md)?

Usage::

    python -m horovod_tpu_torch.tools.postmortem /path/to/blackbox-dir
    python -m horovod_tpu_torch.tools.postmortem blackbox-rank*.jsonl --json out.json

Tolerant by construction: a dump truncated mid-line (the writer was
killed while dumping) parses up to the torn tail; a rank with no dump
at all (SIGKILL, kernel panic, host loss) is reported as missing and
becomes primary evidence — the ranks that could not say goodbye are
usually the ones that died hardest.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Dict, List, Optional, Tuple

_DUMP_GLOB = "blackbox-rank*.jsonl"
_RANK_RE = re.compile(r"blackbox-rank(-?\d+)\.jsonl$")

# Dump reasons ordered by how strongly they indicate the ORIGIN of the
# failure (vs collateral damage): a rank that dumped at an injected
# crash died by construction; "exception"/"stall_escalation" mean the
# failure surfaced there; "sigterm" is usually the driver reaping
# survivors after someone else died; "inflight" means the rank was
# hard-killed with no final gasp — its file is the last periodic
# snapshot (handled as wordless-death evidence in the cascade, like a
# missing dump); "exit" is a clean shutdown.
_REASON_BLAME = {"fault_crash": 3, "stall_escalation": 2, "exception": 1,
                 "eviction": 1, "sigterm": 0, "inflight": 0, "exit": 0}


class RankDump:
    """One rank's parsed blackbox file."""

    def __init__(self, path: str, header: dict, events: List[dict],
                 truncated: bool):
        self.path = path
        self.header = header
        self.events = events
        self.truncated = truncated
        m = _RANK_RE.search(os.path.basename(path))
        self.rank = int(header.get("rank",
                                   m.group(1) if m else -1))

    @property
    def offset_us(self) -> float:
        return float(self.header.get("offset_to_rank0_us", 0.0))

    @property
    def clock_synced(self) -> bool:
        return bool(self.header.get("clock_synced", False))

    def aligned_us(self, event: dict) -> float:
        """Event time in rank-0's monotonic domain (microseconds)."""
        return float(event.get("t_us", 0)) + self.offset_us


def load_dump(path: str) -> Optional[RankDump]:
    """Parse one dump, skipping undecodable lines (a killed writer
    leaves a valid-prefix JSONL with at most one torn tail line).
    Returns None when not even a header survives."""
    header: Optional[dict] = None
    events: List[dict] = []
    truncated = False
    try:
        with open(path, errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    truncated = True
                    continue
                if header is None and obj.get("blackbox"):
                    header = obj
                elif "kind" in obj:
                    events.append(obj)
    except OSError:
        return None
    if header is None:
        # Headerless (dump killed instantly): keep the events if any —
        # rank from the filename, zero clock offset.
        if not events:
            return None
        header = {}
        truncated = True
    return RankDump(path, header, events, truncated)


def discover(paths: List[str]) -> List[str]:
    """Expand a directory / glob / explicit file list into dump files."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, _DUMP_GLOB))))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        elif os.path.exists(p):
            out.append(p)
    if not out:
        raise FileNotFoundError(
            f"no blackbox dumps found under {paths} (expected "
            f"{_DUMP_GLOB} files — set HOROVOD_TPU_BLACKBOX / "
            "--blackbox-dir on the run)")
    return out


# --------------------------------------------------------------------------
# Analysis
# --------------------------------------------------------------------------

def _group_state(dump: RankDump) -> Tuple[Optional[int], Optional[int]]:
    """(last completed group seq, last delivered-but-not-completed seq)
    for one rank. Seqs may be None on dumps with no group traffic."""
    done = [e["seq"] for e in dump.events
            if e.get("kind") == "group_done" and e.get("seq") is not None]
    delivered = [e["seq"] for e in dump.events
                 if e.get("kind") == "group_deliver"
                 and e.get("seq") is not None]
    last_done = max(done) if done else None
    done_set = set(done)
    open_seqs = [s for s in delivered if s not in done_set]
    return last_done, (max(open_seqs) if open_seqs else None)


def _pipeline_state(dump: RankDump) -> Optional[dict]:
    """The most recently built pipeline program, if any — recorded at
    build time so an in-step death can be attributed to a schedule
    (docs/pipeline.md)."""
    for e in reversed(dump.events):
        if e.get("kind") == "pipeline":
            return e
    return None


def _death_phase(dump: RankDump) -> str:
    """Best-effort phase the rank was in when the dump fired, from the
    tail of its event stream."""
    last_done, open_seq = _group_state(dump)
    if open_seq is not None and (last_done is None or open_seq > last_done):
        return f"collective (group seq {open_seq} delivered, never " \
               "completed)"
    for e in reversed(dump.events):
        kind = e.get("kind")
        if kind == "fault":
            if str(e.get("fault")) == "crash":
                return (f"fault injection (crash at enqueue path, tick "
                        f"{e.get('tick')})")
            if str(e.get("fault")) == "replica_crash":
                return (f"fault injection (serving replica crash at "
                        f"decode tick {e.get('tick')})")
            break
        if kind == "serving":
            return (f"serving ({e.get('event')}, "
                    f"{e.get('active')} request(s) in flight)")
        if kind == "step_end":
            return f"between steps (step {e.get('idx')} completed)"
        if kind == "step":
            pipe = _pipeline_state(dump)
            inside = ""
            if pipe is not None:
                inside = (
                    f", inside a pipelined step (schedule "
                    f"{pipe.get('schedule')}, "
                    f"{pipe.get('warmup')}/{pipe.get('steady')}/"
                    f"{pipe.get('drain')} warmup/steady/drain ticks)")
            return (f"in-step (step {e.get('idx')} began, never "
                    f"finished — compute/input/comm submission{inside})")
        if kind in ("group_done", "group_deliver", "group_error",
                    "failure", "stall", "coord_error", "adapt",
                    "wire_epoch", "checkpoint", "elastic", "init"):
            break
    # Fall back on the last event kind / dump reason.
    if dump.events:
        return f"after {dump.events[-1].get('kind')}"
    return f"unknown (empty dump, reason {dump.header.get('reason')})"


def _inflight_requests(dump: RankDump) -> List[dict]:
    """Serving requests this replica was holding when the dump fired
    (docs/serving.md#request-tracing): replay the ``request`` lifecycle
    events — admit opens a request (phase ``prefill``), first_token
    moves it to ``decode``, evict/finish closes it. What remains open
    at the tail is exactly what the replica took down with it — the
    requests the router had to fail over."""
    state: Dict[str, str] = {}
    for e in dump.events:
        if e.get("kind") != "request":
            continue
        ev, trace = str(e.get("event")), str(e.get("trace"))
        if ev == "admit":
            state[trace] = "prefill"
        elif ev == "first_token":
            state[trace] = "decode"
        elif ev in ("evict", "finish"):
            state.pop(trace, None)
    return [{"trace": t, "phase": p} for t, p in state.items()]


def _data_cursor(dump: RankDump) -> Optional[dict]:
    """The last committed input-pipeline cursor this rank recorded
    (docs/data.md#exactly-once): where the loader will resume, and the
    first thing to compare across ranks when a resumed job's samples
    look wrong."""
    for e in reversed(dump.events):
        if e.get("kind") == "data" and \
                str(e.get("event")) == "cursor_commit":
            return {"epoch": e.get("epoch"), "offset": e.get("offset")}
    return None


def _numerics_evidence(dumps: List[RankDump]) -> Optional[dict]:
    """Numerics-plane evidence chain (docs/numerics.md#postmortem).

    In a NaN cascade every rank eventually reports nonfinite payloads —
    the poisoned gradient propagates through the next allreduce — so
    the ORIGIN is the numerically FIRST observation (lowest step, then
    earliest aligned time), not the loudest rank. Divergence rows come
    from rank 0's fingerprint comparisons: each names the leaf and the
    outvoted rank, which is the bitflip/corruption story in one line."""
    nonfinite: List[dict] = []
    divergence: List[dict] = []
    for d in dumps:
        for e in d.events:
            if e.get("kind") != "numerics":
                continue
            row = {"step": e.get("step"), "rank": e.get("who"),
                   "observed_by": d.rank,
                   "t_rank0_us": d.aligned_us(e)}
            if str(e.get("event")) == "nonfinite":
                row["elements"] = e.get("value")
                row["source"] = e.get("detail")
                nonfinite.append(row)
            elif str(e.get("event")) == "divergence":
                row["leaf"] = e.get("detail")
                divergence.append(row)
    if not nonfinite and not divergence:
        return None

    def _order(row: dict) -> Tuple[float, float]:
        # step -1 means "observed outside a numbered step" (e.g. a
        # collective payload scan) — order those by aligned time only.
        step = row.get("step")
        step = float(step) if isinstance(step, (int, float)) \
            and step >= 0 else float("inf")
        return (step, row["t_rank0_us"])

    nonfinite.sort(key=_order)
    divergence.sort(key=_order)
    return {
        "first_nonfinite": nonfinite[0] if nonfinite else None,
        "nonfinite_events": len(nonfinite),
        "nonfinite_ranks": sorted({r["rank"] for r in nonfinite
                                   if r.get("rank") is not None}),
        "divergence": divergence,
    }


def _blamed_ranks(dumps: List[RankDump]) -> Dict[int, int]:
    """Votes per rank from survivors' recorded failure events."""
    votes: Dict[int, int] = {}
    for d in dumps:
        for e in d.events:
            if e.get("kind") == "failure":
                r = int(e.get("rank", -1))
                if r >= 0:
                    votes[r] = votes.get(r, 0) + 1
    return votes


def analyze(dumps: List[RankDump]) -> dict:
    """The merged post-mortem report (see module docstring)."""
    dumps = sorted(dumps, key=lambda d: d.rank)
    world = max([d.header.get("world", 0) for d in dumps] + [0])
    present = {d.rank for d in dumps}
    missing = sorted(set(range(world)) - present) if world else []

    per_rank = {}
    death_t_us: Dict[int, float] = {}
    for d in dumps:
        last_done, open_seq = _group_state(d)
        t_dump = float(d.header.get("mono_us", 0)) + d.offset_us
        death_t_us[d.rank] = t_dump
        pipe = _pipeline_state(d)
        per_rank[str(d.rank)] = {
            "reason": d.header.get("reason"),
            "error": d.header.get("error"),
            "generation": d.header.get("generation", 0),
            "last_group_seq": last_done,
            "open_group_seq": open_seq,
            "death_phase": _death_phase(d),
            "pipeline_schedule": (pipe.get("schedule")
                                  if pipe is not None else None),
            "data_cursor": _data_cursor(d),
            "inflight_requests": _inflight_requests(d),
            "events": len(d.events),
            "truncated_dump": d.truncated,
            "clock_synced": d.clock_synced,
            "dump_t_rank0_us": t_dump,
        }

    # Divergence: the first group seq not completed by every dumped
    # rank, given at least one rank progressed past the common floor
    # (a step begun, a group delivered, or a later completion).
    last_seqs = {d.rank: _group_state(d)[0] for d in dumps}
    numeric = [s for s in last_seqs.values() if s is not None]
    first_divergent = None
    if numeric:
        floor = min(numeric)
        if any(s != floor for s in numeric):
            first_divergent = floor + 1
        else:
            # Everyone completed the same last seq: the job diverged at
            # the NEXT group iff some rank shows evidence of attempting
            # it (an open delivery or a step begun after the floor).
            for d in dumps:
                _, open_seq = _group_state(d)
                if open_seq is not None and open_seq > floor:
                    first_divergent = floor + 1
                    break
                # A step begun but never finished: the rank entered the
                # next iteration and stalled in the group after the
                # common floor.
                begun = [e.get("idx", -1) for e in d.events
                         if e.get("kind") == "step"]
                ended = [e.get("idx", -1) for e in d.events
                         if e.get("kind") == "step_end"]
                if begun and (not ended or max(begun) > max(ended)):
                    first_divergent = floor + 1
                    break

    # Who died first: injected-crash dumps and missing ranks are the
    # strongest evidence; then survivor failure-event consensus; then
    # the earliest dump on the aligned clock.
    votes = _blamed_ranks(dumps)
    died_first: Optional[int] = None
    died_how = None

    def _earliest(cands: List[RankDump]) -> RankDump:
        return min(cands,
                   key=lambda d: death_t_us.get(d.rank, float("inf")))

    crash_dumps = [d for d in dumps
                   if _REASON_BLAME.get(d.header.get("reason"), 0) >= 2]
    origin_dumps = [d for d in dumps
                    if _REASON_BLAME.get(d.header.get("reason"), 0) == 1]
    if crash_dumps:
        d = _earliest(crash_dumps)
        died_first, died_how = d.rank, d.header.get("reason")
    elif votes:
        died_first = max(votes, key=lambda r: votes[r])
        died_how = "blamed by survivor failure events"
    elif missing:
        died_first = missing[0]
        died_how = "no dump written (hard kill / host loss)"
    elif any(d.header.get("reason") == "inflight" for d in dumps):
        # Wordless death: the file is the last periodic snapshot — the
        # process never got a final gasp (SIGKILL / runtime LOG(FATAL)).
        d = _earliest([d for d in dumps
                       if d.header.get("reason") == "inflight"])
        died_first = d.rank
        died_how = "hard-killed (last dump is an in-flight snapshot)"
    elif origin_dumps:
        d = _earliest(origin_dumps)
        died_first, died_how = d.rank, d.header.get("reason")
    elif death_t_us:
        died_first = min(death_t_us, key=lambda r: death_t_us[r])
        died_how = per_rank[str(died_first)]["reason"]
    death_phase = (per_rank[str(died_first)]["death_phase"]
                   if died_first is not None
                   and str(died_first) in per_rank
                   else ("no dump — died without a final gasp"
                         if died_first is not None else None))

    # Adaptation ladder at death: rank 0 records the policy transitions;
    # replay them up to the death time.
    ladder = None
    rank0 = next((d for d in dumps if d.rank == 0), None)
    if rank0 is not None:
        cutoff = (min(death_t_us.values()) if death_t_us else None)
        tier, active, evicted = 0, [], []
        for e in rank0.events:
            if e.get("kind") != "adapt":
                continue
            if cutoff is not None and rank0.aligned_us(e) > cutoff + 1e6:
                break
            if e.get("action") == "escalate":
                if e.get("name") == "evict":
                    evicted.append(int(e.get("rank", -1)))
                else:
                    tier = int(e.get("tier", tier))
                    active.append(str(e.get("name")))
            elif e.get("action") == "deescalate":
                tier = int(e.get("tier", tier))
                if active:
                    active.pop()
        ladder = {"tier": tier, "active_tiers": active,
                  "evicted_ranks": evicted}

    unsynced = sorted(d.rank for d in dumps
                      if not d.clock_synced and d.rank != 0)
    return {
        "world": world,
        "ranks_dumped": sorted(present),
        "ranks_missing": missing,
        "per_rank": per_rank,
        "first_divergent_group_seq": first_divergent,
        "common_last_group_seq": (min(numeric) if numeric else None),
        "died_first": {"rank": died_first, "how": died_how,
                       "phase": death_phase},
        "failure_votes": {str(r): v for r, v in sorted(votes.items())},
        "adaptation_at_death": ladder,
        "numerics": _numerics_evidence(dumps),
        "clock_unsynced_ranks": unsynced,
    }


def format_report(report: dict) -> str:
    lines = [
        f"Post-mortem — world size {report['world']}, "
        f"{len(report['ranks_dumped'])} blackbox dump(s)"
        + (f", ranks with NO dump: {report['ranks_missing']}"
           if report["ranks_missing"] else ""),
        "",
        f"{'rank':>4}  {'reason':<18} {'last seq':>8}  death phase",
    ]
    for r in sorted(report["per_rank"], key=int):
        row = report["per_rank"][r]
        seq = row["last_group_seq"]
        lines.append(
            f"{r:>4}  {str(row['reason']):<18} "
            f"{('-' if seq is None else seq):>8}  {row['death_phase']}"
            + ("  [truncated dump]" if row["truncated_dump"] else ""))
    for r in report["ranks_missing"]:
        lines.append(f"{r:>4}  {'<no dump>':<18} {'-':>8}  "
                     "died without a final gasp (hard kill / host loss)")
    died = report["died_first"]
    lines.append("")
    if died["rank"] is not None:
        lines.append(
            f"Verdict: rank {died['rank']} went first ({died['how']}); "
            f"phase: {died['phase']}")
    if report["first_divergent_group_seq"] is not None:
        lines.append(
            f"First divergent group seq: "
            f"{report['first_divergent_group_seq']} (all dumped ranks "
            f"completed seq {report['common_last_group_seq']})")
    elif report["common_last_group_seq"] is not None:
        lines.append(
            f"No divergence recorded: every dumped rank stopped at "
            f"group seq {report['common_last_group_seq']}")
    num = report.get("numerics")
    if num:
        first = num.get("first_nonfinite")
        if first is not None:
            step = first.get("step")
            lines.append(
                "First nonfinite: "
                + (f"step {step}" if isinstance(step, (int, float))
                   and step >= 0 else "outside a numbered step")
                + f" on rank {first.get('rank')} "
                f"({first.get('elements')} element(s), source "
                f"{first.get('source')}); {num['nonfinite_events']} "
                f"nonfinite event(s) total across ranks "
                f"{num['nonfinite_ranks']}")
        for q in num.get("divergence", []):
            lines.append(
                f"Cross-rank divergence at step {q.get('step')}: rank "
                f"{q.get('rank')} disagrees on leaf {q.get('leaf')} "
                f"(fingerprint comparison on rank {q.get('observed_by')})")
    inflight = {r: row["inflight_requests"]
                for r, row in report["per_rank"].items()
                if row.get("inflight_requests")}
    for r, reqs in sorted(inflight.items(), key=lambda kv: int(kv[0])):
        lines.append(
            f"In-flight requests on rank {r} at death: " + ", ".join(
                f"{q['trace']} ({q['phase']})" for q in reqs))
    cursors = {r: row["data_cursor"]
               for r, row in report["per_rank"].items()
               if row.get("data_cursor")}
    if cursors:
        lines.append("Last committed data cursor per rank: " + "; ".join(
            f"rank {r}: epoch {c['epoch']} offset {c['offset']}"
            for r, c in sorted(cursors.items(), key=lambda kv: int(kv[0]))))
    ladder = report.get("adaptation_at_death")
    if ladder is not None:
        lines.append(
            f"Adaptation ladder at death: tier {ladder['tier']}"
            + (f" ({', '.join(ladder['active_tiers'])})"
               if ladder["active_tiers"] else " (baseline)")
            + (f"; evicted ranks: {ladder['evicted_ranks']}"
               if ladder["evicted_ranks"] else ""))
    if report["clock_unsynced_ranks"]:
        lines.append(
            "WARNING: clock offset unsynced for ranks "
            f"{report['clock_unsynced_ranks']} — their event times "
            "carry the raw inter-host clock skew.")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.postmortem",
        description="Merge per-rank flight-recorder dumps "
                    "(blackbox-rank{rank}.jsonl) onto rank 0's clock and "
                    "report who died first, in which phase, and where "
                    "the fleet diverged (docs/postmortem.md)")
    ap.add_argument("dumps", nargs="+",
                    help="blackbox directory, glob, or explicit dump "
                         "files")
    ap.add_argument("--json", default=None,
                    help="also write the report JSON here")
    args = ap.parse_args(argv)

    dumps = [d for d in (load_dump(p) for p in discover(args.dumps))
             if d is not None]
    if not dumps:
        raise SystemExit("no parseable blackbox dumps found")
    report = analyze(dumps)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
    print(format_report(report))
    return report


if __name__ == "__main__":  # pragma: no cover - thin CLI
    _main()
