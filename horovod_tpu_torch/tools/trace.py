"""Cross-rank trace merge + critical-path analysis CLI (docs/tracing.md):
the port's copy of ``horovod_tpu/tools/trace.py``. It reads the port's
timelines and the JAX package's alike: a span counts as "execute" when
its name starts with ``NCCL_`` or ``GLOO_`` (the port's engine, after
reference Horovod) or ``XLA_`` (the JAX engine's), where JAX's tool
counts ``XLA_`` alone and so finds no execute time in a port timeline.
On every other input its reports are JAX's.

The capture side (``HOROVOD_TPU_TIMELINE`` with a ``{rank}``
placeholder) leaves one catapult JSON per rank, each on its OWN clock:
event ``ts`` are microseconds since that rank's writer start, and the
trace clock header records the writer's monotonic epoch plus the rank's
estimated offset to rank 0 (the NTP-style control-plane handshake,
ops/control_plane.ClockProbeRequest). This tool puts the N files back
on one clock and answers the question the single-rank timeline cannot:
*which rank is slowing the job down, and in which phase?*

  merge   — one Perfetto/catapult trace: one trace "process" per rank,
            tensors as named threads, timestamps realigned through the
            recorded offsets.
  report  — per-fused-group critical path: for every coordinator group,
            which rank's NEGOTIATE tick arrived last; per-rank lateness
            distributions (p50/p90/p99 through the same log-bucket
            estimator as the live Prometheus plane,
            observability.histogram_percentiles); a ranked straggler
            table with the phase each rank loses time in
            (negotiate/queue/h2d/execute — or "upstream" when the skew
            originates before the collective path, i.e. compute/input).
  serving — per-REQUEST latency-budget report over serving request
            traces (docs/serving.md#request-tracing): the router and
            every replica each write one catapult file
            (serving/reqtrace.py) whose rows are trace ids; this
            subcommand groups each request's spans across ALL the
            processes it touched and reports where its latency went
            (queue / prefill / decode / failover shares of the
            measured wall), the slowest requests, and failover chains
            with the re-prefill cost on the resume replica.

Usage::

    python -m horovod_tpu_torch.tools.trace merge /tmp/trace.{rank}.json \
        -o merged.json --report report.json
    python -m horovod_tpu_torch.tools.trace report /tmp/trace.*.json
    python -m horovod_tpu_torch.tools.trace serving /tmp/reqtrace-dir \
        --report budget.json

Groups are keyed by the coordinator sequence number the Python writer
records on each NEGOTIATE span — identical on every rank for the
same fused collective. Traces without group ids (the native C++ writer)
fall back to per-tensor occurrence pairing, which holds as long as
every rank executed the same collectives in the same order (the SPMD
contract the coordinator enforces anyway).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import bisect
import math

from ..observability.export import histogram_percentiles
from ..observability.registry import LATENCY_BUCKETS
from ..ops.timeline_py import (TRACE_META_EVENT, clock_sidecar_path,
                               load_timeline)

PHASES = ("negotiate", "queue", "h2d", "execute", "input", "compute")

# Verdict buckets (docs/tracing.md): which phases mean the rank is
# losing time to communication, to the input pipeline, or to compute.
_BUCKET_OF = {"negotiate": "comm", "queue": "comm", "execute": "comm",
              "h2d": "input", "input": "input", "compute": "compute"}
_VERDICT_OF = {"comm": "comm-bound", "input": "input-bound",
               "compute": "compute-bound"}

_PHASE_OF = {"QUEUE": "queue", "MEMCPY_IN_FUSION_BUFFER": "h2d",
             # StepTimer's per-step attribution spans (docs/metrics.md):
             # emitted on the "_step" pseudo-process when a shim
             # StepTimer runs next to the Python timeline writer.
             "STEP_INPUT": "input", "STEP_H2D": "h2d",
             "STEP_COMPUTE": "compute"}


# The activity prefixes of a fused group's execution: the port's engine
# writes NCCL_<OP> or GLOO_<OP> (reference Horovod's names), the JAX
# engine XLA_<OP> (and XLA_STEP for a compiled step's bracket, which is
# not a collective).
_EXECUTE_PREFIXES = ("NCCL_", "GLOO_", "XLA_")


def _phase_of(name: str) -> Optional[str]:
    if name.startswith("NEGOTIATE_"):
        return "negotiate"
    if name.startswith(_EXECUTE_PREFIXES) and name != "XLA_STEP":
        return "execute"
    return _PHASE_OF.get(name)


# --------------------------------------------------------------------------
# Loading
# --------------------------------------------------------------------------

class RankTrace:
    """One rank's capture: raw events, pid→tensor names, clock meta."""

    def __init__(self, path: str, events: List[dict], meta: dict):
        self.path = path
        self.events = events
        self.meta = meta
        self.rank = meta.get("rank")
        # Serving request-trace writers name their process ("router",
        # "replica1/gen0") instead of speaking in ranks.
        self.proc = meta.get("proc")
        self.tensor_of: Dict[int, str] = {
            e["pid"]: str(e["args"]["name"]) for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"
            and "pid" in e and e.get("args", {}).get("name") is not None}

    @property
    def shift_us(self) -> float:
        """Local trace ts → rank-0 monotonic microseconds."""
        return (float(self.meta.get("start_mono_us", 0))
                + float(self.meta.get("offset_to_rank0_us", 0.0)))

    @property
    def clock_missing(self) -> bool:
        """No clock metadata at all (neither in-band nor sidecar) —
        alignment degraded to zero offset."""
        return not self.meta


def _read_meta(path: str, events: List[dict]) -> dict:
    """Clock metadata: the LAST in-trace meta event (a sync supersedes
    the unsynced header) or the sidecar; empty dict when neither exists
    (offset 0 — single-host captures still merge correctly since all
    writers share one monotonic clock only if starts are recorded, so a
    missing header degrades alignment to per-file-relative time).

    A missing or corrupt ``.clock.json`` sidecar must DEGRADE, not fail
    the whole merge: the native writer's sidecar is easily lost when
    only the trace files are copied off the pod, and N-1 good traces
    are still worth aligning. The fallback is zero offset, flagged so
    the report header can warn."""
    meta: dict = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == TRACE_META_EVENT:
            meta = dict(e.get("args") or {})
    if not meta:
        sidecar = clock_sidecar_path(path)
        try:
            if os.path.exists(sidecar):
                with open(sidecar) as f:
                    meta = json.load(f)
                if not isinstance(meta, dict):
                    meta = {}
        except (OSError, ValueError):
            meta = {}
    return meta


def load_rank_trace(path: str) -> RankTrace:
    events = load_timeline(path)
    return RankTrace(path, events, _read_meta(path, events))


def expand_inputs(paths: List[str]) -> List[str]:
    """A single ``{rank}`` template expands to consecutive existing
    files starting at rank 0; a single directory expands to its
    ``*.trace.json`` captures (the serving request-trace layout —
    one file per router/replica process)."""
    if len(paths) == 1 and os.path.isdir(paths[0]):
        out = sorted(glob.glob(os.path.join(paths[0], "*.trace.json")))
        if not out:
            raise FileNotFoundError(
                f"no *.trace.json captures under {paths[0]}")
        return out
    if len(paths) == 1 and "{rank}" in paths[0]:
        out = []
        rank = 0
        while True:
            p = paths[0].replace("{rank}", str(rank))
            if not os.path.exists(p):
                break
            out.append(p)
            rank += 1
        if not out:
            raise FileNotFoundError(
                f"no trace files match template {paths[0]}")
        return out
    return list(paths)


def load_traces(paths: List[str]) -> List[RankTrace]:
    traces = [load_rank_trace(p) for p in expand_inputs(paths)]
    # Rank identity from the clock header; positional fallback for
    # headerless files, collision = operator error (two copies of one
    # rank's file would silently halve every lateness).
    seen = set()
    for i, t in enumerate(traces):
        if t.rank is None:
            t.rank = i
        if t.rank in seen:
            raise ValueError(
                f"duplicate rank {t.rank} among inputs ({t.path})")
        seen.add(t.rank)
    traces.sort(key=lambda t: t.rank)
    return traces


# --------------------------------------------------------------------------
# Merge
# --------------------------------------------------------------------------

def merge_traces(traces: List[RankTrace], out_path: str) -> str:
    """One Perfetto/catapult file: pid = rank, tid = interned tensor,
    timestamps realigned via each trace's recorded clock shift and
    rebased so the earliest event sits at 0."""
    shifts = {t.rank: t.shift_us for t in traces}
    base = None
    for t in traces:
        for e in t.events:
            if e.get("ph") in ("M", None) or "ts" not in e:
                continue
            at = e["ts"] + shifts[t.rank]
            base = at if base is None else min(base, at)
    base = base or 0.0
    merged: List[dict] = []
    for t in traces:
        merged.append({"name": "process_name", "ph": "M", "pid": t.rank,
                       "args": {"name": t.proc or f"rank {t.rank}"}})
        merged.append({"name": "process_sort_index", "ph": "M",
                       "pid": t.rank, "args": {"sort_index": t.rank}})
        tids: Dict[int, int] = {}
        for pid, tensor in t.tensor_of.items():
            tids[pid] = len(tids)
            merged.append({"name": "thread_name", "ph": "M", "pid": t.rank,
                           "tid": tids[pid], "args": {"name": tensor}})
        for e in t.events:
            if e.get("ph") == "M":
                continue  # re-interned above (incl. the clock header)
            ev = dict(e)
            ev["pid"] = t.rank
            ev["tid"] = tids.setdefault(e.get("pid", 0),
                                        len(tids))
            if "ts" in ev:
                ev["ts"] = int(ev["ts"] + shifts[t.rank] - base)
            if ev.get("s") == "g":
                # A cycle marker is per-rank state; in the merged view a
                # global-scope instant would draw across ALL ranks.
                ev["s"] = "p"
            merged.append(ev)
    with open(out_path, "w") as f:
        json.dump(merged, f)
    return out_path


# --------------------------------------------------------------------------
# Analysis
# --------------------------------------------------------------------------

def _spans(events: List[dict]) -> List[dict]:
    """Pair B/E (and accept X) into spans per (pid, tid). Tolerates
    truncated captures: unmatched closers are dropped, unclosed openers
    are skipped — exactly what a killed writer leaves behind."""
    stacks: Dict[Tuple, List[dict]] = {}
    spans: List[dict] = []
    for e in events:
        ph = e.get("ph")
        key = (e.get("pid"), e.get("tid", 0))
        if ph == "B":
            stacks.setdefault(key, []).append(e)
        elif ph == "E":
            st = stacks.get(key)
            if not st:
                continue
            b = st.pop()
            args = dict(b.get("args") or {})
            args.update(e.get("args") or {})
            spans.append({"pid": key[0], "name": b.get("name", ""),
                          "ts": b.get("ts", 0),
                          "dur": max(0, e.get("ts", 0) - b.get("ts", 0)),
                          "args": args})
        elif ph == "X":
            spans.append({"pid": key[0], "name": e.get("name", ""),
                          "ts": e.get("ts", 0),
                          "dur": int(e.get("dur", 0)),
                          "args": dict(e.get("args") or {})})
    return spans


def _arrivals(trace: RankTrace) -> Dict[str, float]:
    """Per-group arrival microseconds in the rank-0 clock domain.
    Arrival of a group on a rank = the LAST member tensor's NEGOTIATE
    start (the group cannot be agreed before the rank's final
    announce); groups keyed by the recorded coordinator seq, falling
    back to per-tensor occurrence index."""
    shift = trace.shift_us
    occurrence: Dict[str, int] = {}
    arrivals: Dict[str, float] = {}
    for s in _spans(trace.events):
        if not s["name"].startswith("NEGOTIATE_"):
            continue
        tensor = trace.tensor_of.get(s["pid"], str(s["pid"]))
        if tensor.startswith(("jit::", "_cycles", "_step")):
            continue
        group = s["args"].get("group")
        if group is not None:
            key = f"g{int(group)}"
        else:
            k = occurrence.get(tensor, 0)
            occurrence[tensor] = k + 1
            key = f"{tensor}#{k}"
        at = s["ts"] + shift
        arrivals[key] = max(arrivals.get(key, at), at)
    return arrivals


def _phase_stats(trace: RankTrace
                 ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(mean span duration, total seconds) per lifecycle phase on this
    rank — one pass over the spans. Totals feed the bucket shares the
    bound-verdict is computed from; means feed the fleet-median
    deviation attribution."""
    sums = {p: 0.0 for p in PHASES}
    counts = {p: 0 for p in PHASES}
    for s in _spans(trace.events):
        phase = _phase_of(s["name"])
        if phase is None:
            continue
        sums[phase] += s["dur"] / 1e6
        counts[phase] += 1
    means = {p: (sums[p] / counts[p] if counts[p] else 0.0)
             for p in PHASES}
    return means, sums


def _hist_snapshot(samples: List[float]) -> dict:
    """Registry-format histogram snapshot of raw samples over the live
    plane's LATENCY_BUCKETS — feeds the same percentile estimator, so
    offline and Prometheus numbers agree to within one bucket width."""
    counts = [0] * (len(LATENCY_BUCKETS) + 1)
    for v in samples:
        counts[bisect.bisect_left(LATENCY_BUCKETS, v)] += 1
    out = []
    cum = 0
    for le, c in zip(LATENCY_BUCKETS, counts[:-1]):
        cum += c
        out.append([le, cum])
    out.append([math.inf, cum + counts[-1]])
    return {"buckets": out, "sum": float(sum(samples)),
            "count": len(samples)}


def analyze(traces: List[RankTrace], top: int = 0) -> dict:
    """The straggler report (see module docstring). ``top`` limits the
    per-group critical-path listing (0 = omit raw groups)."""
    ranks = [t.rank for t in traces]
    arrivals_by_rank = {t.rank: _arrivals(t) for t in traces}
    common = set.intersection(*(set(a) for a in arrivals_by_rank.values())) \
        if traces else set()
    lateness: Dict[int, List[float]] = {r: [] for r in ranks}
    last_count: Dict[int, int] = {r: 0 for r in ranks}
    group_rows = []
    for key in sorted(common,
                      key=lambda k: min(arrivals_by_rank[r][k]
                                        for r in ranks)):
        arr = {r: arrivals_by_rank[r][key] for r in ranks}
        t0 = min(arr.values())
        critical = max(arr, key=lambda r: arr[r])
        last_count[critical] += 1
        for r in ranks:
            lateness[r].append((arr[r] - t0) / 1e6)
        group_rows.append({
            "group": key, "critical_rank": critical,
            "lateness_s": round((arr[critical] - t0) / 1e6, 6)})
    stats = {t.rank: _phase_stats(t) for t in traces}
    phase_means = {r: stats[r][0] for r in ranks}
    phase_totals = {r: stats[r][1] for r in ranks}
    # Lower median: with an even rank count the upper median would let a
    # single slow rank set its own baseline and mask itself.
    fleet_median = {
        p: sorted(phase_means[r][p] for r in ranks)[(len(ranks) - 1) // 2]
        for p in PHASES}
    per_rank = {}
    bucket_fleet = {"input": 0.0, "compute": 0.0, "comm": 0.0}
    any_step_spans = False
    for r in ranks:
        samples = lateness[r]
        # Same estimator as the live hvdtpu_negotiate_lateness_seconds
        # plane: route samples through the identical log-bucket layout
        # (independent of the runtime metrics flag — this is an offline
        # tool).
        pct = histogram_percentiles(_hist_snapshot(samples),
                                    qs=(0.5, 0.9, 0.99))
        mean = sum(samples) / len(samples) if samples else 0.0
        dev = {p: phase_means[r][p] - fleet_median[p] for p in PHASES}
        worst_phase = max(PHASES, key=lambda p: dev[p])
        # When no collective-path phase explains the skew, the rank is
        # late ARRIVING — the time is lost upstream (compute, input
        # pipeline, host scheduling), not inside the engine.
        loses_in = (worst_phase
                    if dev[worst_phase] > max(1e-6, 0.1 * mean)
                    else "upstream(compute/input)")
        # Bound verdict (docs/tracing.md): where does this rank's time
        # GO, in absolute terms? With StepTimer step spans in the trace
        # the input/compute buckets are real and the shares over
        # input+compute+comm decide; without them the deviation-based
        # attribution is the only evidence (a uniformly slow input
        # pipeline is invisible to deviation — instrument the loop with
        # a StepTimer to expose it).
        totals = phase_totals[r]
        bucket = {"input": totals["input"] + totals["h2d"],
                  "compute": totals["compute"],
                  "comm": (totals["negotiate"] + totals["queue"]
                           + totals["execute"])}
        has_step = (totals["input"] + totals["compute"]) > 0
        bucket_total = sum(bucket.values())
        shares = {b: (v / bucket_total if bucket_total > 0 else 0.0)
                  for b, v in bucket.items()}
        if has_step:
            any_step_spans = True
            for b, v in bucket.items():
                bucket_fleet[b] += v
            verdict = _VERDICT_OF[max(bucket, key=bucket.get)]
        elif loses_in.startswith("upstream"):
            verdict = "upstream(compute/input)"
        else:
            verdict = _VERDICT_OF[_BUCKET_OF[loses_in]]
        per_rank[str(r)] = {
            "groups": len(samples),
            "groups_last": last_count[r],
            "lateness": {
                "p50_s": round(pct.get("p50", 0.0), 6),
                "p90_s": round(pct.get("p90", 0.0), 6),
                "p99_s": round(pct.get("p99", 0.0), 6),
                "mean_s": round(mean, 6),
                "max_s": round(max(samples), 6) if samples else 0.0,
            },
            "phase_mean_s": {p: round(phase_means[r][p], 6)
                             for p in PHASES},
            "phase_share": {b: round(shares[b], 4) for b in shares},
            "loses_most_in": loses_in,
            "verdict": verdict,
        }
    order = sorted(ranks,
                   key=lambda r: (per_rank[str(r)]["lateness"]["p50_s"],
                                  per_rank[str(r)]["lateness"]["mean_s"],
                                  per_rank[str(r)]["groups_last"]),
                   reverse=True)
    stragglers = [{"rank": r, **per_rank[str(r)]["lateness"],
                   "groups_last": per_rank[str(r)]["groups_last"],
                   "loses_most_in": per_rank[str(r)]["loses_most_in"],
                   "verdict": per_rank[str(r)]["verdict"]}
                  for r in order]
    # Run-level bound verdict: the fleet's dominant cost bucket. Only
    # meaningful when step spans exist — without input/compute data the
    # trace ONLY contains collective spans and "comm" would win
    # vacuously.
    fleet_total = sum(bucket_fleet.values())
    bound = (_VERDICT_OF[max(bucket_fleet, key=bucket_fleet.get)]
             if any_step_spans and fleet_total > 0 else None)
    report = {
        "ranks": ranks,
        "groups_scored": len(common),
        "clock": {str(t.rank): {
            "offset_to_rank0_us": float(
                t.meta.get("offset_to_rank0_us", 0.0)),
            "rtt_us": float(t.meta.get("rtt_us", 0.0)),
            "synced": bool(t.meta.get("clock_synced", False)),
            "meta_missing": t.clock_missing,
        } for t in traces},
        "per_rank": per_rank,
        "stragglers": stragglers,
        "top_straggler": stragglers[0] if stragglers else None,
        "bound": bound,
        "fleet_share": ({b: round(v / fleet_total, 4)
                         for b, v in bucket_fleet.items()}
                        if fleet_total > 0 else None),
    }
    if top:
        worst = sorted(group_rows, key=lambda g: -g["lateness_s"])[:top]
        report["worst_groups"] = worst
    return report


def format_report(report: dict) -> str:
    """Human-readable rendering of :func:`analyze`'s JSON."""
    header = (f"Cross-rank trace report — {len(report['ranks'])} ranks, "
              f"{report['groups_scored']} fused groups scored")
    if report.get("bound"):
        fs = report.get("fleet_share") or {}
        header += (f"; run verdict: {report['bound']}"
                   + (f" (input {fs.get('input', 0):.0%} / compute "
                      f"{fs.get('compute', 0):.0%} / comm "
                      f"{fs.get('comm', 0):.0%})" if fs else ""))
    lines = [header]
    missing = [r for r, c in report["clock"].items()
               if c.get("meta_missing")]
    if missing:
        lines.append(
            "WARNING: no clock metadata (.clock.json sidecar or in-band "
            f"header) for ranks {', '.join(sorted(missing))} — zero-"
            "offset fallback; their timestamps carry the raw inter-host "
            "clock skew.")
    lines += [
        "",
        f"{'rank':>4}  {'p50 late':>10}  {'p99 late':>10}  "
        f"{'mean':>10}  {'last-in':>8}  {'verdict':<14} loses most in",
    ]
    for s in report["stragglers"]:
        lines.append(
            f"{s['rank']:>4}  {s['p50_s'] * 1e3:>8.2f}ms  "
            f"{s['p99_s'] * 1e3:>8.2f}ms  {s['mean_s'] * 1e3:>8.2f}ms  "
            f"{s['groups_last']:>8}  {s['verdict']:<14} "
            f"{s['loses_most_in']}")
    top = report.get("top_straggler")
    if top and top["mean_s"] > 0:
        lines += ["", f"Top straggler: rank {top['rank']} "
                      f"(p50 lateness {top['p50_s'] * 1e3:.2f} ms, "
                      f"last to arrive in {top['groups_last']} of "
                      f"{report['groups_scored']} groups; "
                      f"loses time in: {top['loses_most_in']}; "
                      f"verdict: {top['verdict']})"]
    unsynced = [r for r, c in report["clock"].items()
                if not c["synced"] and r != "0"
                and not c.get("meta_missing")]
    if unsynced:
        lines += ["", "WARNING: clock offset unsynced for ranks "
                      f"{', '.join(unsynced)} — lateness numbers for "
                      "them carry the raw inter-host clock skew."]
    return "\n".join(lines)


# --------------------------------------------------------------------------
# Serving request-trace analysis (docs/serving.md#request-tracing)
# --------------------------------------------------------------------------

# Span name → latency-budget phase. FAILOVER is handled separately: its
# detection→resume window OVERLAPS the resume replica's queue/prefill
# spans (the re-dispatch is what ends it), so only the time not already
# attributed to a concrete phase counts as "failover" — the budget then
# partitions instead of double-counting.
_REQ_PHASE_OF = {"QUEUE_WAIT": "queue", "PREFILL": "prefill",
                 "DECODE": "decode", "EGRESS": "egress"}
REQ_PHASES = ("queue", "prefill", "decode", "failover", "egress")


def _union(ivs: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge possibly-overlapping intervals into a sorted disjoint set."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(ivs):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _total(ivs: List[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in ivs)


def _subtract(ivs: List[Tuple[float, float]],
              cover: List[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """``ivs`` minus ``cover`` (both disjoint-sorted)."""
    out: List[Tuple[float, float]] = []
    for a, b in ivs:
        cur = a
        for ca, cb in cover:
            if cb <= cur or ca >= b:
                continue
            if ca > cur:
                out.append((cur, ca))
            cur = max(cur, cb)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


def serving_report(traces: List[RankTrace], top: int = 10) -> dict:
    """Per-request latency-budget report over serving request traces:
    each request's spans are gathered ACROSS processes by its trace id
    (the row name every writer uses), aligned onto one clock, and
    attributed to queue / prefill / decode / failover (/ egress)
    phases. ``attributed_frac`` is the budget's share of the measured
    wall — the acceptance bar is that it explains the wall to within
    10% for a failed-over request."""
    rows: Dict[str, dict] = {}
    for t in traces:
        shift = t.shift_us
        pname = t.proc or f"rank {t.rank}"
        for s in _spans(t.events):
            tid = t.tensor_of.get(s["pid"])
            if tid is None:
                continue
            rec = rows.setdefault(tid, {"spans": [], "procs": set()})
            rec["procs"].add(pname)
            rec["spans"].append({
                "name": s["name"], "t0": s["ts"] + shift,
                "t1": s["ts"] + shift + s["dur"], "dur": s["dur"],
                "args": s["args"], "proc": pname})
    requests: Dict[str, dict] = {}
    for tid, rec in rows.items():
        spans = sorted(rec["spans"], key=lambda x: x["t0"])
        request = next((x for x in spans if x["name"] == "REQUEST"),
                       None)
        # The wall: the router's REQUEST span when present (the client-
        # observed latency), span extremes otherwise (engine-only
        # captures).
        if request is not None:
            t0, t1 = request["t0"], request["t1"]
        else:
            t0 = min(x["t0"] for x in spans)
            t1 = max(x["t1"] for x in spans)
        wall_us = max(0.0, t1 - t0)
        ivs: Dict[str, List[Tuple[float, float]]] = {
            p: [] for p in ("queue", "prefill", "decode", "egress")}
        failover_spans = []
        for x in spans:
            ph = _REQ_PHASE_OF.get(x["name"])
            if ph is not None:
                ivs[ph].append((x["t0"], x["t1"]))
            elif x["name"] == "FAILOVER":
                failover_spans.append(x)
        unions = {p: _union(v) for p, v in ivs.items()}
        phase_us = {p: _total(u) for p, u in unions.items()}
        covered = _union([iv for u in unions.values() for iv in u])
        fo_union = _union([(x["t0"], x["t1"]) for x in failover_spans])
        phase_us["failover"] = _total(_subtract(fo_union, covered))
        attributed = sum(phase_us[p]
                         for p in ("queue", "prefill", "decode",
                                   "failover"))
        failovers = []
        for x in failover_spans:
            # The failover chain: detection → resume, plus the
            # re-prefill it forced on the replacement replica (the
            # first PREFILL starting inside/after the window).
            reprefill = next(
                (p for p in spans if p["name"] == "PREFILL"
                 and p["t0"] >= x["t0"]), None)
            failovers.append({
                "phase": x["args"].get("phase"),
                "from_replica": x["args"].get("from"),
                "to_replica": x["args"].get("to"),
                "detect_to_resume_ms": round(x["dur"] / 1e3, 3),
                "reprefill_ms": (round(reprefill["dur"] / 1e3, 3)
                                 if reprefill else None),
                "reprefill_tokens": (reprefill["args"].get("tokens")
                                     if reprefill else None),
                "reprefill_proc": (reprefill["proc"]
                                   if reprefill else None),
            })
        # Tenant + SLO verdict ride the span args: the router stamps
        # REQUEST, the replica's egress stamps EGRESS — either names
        # the tenant, and slo_met is the judged verdict
        # (docs/serving.md#slo).
        tenant = None
        slo_met = None
        for x in ([request] if request is not None else []) + [
                s for s in spans if s["name"] == "EGRESS"]:
            if tenant is None:
                tenant = x["args"].get("tenant")
            if slo_met is None:
                slo_met = x["args"].get("slo_met")
        requests[tid] = {
            "wall_ms": round(wall_us / 1e3, 3),
            "processes": sorted(rec["procs"]),
            "tenant": tenant,
            "slo_met": slo_met,
            "spans": len(spans),
            "phase_ms": {p: round(phase_us.get(p, 0.0) / 1e3, 3)
                         for p in REQ_PHASES},
            "phase_share": {p: (round(phase_us.get(p, 0.0) / wall_us, 4)
                                if wall_us > 0 else 0.0)
                            for p in REQ_PHASES},
            "attributed_frac": (round(attributed / wall_us, 4)
                                if wall_us > 0 else 0.0),
            "failovers": failovers,
        }
    slowest = sorted(requests,
                     key=lambda k: -requests[k]["wall_ms"])[:top]
    return {
        "n_requests": len(requests),
        "processes": sorted({p for r in requests.values()
                             for p in r["processes"]}),
        "requests": requests,
        "slowest": [{"trace": k, "wall_ms": requests[k]["wall_ms"],
                     "phase_share": requests[k]["phase_share"],
                     "tenant": requests[k]["tenant"],
                     "slo_met": requests[k]["slo_met"],
                     "failovers": len(requests[k]["failovers"])}
                    for k in slowest],
        "n_failovers": sum(len(r["failovers"])
                           for r in requests.values()),
    }


def format_serving_report(report: dict) -> str:
    """Human-readable per-request budget table, slowest first."""
    lines = [
        f"Serving request-trace report — {report['n_requests']} "
        f"request(s) across {len(report['processes'])} process(es) "
        f"({', '.join(report['processes'])}), "
        f"{report['n_failovers']} failover(s)",
        "",
        f"{'trace id':<20}  {'wall':>9}  {'queue':>6} {'prefil':>6} "
        f"{'decode':>6} {'failov':>6}  {'attrib':>6}  {'slo':>4}  "
        f"procs",
    ]
    for row in report["slowest"]:
        r = report["requests"][row["trace"]]
        sh = r["phase_share"]
        slo = ("-" if r.get("slo_met") is None
               else "met" if r["slo_met"] else "MISS")
        lines.append(
            f"{row['trace']:<20}  {r['wall_ms']:>7.1f}ms  "
            f"{sh['queue']:>6.1%} {sh['prefill']:>6.1%} "
            f"{sh['decode']:>6.1%} {sh['failover']:>6.1%}  "
            f"{r['attributed_frac']:>6.1%}  {slo:>4}  "
            f"{len(r['processes'])}"
            + (f"  tenant={r['tenant']}" if r.get("tenant") else "")
            + ("  [failover]" if r["failovers"] else ""))
    chains = [(tid, f) for tid, r in report["requests"].items()
              for f in r["failovers"]]
    if chains:
        lines.append("")
        for tid, f in chains:
            lines.append(
                f"Failover: {tid} — {f['phase']} on replica "
                f"{f['from_replica']} → {f['to_replica']}; detection→"
                f"resume {f['detect_to_resume_ms']} ms"
                + (f", re-prefill {f['reprefill_tokens']} tokens in "
                   f"{f['reprefill_ms']} ms on {f['reprefill_proc']}"
                   if f["reprefill_ms"] is not None else ""))
    return "\n".join(lines)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.trace",
        description="Merge per-rank horovod_tpu_torch timeline captures into "
                    "one clock-aligned Perfetto trace and report the "
                    "per-group critical path / straggler attribution")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_merge = sub.add_parser(
        "merge", help="merge + analyze (writes the merged trace)")
    p_report = sub.add_parser("report", help="analyze only")
    p_serving = sub.add_parser(
        "serving", help="per-request latency-budget report over "
                        "serving request traces "
                        "(docs/serving.md#request-tracing)")
    for p in (p_merge, p_report, p_serving):
        p.add_argument("traces", nargs="+",
                       help="per-process trace files, ONE path template "
                            "containing {rank}, or ONE directory of "
                            "*.trace.json captures")
        p.add_argument("--report", default=None,
                       help="also write the report JSON here")
        p.add_argument("--top", type=int, default=10,
                       help="include the N worst groups/requests in "
                            "the JSON")
    p_merge.add_argument("-o", "--out", default=None,
                         help="merged trace path (default: "
                              "<first input>.merged.json)")
    args = ap.parse_args(argv)

    traces = load_traces(args.traces)
    if args.cmd == "merge":
        out = args.out or expand_inputs(args.traces)[0] + ".merged.json"
        merge_traces(traces, out)
        print(f"merged trace: {out}")
    if args.cmd == "serving":
        report = serving_report(traces, top=args.top)
        fmt = format_serving_report(report)
    else:
        report = analyze(traces, top=args.top)
        fmt = format_report(report)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
    print(fmt)


if __name__ == "__main__":  # pragma: no cover - thin CLI
    _main()
