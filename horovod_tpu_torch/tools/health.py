"""Fleet health report over merged telemetry history files: the port's
copy of ``horovod_tpu/tools/health.py``, over the port's history reader
and detectors, whose reports it gives on the same files.

``python -m horovod_tpu_torch.tools.health <dir-or-files...>`` merges the
per-rank / per-replica history files the sampler writes
(``history-rank{N}.jsonl`` + rotated segments, docs/health.md),
realigns them onto rank 0's clock via each segment's header offset,
and renders:

  - per-metric **sparkline trends** for the headline series (step
    time, MFU, HBM live, collective share, queue depths) plus any
    series a detector fired on;
  - **detector verdicts** — the SAME detector plane the live sampler
    runs (observability/health.py, offline mode) replayed over each
    label's samples, with the window that tripped each alert;
  - a **top-regressions-since-t0 ranking**: first-quartile vs
    last-quartile medians per series, direction-aware (a rising step
    time and a falling MFU are both regressions);
  - ``--baseline other_dir/`` **A/B mode**: steady-state medians of
    two runs diffed series-by-series — the seed of perf-regression CI
    (two identical runs report no regressions; an injected slowdown
    ranks its series on top).

``--json`` emits the full report dict for scripting/tests.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from typing import Dict, List, Optional, Tuple

from ..observability import health as _health
from ..observability import history as _history

SPARK_BLOCKS = "▁▂▃▄▅▆▇█"

# Headline series always worth a sparkline when present (suffix-aware
# key matching; anything a detector fires on is added dynamically).
KEY_SERIES_FAMILIES = (
    "hvdtpu_step_seconds",
    "hvdtpu_mfu",
    "hvdtpu_hbm_bytes_in_use",
    "hvdtpu_collective_step_share",
    "hvdtpu_samples_per_second",
    "hvdtpu_serving_queue_depth",
    "hvdtpu_fleet_replica_queue_depth",
    "hvdtpu_serving_requests_per_second",
    "hvdtpu_slo_goodput_total",
    "hvdtpu_slo_violations_total",
    "hvdtpu_serving_shed_total",
    "hvdtpu_fleet_scale_events_total",
    "hvdtpu_fleet_target_replicas",
    # Numerics plane (docs/numerics.md): grad norm and loss trend
    # lines are the first thing to eyeball after a NaN page, and the
    # nonfinite counter's sparkline shows when the cascade started.
    "hvdtpu_numerics_grad_norm",
    "hvdtpu_numerics_loss",
    "hvdtpu_numerics_update_ratio",
    "hvdtpu_numerics_nonfinite_total",
)

# Direction-aware regression semantics: which way is WORSE.
# _DOWN_WORSE is checked first, so "goodput" wins over the "_total"
# suffix a counter family carries.
_UP_WORSE = ("seconds", "queue_depth", "bytes_in_use", "share",
             "lateness", "restarts_total", "failures_total",
             "errors_total", "stalled", "blocked", "violations",
             "shed", "scale_events", "nonfinite", "ef_residual",
             "skipped_steps")
_DOWN_WORSE = ("mfu", "per_second", "replicas_live", "replicas_ready",
               "acceptance", "goodput")


def _direction(series_key: str) -> int:
    """+1: up is worse; -1: down is worse; 0: not ranked."""
    fam, _, _ = _health.split_series_key(series_key)
    for marker in _DOWN_WORSE:
        if marker in fam:
            return -1
    for marker in _UP_WORSE:
        if marker in fam:
            return 1
    return 0


def sparkline(values: List[float], width: int = 40) -> str:
    """Resample to ``width`` columns and render unicode blocks."""
    if not values:
        return ""
    if len(values) > width:
        # Mean-pool into width buckets (trend display, not archival).
        step = len(values) / width
        pooled = []
        for i in range(width):
            chunk = values[int(i * step): max(int((i + 1) * step),
                                              int(i * step) + 1)]
            pooled.append(sum(chunk) / len(chunk))
        values = pooled
    lo, hi = min(values), max(values)
    if not math.isfinite(lo) or not math.isfinite(hi):
        return ""
    span = hi - lo
    if span <= 0:
        return SPARK_BLOCKS[0] * len(values)
    return "".join(
        SPARK_BLOCKS[min(len(SPARK_BLOCKS) - 1,
                         int((v - lo) / span * len(SPARK_BLOCKS)))]
        for v in values)


def _median(xs: List[float]) -> float:
    return statistics.median(xs) if xs else 0.0


def _mad(xs: List[float], center: float) -> float:
    return _median([abs(x - center) for x in xs])


def _quartile_change(points: List[Tuple[float, float]]
                     ) -> Optional[Tuple[float, float]]:
    """(first-quartile median, last-quartile median) over a time
    series — None with too few samples, or when the change does not
    dominate the series' own noise (a microsecond-scale jitter series
    can triple and still mean nothing; the gate is the same
    signal-vs-residual principle the online detectors use)."""
    if len(points) < 4:
        return None
    n = max(1, len(points) // 4)
    first = [v for _, v in points[:n]]
    last = [v for _, v in points[-n:]]
    base, recent = _median(first), _median(last)
    noise = max(_mad(first, base), _mad(last, recent))
    if abs(recent - base) <= 3.0 * noise:
        return None
    return base, recent


def _regression_score(base: float, recent: float, direction: int
                      ) -> float:
    """Signed relative change vs BASELINE, positive = got worse — the
    standard "% regression" semantics (a 20% slowdown scores +0.20 on
    step time and only −16.7% → +0.167 on its inverse, samples/sec, so
    the causal series outranks its derived mirror). A series appearing
    from a ~zero baseline is scored against its recent value instead
    (bounded at 1) so it cannot take over the ranking on a division
    artifact."""
    denom = abs(base) if abs(base) > 1e-12 else max(abs(recent), 1e-12)
    return direction * (recent - base) / denom


# --------------------------------------------------------------------------
# Single-run analysis
# --------------------------------------------------------------------------

def analyze(files: List[_history.HistoryFile], top: int = 10) -> dict:
    """The report dict: labels, detector verdicts, regressions ranking,
    sparklines."""
    labels = []
    alerts: List[dict] = []
    regressions: List[dict] = []
    sparks: Dict[str, Dict[str, dict]] = {}
    alerted_series: Dict[str, set] = {}

    for hf in files:
        series = hf.series()
        span = 0.0
        ts = [s.get("t_aligned_us", s.get("t_us", 0))
              for s in hf.samples]
        if len(ts) >= 2:
            span = (max(ts) - min(ts)) / 1e6
        labels.append({
            "label": hf.label,
            "rank": hf.meta.get("rank"),
            "replica": hf.meta.get("replica"),
            "generation": hf.meta.get("generation"),
            "samples": len(hf.samples),
            "span_s": round(span, 1),
            "clock_synced": bool(hf.meta.get("clock_synced", False)),
        })

        # Detector verdicts: replay the live plane offline, per label.
        monitor = _health.HealthMonitor(
            emit=False,
            rank=hf.meta.get("rank", -1)
            if hf.meta.get("rank") is not None else -1,
            replica=hf.meta.get("replica", -1)
            if hf.meta.get("replica") is not None else -1,
            refire_s=float("inf"))  # one verdict per (kind, series)
        for s in hf.samples:
            vals = {k: v for k, v in (s.get("s") or {}).items()
                    if v is not None}
            if not vals:
                continue
            t = s.get("t_aligned_us", s.get("t_us", 0)) / 1e6
            monitor.observe(vals, t=t, t_unix=s.get("u", 0.0))
        for a in monitor.alerts:
            d = a.to_dict()
            d["label"] = hf.label
            alerts.append(d)
            alerted_series.setdefault(hf.label, set()).add(a.series)

        # Regressions since t0, direction-aware.
        for key, points in series.items():
            direction = _direction(key)
            if direction == 0:
                continue
            qc = _quartile_change(points)
            if qc is None:
                continue
            base, recent = qc
            score = _regression_score(base, recent, direction)
            if score > 0.02:   # ignore noise-level drift
                regressions.append({
                    "label": hf.label, "series": key,
                    "baseline": base, "recent": recent,
                    "change_frac": round(score, 4),
                    "direction": "up" if direction > 0 else "down"})

    regressions.sort(key=lambda r: -r["change_frac"])
    if top:
        regressions = regressions[:top]

    # Sparklines: headline families + whatever alerted.
    for hf in files:
        series = hf.series()
        want = alerted_series.get(hf.label, set())
        rows = {}
        for key, points in sorted(series.items()):
            fam, _, suffix = _health.split_series_key(key)
            headline = fam in KEY_SERIES_FAMILIES and suffix in ("",
                                                                "mean")
            if not headline and key not in want:
                continue
            vals = [v for _, v in points]
            if len(vals) < 2:
                continue
            rows[key] = {
                "spark": sparkline(vals),
                "min": min(vals), "max": max(vals),
                "last": vals[-1], "n": len(vals)}
        if rows:
            sparks[hf.label] = rows

    alerts.sort(key=lambda a: a.get("t_unix", 0.0))
    return {"labels": labels, "alerts": alerts,
            "top_regressions": regressions, "sparklines": sparks}


# --------------------------------------------------------------------------
# Baseline A/B
# --------------------------------------------------------------------------

def compare_baseline(cur: List[_history.HistoryFile],
                     base: List[_history.HistoryFile],
                     threshold: float = 0.10, top: int = 10) -> dict:
    """Steady-state (last-half median) diff of two runs, matched on
    (label, series); ``threshold`` is the relative change past which a
    series counts as a regression (identical runs sit at ~0)."""

    def steady(files) -> Dict[Tuple[str, str], Tuple[float, float]]:
        out = {}
        for hf in files:
            for key, points in hf.series().items():
                if len(points) < 2:
                    continue
                vals = [v for _, v in points[len(points) // 2:]]
                med = _median(vals)
                out[(hf.label, key)] = (med, _mad(vals, med))
        return out

    cur_v, base_v = steady(cur), steady(base)
    rows = []
    for k in sorted(set(cur_v) & set(base_v)):
        label, key = k
        direction = _direction(key)
        if direction == 0:
            continue
        (cv, c_mad), (bv, b_mad) = cur_v[k], base_v[k]
        # Significance gate: the A/B delta must dominate both runs'
        # own steady-state noise, or a jitter-scale series drowns the
        # ranking in meaningless triple-digit "regressions". Gated
        # series still count as compared — compared and found equal.
        score = _regression_score(bv, cv, direction)
        if abs(cv - bv) <= 3.0 * max(c_mad, b_mad):
            score = 0.0
        rows.append({"label": label, "series": key,
                     "baseline_value": bv,
                     "current_value": cv,
                     "change_frac": round(score, 4)})
    rows.sort(key=lambda r: -r["change_frac"])
    regressions = [r for r in rows if r["change_frac"] >= threshold]
    improvements = [r for r in rows
                    if r["change_frac"] <= -threshold]
    return {
        "threshold": threshold,
        "series_compared": len(rows),
        "regressions": regressions[:top] if top else regressions,
        "improvements": (sorted(improvements,
                                key=lambda r: r["change_frac"])[:top]
                         if top else improvements),
        "verdict": ("regressions" if regressions
                    else "no_regressions"),
    }


# --------------------------------------------------------------------------
# Rendering
# --------------------------------------------------------------------------

def _fmt_v(v: float) -> str:
    if abs(v) >= 1e9 or (0 < abs(v) < 1e-3):
        return f"{v:.3e}"
    return f"{v:.4g}"


def format_report(report: dict) -> str:
    lines = ["== horovod_tpu fleet health report =="]
    lines.append(f"{len(report['labels'])} history label(s):")
    for lab in report["labels"]:
        who = lab["label"]
        extra = []
        if lab.get("rank") is not None:
            extra.append(f"rank {lab['rank']}")
        if lab.get("replica") is not None:
            extra.append(f"replica {lab['replica']}")
        extra.append(f"{lab['samples']} samples")
        extra.append(f"{lab['span_s']:.0f}s span")
        if not lab.get("clock_synced"):
            extra.append("clock UNSYNCED")
        lines.append(f"  {who:<14} {', '.join(extra)}")

    lines.append("")
    lines.append("-- detector verdicts --")
    if not report["alerts"]:
        lines.append("  healthy: no detector fired on any label")
    for a in report["alerts"]:
        lines.append(
            f"  [{a['severity'].upper():>8}] {a['kind']} on "
            f"{a['label']}: {a['series']}")
        lines.append(
            f"             value {_fmt_v(a['value'])} vs baseline "
            f"{_fmt_v(a['baseline'])} over {a['window_s']:.0f}s window")

    lines.append("")
    lines.append("-- top regressions since t0 --")
    if not report["top_regressions"]:
        lines.append("  none above the noise floor")
    for i, r in enumerate(report["top_regressions"], 1):
        arrow = "↑" if r["direction"] == "up" else "↓"
        lines.append(
            f"  {i:>2}. {r['label']}: {r['series']} {arrow} "
            f"{r['change_frac'] * 100:+.1f}% "
            f"({_fmt_v(r['baseline'])} → {_fmt_v(r['recent'])})")

    if report.get("sparklines"):
        lines.append("")
        lines.append("-- trends --")
        for label, rows in sorted(report["sparklines"].items()):
            lines.append(f"  {label}:")
            for key, row in rows.items():
                lines.append(
                    f"    {key:<58} {row['spark']}  "
                    f"[{_fmt_v(row['min'])} .. {_fmt_v(row['max'])}] "
                    f"last {_fmt_v(row['last'])}")

    if "baseline" in report:
        b = report["baseline"]
        lines.append("")
        lines.append(f"-- baseline A/B ({b['series_compared']} series "
                     f"compared, threshold "
                     f"{b['threshold'] * 100:.0f}%) --")
        if b["verdict"] == "no_regressions":
            lines.append("  no regressions vs baseline")
        for i, r in enumerate(b["regressions"], 1):
            lines.append(
                f"  {i:>2}. REGRESSED {r['label']}: {r['series']} "
                f"{r['change_frac'] * 100:+.1f}% "
                f"({_fmt_v(r['baseline_value'])} → "
                f"{_fmt_v(r['current_value'])})")
        for r in b["improvements"]:
            lines.append(
                f"      improved  {r['label']}: {r['series']} "
                f"{r['change_frac'] * 100:+.1f}%")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.health",
        description="Merge per-rank/per-replica telemetry history "
                    "files and render a fleet health report "
                    "(docs/health.md)")
    ap.add_argument("inputs", nargs="+",
                    help="history directory (expands history-*.jsonl) "
                         "or explicit history files")
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="A/B mode: diff this run against another "
                         "run's history directory (perf-regression "
                         "CI seed)")
    ap.add_argument("--top", type=int, default=10,
                    help="rows in the regression rankings (default 10)")
    ap.add_argument("--threshold", type=float, default=0.10,
                    help="baseline-mode relative-change threshold "
                         "(default 0.10)")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON")
    args = ap.parse_args(argv)

    try:
        files = _history.load_history(args.inputs)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 2
    report = analyze(files, top=args.top)
    if args.baseline:
        try:
            base_files = _history.load_history([args.baseline])
        except FileNotFoundError as e:
            print(str(e), file=sys.stderr)
            return 2
        report["baseline"] = compare_baseline(
            files, base_files, threshold=args.threshold, top=args.top)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(format_report(report))
    if (args.baseline
            and report["baseline"]["verdict"] == "regressions"):
        # CI-shaped contract (docs/health.md#baseline): a baseline diff
        # that found regressions exits nonzero so a perf gate can be
        # one `health --baseline` invocation; 3 keeps it distinct from
        # argparse's 2 and the missing-input 2 above.
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(_main())
