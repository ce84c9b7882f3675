"""Goodput reporting: merge open-loop load results + fleet history
into goodput-vs-offered-load tables (docs/serving.md#slo). The port's
copy of ``horovod_tpu/tools/slo.py``, over the port's history reader and
loadgen, whose reports it gives on the same files.

::

    python -m horovod_tpu_torch.tools.slo BENCH_SLO.json
    python -m horovod_tpu_torch.tools.slo run_rps*.json --target-ttft-ms 500
    python -m horovod_tpu_torch.tools.slo BENCH_SLO.json --history /var/hist
    python -m horovod_tpu_torch.tools.slo BENCH_SLO.json --baseline old.json

Inputs are either ``BENCH_SLO.json`` (the ``--slo`` bench artifact —
its ``sweep`` arms ARE the table) or raw ``serving.loadgen`` run files
(``{"offered": .., "results": [...]}``, summarized here). The table
answers the question closed-loop benches structurally cannot: at what
offered load does goodput stop tracking offered load — the **knee**
where p99 TTFT crosses target and shed/violations absorb the rest.

``--history`` folds in the fleet history store: per-label
``hvdtpu_slo_*`` counters become per-replica goodput/violation deltas
over the recorded window, so a live fleet's trend sits next to the
bench table. ``--baseline`` A/Bs two reports and exits 3 when any
matching arm's goodput fraction regressed more than 10% — the same
gate-the-CI contract ``tools/health --baseline`` uses.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from ..observability import health as _health
from ..observability import history as _history
from ..serving import loadgen as _loadgen

# A sweep arm past this goodput fraction is "keeping up"; below it the
# fleet is shedding/violating its way through the offered load.
KNEE_GOODPUT_FRAC = 0.9


def _arm_from_run(name: str, run: dict,
                  offered_rps: Optional[float] = None) -> dict:
    """Normalize one loadgen run into a table arm."""
    summary = run.get("summary") or _loadgen.summarize(run)
    totals = summary["totals"]
    wall = float(run.get("wall_s") or 0.0)
    if offered_rps is None:
        offered_rps = run.get("offered_rps")
    if offered_rps is None and wall > 0:
        offered_rps = totals["offered"] / wall
    ttft = sorted(float(r["ttft_ms"]) for r in run.get("results", [])
                  if r.get("status") == "completed" and "ttft_ms" in r)
    return {
        "name": name,
        "offered_rps": round(float(offered_rps or 0.0), 3),
        "offered": totals["offered"],
        "dropped": totals["dropped"],
        "goodput": totals["goodput"],
        "goodput_frac": totals["goodput_frac"],
        "goodput_rps": round(totals["goodput"] / wall, 3)
        if wall > 0 else None,
        "ttft_p50_ms": round(_loadgen._percentile(ttft, 0.50), 3),
        "ttft_p99_ms": round(_loadgen._percentile(ttft, 0.99), 3),
        "tenants": summary["tenants"],
        **({"by_class": summary["by_class"]}
           if "by_class" in summary else {}),
    }


def load_arms(paths: List[str]) -> List[dict]:
    """Table arms from input files: a BENCH_SLO.json contributes every
    sweep arm; a raw loadgen run file contributes one."""
    arms: List[dict] = []
    for path in paths:
        with open(path) as f:
            doc = json.load(f)
        if "sweep" in doc:       # BENCH_SLO.json
            for name, arm in doc["sweep"].items():
                arm = dict(arm)
                arm.setdefault("name", name)
                arms.append(arm)
        elif "results" in doc:   # raw loadgen run
            name = doc.get("name") or path.rsplit("/", 1)[-1]
            arms.append(_arm_from_run(name, doc))
        else:
            raise ValueError(
                f"{path}: neither a BENCH_SLO.json (sweep) nor a "
                f"loadgen run (results)")
    arms.sort(key=lambda a: a.get("offered_rps") or 0.0)
    return arms


def find_knee(arms: List[dict],
              target_ttft_ms: Optional[float] = None
              ) -> Optional[dict]:
    """First arm (by offered load) where the fleet stops keeping up:
    goodput fraction under :data:`KNEE_GOODPUT_FRAC`, or p99 TTFT over
    the target."""
    for arm in arms:
        frac = arm.get("goodput_frac")
        p99 = arm.get("ttft_p99_ms")
        if frac is not None and frac < KNEE_GOODPUT_FRAC:
            return arm
        if (target_ttft_ms is not None and p99 is not None
                and p99 > target_ttft_ms):
            return arm
    return None


def violation_breakdown(arms: List[dict]) -> Dict[str, dict]:
    """Per-tenant rollup across every arm: offered / goodput /
    violations / shed."""
    out: Dict[str, dict] = {}
    for arm in arms:
        for name, t in (arm.get("tenants") or {}).items():
            agg = out.setdefault(name, {
                "offered": 0, "goodput": 0, "slo_violations": 0,
                "shed": 0})
            agg["offered"] += t.get("offered", 0)
            agg["goodput"] += t.get("goodput", 0)
            agg["slo_violations"] += t.get("slo_violations", 0)
            agg["shed"] += t.get("shed", 0)
    for agg in out.values():
        agg["goodput_frac"] = round(
            agg["goodput"] / agg["offered"], 4) if agg["offered"] \
            else 0.0
    return out


def class_breakdown(arms: List[dict]) -> Dict[str, dict]:
    """Per-priority-class rollup across every arm that carries a
    ``by_class`` section (docs/serving.md#qos) — empty when no arm was
    run with class-tagged tenants."""
    out: Dict[str, dict] = {}
    for arm in arms:
        for cls, t in (arm.get("by_class") or {}).items():
            agg = out.setdefault(cls, {
                "offered": 0, "goodput": 0, "slo_violations": 0,
                "shed": 0})
            agg["offered"] += t.get("offered", 0)
            agg["goodput"] += t.get("goodput", 0)
            agg["slo_violations"] += t.get("slo_violations", 0)
            agg["shed"] += t.get("shed", 0)
    for agg in out.values():
        agg["goodput_frac"] = round(
            agg["goodput"] / agg["offered"], 4) if agg["offered"] \
            else 0.0
    return out


def history_slo_summary(directory: str) -> List[dict]:
    """Per-label hvdtpu_slo_* rollup over the recorded window. The
    history plane stores counters as per-second rates under the bare
    series key — integrating rate x sample-gap recovers each label's
    goodput / violation totals; histogram ``|p99`` keeps its last
    value."""
    rows = []
    for hf in _history.load_history([directory]):
        totals: Dict[str, float] = {}
        for key, points in hf.series().items():
            fam, labels, suffix = _health.split_series_key(key)
            if not fam.startswith("hvdtpu_slo_"):
                continue
            short = fam[len("hvdtpu_slo_"):]
            name = f"{short}{{{labels}}}" if labels else short
            if suffix == "" and fam.endswith("_total"):
                # Counter rate series: Δt ≈ median sample gap (the
                # sampler's cadence is steady).
                ts = [t for t, _ in points]
                dt = 0.0
                if len(ts) >= 2:
                    gaps = sorted(b - a for a, b in zip(ts, ts[1:]))
                    dt = gaps[len(gaps) // 2]
                totals[name] = round(
                    sum(v for _, v in points) * dt, 1)
            elif suffix == "p99":
                totals[f"{name}|p99"] = points[-1][1]
        if totals:
            rows.append({"label": hf.label,
                         "replica": hf.meta.get("replica"),
                         "slo": totals})
    return rows


def compare_baseline(cur: List[dict], base: List[dict],
                     threshold: float = 0.10) -> dict:
    """A/B matching arms by name; a goodput-fraction drop beyond
    ``threshold`` (absolute) is a regression."""
    base_by = {a["name"]: a for a in base}
    regressions, improvements = [], []
    for arm in cur:
        b = base_by.get(arm["name"])
        if b is None or b.get("goodput_frac") is None \
                or arm.get("goodput_frac") is None:
            continue
        delta = arm["goodput_frac"] - b["goodput_frac"]
        row = {"name": arm["name"],
               "baseline_goodput_frac": b["goodput_frac"],
               "goodput_frac": arm["goodput_frac"],
               "delta": round(delta, 4)}
        if delta < -threshold:
            regressions.append(row)
        elif delta > threshold:
            improvements.append(row)
    return {"verdict": "regressed" if regressions else "ok",
            "regressions": regressions,
            "improvements": improvements}


def qos_sections(paths: List[str]) -> List[dict]:
    """The ``qos`` blocks of any BENCH_SLO.json inputs — the
    priority-plane bench arm (docs/serving.md#qos): interactive
    TTFT-inflation headline, shed/quota counts, scale events."""
    out = []
    for path in paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and isinstance(doc.get("qos"), dict):
            q = {"source": path, **doc["qos"]}
            # Summary counters the report prints: shed per arm (QoS
            # replay arms + the autoscale ladder) and scale decisions
            # by direction/why.
            shed = {}
            arms = [q.get("interactive_only"),
                    q.get("with_bulk_burst")]
            auto = q.get("autoscale")
            if isinstance(auto, dict):
                arms += list((auto.get("sweep") or {}).values())
            for arm in arms:
                if not isinstance(arm, dict):
                    continue
                n = sum(t.get("shed", 0) for t in
                        (arm.get("tenants") or {}).values())
                if n:
                    shed[arm.get("name", "?")] = n
            if shed:
                q["shed"] = shed
            if isinstance(auto, dict) and auto.get("scale_events"):
                counts = {}
                for e in auto["scale_events"]:
                    key = f"{e.get('direction')}/{e.get('why')}"
                    counts[key] = counts.get(key, 0) + 1
                q["scale_events"] = counts
            out.append(q)
    return out


def build_report(paths: List[str],
                 target_ttft_ms: Optional[float] = None,
                 history_dir: Optional[str] = None,
                 qos: bool = False) -> dict:
    arms = load_arms(paths)
    knee = find_knee(arms, target_ttft_ms)
    report = {
        "arms": arms,
        "knee": None if knee is None else {
            "name": knee["name"],
            "offered_rps": knee.get("offered_rps"),
            "goodput_frac": knee.get("goodput_frac"),
            "ttft_p99_ms": knee.get("ttft_p99_ms")},
        "target_ttft_ms": target_ttft_ms,
        "tenants": violation_breakdown(arms),
    }
    classes = class_breakdown(arms)
    if classes:
        report["classes"] = classes
    if qos:
        report["qos"] = qos_sections(paths)
    if history_dir:
        report["history"] = history_slo_summary(history_dir)
    return report


def format_report(report: dict) -> str:
    lines = ["Goodput vs offered load", "",
             f"{'arm':<18} {'rps':>7} {'offered':>8} {'goodput':>8} "
             f"{'frac':>6} {'p99 ttft':>9} {'dropped':>8}"]
    knee = (report.get("knee") or {}).get("name")
    for a in report["arms"]:
        mark = "  <-- knee" if a["name"] == knee else ""
        p99 = a.get("ttft_p99_ms")
        lines.append(
            f"{a['name']:<18} {a.get('offered_rps') or 0:>7.2f} "
            f"{a['offered']:>8} {a['goodput']:>8} "
            f"{a.get('goodput_frac') or 0:>6.1%} "
            f"{(f'{p99:.0f}ms' if p99 is not None else '-'):>9} "
            f"{a.get('dropped', 0):>8}{mark}")
    if report.get("target_ttft_ms") is not None:
        lines.append(f"(target TTFT {report['target_ttft_ms']} ms)")
    if knee is None:
        lines.append("no knee: goodput tracked offered load on "
                     "every arm")
    lines += ["", "Per-tenant:",
              f"{'tenant':<16} {'offered':>8} {'goodput':>8} "
              f"{'frac':>6} {'violations':>10} {'shed':>6}"]
    for name, t in sorted(report["tenants"].items()):
        lines.append(
            f"{name:<16} {t['offered']:>8} {t['goodput']:>8} "
            f"{t['goodput_frac']:>6.1%} {t['slo_violations']:>10} "
            f"{t['shed']:>6}")
    if report.get("classes"):
        lines += ["", "Per-class (docs/serving.md#qos):",
                  f"{'class':<16} {'offered':>8} {'goodput':>8} "
                  f"{'frac':>6} {'violations':>10} {'shed':>6}"]
        for name, t in sorted(report["classes"].items()):
            lines.append(
                f"{name:<16} {t['offered']:>8} {t['goodput']:>8} "
                f"{t['goodput_frac']:>6.1%} {t['slo_violations']:>10} "
                f"{t['shed']:>6}")
    for q in report.get("qos") or []:
        lines.append("")
        lines.append(f"QoS arm [{q.get('source', '-')}]")
        for key in ("interactive_p99_inflation_qos",
                    "interactive_p99_inflation_baseline",
                    "reserved_slots", "schedule_checksum"):
            if key in q:
                lines.append(f"  {key:<36} {q[key]}")
        for key in ("shed", "scale_events"):
            if isinstance(q.get(key), dict):
                for k, v in sorted(q[key].items()):
                    lines.append(f"  {key}.{k:<30} {v}")
    for row in report.get("history", []):
        lines.append("")
        lines.append(f"History [{row['label']}]"
                     + (f" replica {row['replica']}"
                        if row.get("replica") is not None else ""))
        for name, v in sorted(row["slo"].items()):
            lines.append(f"  {name:<48} {v}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.slo",
        description="Goodput-vs-offered-load report over open-loop "
                    "load results and the fleet history store "
                    "(docs/serving.md#slo)")
    ap.add_argument("results", nargs="+",
                    help="BENCH_SLO.json and/or loadgen run JSON "
                         "files")
    ap.add_argument("--target-ttft-ms", type=float, default=None,
                    help="TTFT target for knee detection")
    ap.add_argument("--history", default=None,
                    help="fleet history directory to fold in")
    ap.add_argument("--qos", action="store_true",
                    help="include the QoS sections of BENCH_SLO.json "
                         "inputs (priority-plane headlines, shed and "
                         "scale-event counts; docs/serving.md#qos)")
    ap.add_argument("--baseline", default=None,
                    help="baseline report/bench JSON to A/B against "
                         "(exit 3 on goodput regression)")
    ap.add_argument("--json", default=None,
                    help="also write the report JSON here")
    args = ap.parse_args(argv)

    report = build_report(args.results,
                          target_ttft_ms=args.target_ttft_ms,
                          history_dir=args.history, qos=args.qos)
    rc = 0
    if args.baseline:
        base = load_arms([args.baseline])
        ab = compare_baseline(report["arms"], base)
        report["baseline"] = ab
        if ab["verdict"] == "regressed":
            rc = 3
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
    print(format_report(report))
    if args.baseline:
        ab = report["baseline"]
        print()
        print(f"Baseline verdict: {ab['verdict']}")
        for r in ab["regressions"]:
            print(f"  REGRESSED {r['name']}: "
                  f"{r['baseline_goodput_frac']:.1%} -> "
                  f"{r['goodput_frac']:.1%}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
