"""Open-loop load generation for the serving fleet.

Counterpart of ``horovod_tpu/serving/loadgen.py``, copied unchanged: a
seed gives the same schedule, and the same :func:`schedule_checksum`,
in both packages. A seeded arrival process fires requests on schedule
whatever happened to the earlier ones, so offered load is an
independent variable and queueing collapse shows.

- :func:`build_schedule`: Poisson (``expovariate``) or constant-rate
  arrivals from ``random.Random(seed)``, each given a tenant from a
  weighted mix (:class:`TenantSpec`: prompt-length range, generation
  budget, optional SLO targets). :func:`save_schedule` and
  :func:`load_schedule` round-trip it as sorted-key JSONL.
- :func:`run_schedule`: fires each arrival at its offset on its own
  thread against the router's ``/generate`` (or an injected
  ``sender``); arrivals over the in-flight cap are dropped and
  counted, so offered == sent + dropped.
- :func:`summarize`: the per-tenant percentile and goodput rollup.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import random
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence

_log = logging.getLogger(__name__)

DROP_REASON_INFLIGHT = "inflight_cap"


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic shape in a mix: relative arrival weight,
    prompt-length range (tokens drawn uniformly), generation budget,
    and the SLO dict each request carries (None → tenant/env defaults
    resolve server-side)."""

    name: str
    weight: float = 1.0
    prompt_len: Sequence[int] = (8, 16)     # inclusive [lo, hi]
    max_new_tokens: int = 16
    slo: Optional[dict] = None
    vocab: int = 256
    # QoS class the tenant maps to server-side (docs/serving.md#qos) —
    # client-side attribution only; the engine resolves the real class
    # from the SLO config file. Omitted from the canonical rows when
    # None so pre-QoS schedule checksums stay byte-identical.
    priority: Optional[str] = None

    def to_dict(self) -> dict:
        d = {"name": self.name, "weight": self.weight,
             "prompt_len": list(self.prompt_len),
             "max_new_tokens": self.max_new_tokens,
             "vocab": self.vocab}
        if self.slo is not None:
            d["slo"] = dict(self.slo)
        if self.priority is not None:
            d["priority"] = self.priority
        return d


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: fire at ``t_s`` after start, regardless
    of what happened to every earlier arrival."""

    t_s: float
    tenant: str
    tokens: tuple
    max_new_tokens: int
    slo: Optional[dict] = None
    priority: Optional[str] = None

    def to_dict(self) -> dict:
        d = {"t_s": self.t_s, "tenant": self.tenant,
             "tokens": list(self.tokens),
             "max_new_tokens": self.max_new_tokens}
        if self.slo is not None:
            d["slo"] = dict(self.slo)
        if self.priority is not None:
            d["priority"] = self.priority
        return d


def build_schedule(rate_rps: float, duration_s: float, seed: int,
                   tenants: Sequence[TenantSpec],
                   process: str = "poisson") -> List[Arrival]:
    """Deterministic arrival schedule: ``poisson`` draws exponential
    gaps at ``rate_rps`` (the open-loop default — bursts happen, like
    real traffic), ``constant`` spaces arrivals exactly ``1/rate``
    apart. All randomness flows from ``random.Random(seed)``, so a
    fixed seed is a fixed schedule — arrival times, tenant assignment,
    prompt contents, everything."""
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    if duration_s <= 0:
        raise ValueError("duration_s must be positive")
    if not tenants:
        raise ValueError("at least one TenantSpec required")
    if process not in ("poisson", "constant"):
        raise ValueError(f"unknown arrival process: {process!r}")
    rng = random.Random(seed)
    weights = [max(0.0, t.weight) for t in tenants]
    if sum(weights) <= 0:
        raise ValueError("tenant weights must sum > 0")
    out: List[Arrival] = []
    t = 0.0
    while True:
        gap = (rng.expovariate(rate_rps) if process == "poisson"
               else 1.0 / rate_rps)
        t += gap
        if t >= duration_s:
            break
        spec = rng.choices(tenants, weights=weights)[0]
        lo, hi = spec.prompt_len[0], spec.prompt_len[-1]
        n = rng.randint(int(lo), int(hi))
        tokens = tuple(rng.randrange(1, spec.vocab) for _ in range(n))
        out.append(Arrival(
            t_s=round(t, 6), tenant=spec.name, tokens=tokens,
            max_new_tokens=spec.max_new_tokens, slo=spec.slo,
            priority=spec.priority))
    return out


def schedule_checksum(arrivals: Sequence[Arrival]) -> str:
    """crc32 over the canonical JSON rows — the byte-identity pin the
    bench contract compares across regenerations."""
    payload = "\n".join(
        json.dumps(a.to_dict(), sort_keys=True) for a in arrivals)
    return f"{zlib.crc32(payload.encode()):08x}"


def save_schedule(arrivals: Sequence[Arrival], path: str) -> None:
    """Replayable trace format: one sorted-key JSON row per arrival."""
    with open(path, "w") as f:
        for a in arrivals:
            f.write(json.dumps(a.to_dict(), sort_keys=True) + "\n")


def load_schedule(path: str) -> List[Arrival]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append(Arrival(
                t_s=d["t_s"], tenant=d["tenant"],
                tokens=tuple(d["tokens"]),
                max_new_tokens=d["max_new_tokens"],
                slo=d.get("slo"), priority=d.get("priority")))
    return out


def _http_sender(host: str, port: int, timeout_s: float) -> Callable:
    """The real sender: one unary POST /generate against the router,
    returning the decoded reply dict (an ``_error`` row on transport
    failure — the open loop never raises mid-run)."""
    import http.client

    def send(arrival: Arrival) -> dict:
        body = {"tokens": list(arrival.tokens),
                "max_new_tokens": arrival.max_new_tokens,
                "tenant": arrival.tenant}
        if arrival.slo is not None:
            body["slo"] = arrival.slo
        try:
            conn = http.client.HTTPConnection(host, port,
                                              timeout=timeout_s)
            try:
                conn.request("POST", "/generate", json.dumps(body),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = json.loads(
                    resp.read().decode(errors="replace") or "{}")
                payload["_http_status"] = resp.status
                return payload
            finally:
                conn.close()
        except (OSError, ValueError) as e:
            return {"_error": str(e), "_http_status": 0}

    return send


def run_schedule(arrivals: Sequence[Arrival], host: str = "127.0.0.1",
                 port: int = 8471, *, max_inflight: int = 64,
                 timeout_s: float = 60.0,
                 sender: Optional[Callable] = None) -> dict:
    """Fire the schedule open-loop: each arrival launches at its
    ``t_s`` offset whether or not earlier requests finished. At most
    ``max_inflight`` requests are outstanding; an arrival landing over
    the cap is dropped on the spot and accounted (reason
    ``inflight_cap``) — backpressure must show up in the numbers, not
    stall the clock. Returns ``{"offered", "sent", "dropped",
    "drop_reasons", "results": [row...], "wall_s"}`` with
    offered == sent + dropped guaranteed."""
    send = sender if sender is not None \
        else _http_sender(host, port, timeout_s)
    results: List[dict] = []
    lock = threading.Lock()
    inflight = threading.Semaphore(max_inflight)
    threads: List[threading.Thread] = []
    dropped: Dict[str, int] = {}
    t0 = time.perf_counter()

    def fire(arrival: Arrival) -> None:
        t_sent = time.perf_counter() - t0
        try:
            reply = send(arrival)
        finally:
            inflight.release()
        row = {"tenant": arrival.tenant, "t_s": arrival.t_s,
               "t_sent_s": round(t_sent, 6),
               "latency_s": round(time.perf_counter() - t0 - t_sent,
                                  6)}
        if arrival.priority is not None:
            row["priority"] = arrival.priority
        if isinstance(reply, dict):
            status = reply.get("_http_status", 200)
            row["http_status"] = status
            if "_error" in reply:
                row["status"] = "error"
                row["error"] = reply["_error"]
            elif status == 200:
                row["status"] = "completed"
                for k in ("ttft_ms", "latency_ms", "trace_id",
                          "slo"):
                    if k in reply:
                        row[k] = reply[k]
                if reply.get("tenant"):
                    row["tenant_label"] = reply["tenant"]
            elif status == 429:
                row["status"] = "rejected"
            elif status == 504:
                row["status"] = "deadline"
            else:
                row["status"] = "failed"
                row["error"] = str(reply.get("error"))[:200]
        else:
            row["status"] = "completed"
            row.update(reply or {})
        with lock:
            results.append(row)

    for arrival in arrivals:
        delay = arrival.t_s - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        # Non-blocking cap check AT the scheduled instant: a full
        # window means this arrival is shed client-side, the clock
        # does not wait for capacity (that would close the loop).
        if not inflight.acquire(blocking=False):
            with lock:
                dropped[DROP_REASON_INFLIGHT] = \
                    dropped.get(DROP_REASON_INFLIGHT, 0) + 1
                drop_row = {
                    "tenant": arrival.tenant, "t_s": arrival.t_s,
                    "status": "dropped",
                    "drop_reason": DROP_REASON_INFLIGHT}
                if arrival.priority is not None:
                    drop_row["priority"] = arrival.priority
                results.append(drop_row)
            continue
        th = threading.Thread(target=fire, args=(arrival,),
                              daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=timeout_s + 5.0)
    n_dropped = sum(dropped.values())
    out = {
        "offered": len(arrivals),
        "sent": len(arrivals) - n_dropped,
        "dropped": n_dropped,
        "drop_reasons": dict(dropped),
        "results": results,
        "wall_s": round(time.perf_counter() - t0, 3),
    }
    assert out["offered"] == out["sent"] + out["dropped"]
    return out


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _new_rollup() -> dict:
    return {"offered": 0, "completed": 0, "dropped": 0, "rejected": 0,
            "deadline": 0, "failed": 0, "slo_met": 0,
            "slo_violations": 0, "_ttft": [], "_lat": []}


def _count_row(t: dict, row: dict) -> None:
    t["offered"] += 1
    status = row["status"]
    if status == "completed":
        t["completed"] += 1
        if "ttft_ms" in row:
            t["_ttft"].append(float(row["ttft_ms"]))
        if "latency_ms" in row:
            t["_lat"].append(float(row["latency_ms"]))
        verdict = row.get("slo")
        if isinstance(verdict, dict):
            if verdict.get("slo_met"):
                t["slo_met"] += 1
            else:
                t["slo_violations"] += 1
    elif status in ("dropped", "rejected", "deadline", "failed",
                    "error"):
        t[status if status in ("dropped", "rejected", "deadline")
          else "failed"] += 1


def _finish_rollup(t: dict) -> dict:
    ttft = sorted(t.pop("_ttft"))
    lat = sorted(t.pop("_lat"))
    judged = t["slo_met"] + t["slo_violations"]
    # Goodput denominator is OFFERED load: every dropped/rejected
    # request is a miss the client felt.
    shed = t["offered"] - t["completed"]
    t["goodput"] = t["slo_met"] if judged else t["completed"]
    t["goodput_frac"] = round(t["goodput"] / t["offered"], 4) \
        if t["offered"] else 0.0
    t["shed"] = shed
    t["ttft_p50_ms"] = round(_percentile(ttft, 0.50), 3)
    t["ttft_p99_ms"] = round(_percentile(ttft, 0.99), 3)
    t["latency_p50_ms"] = round(_percentile(lat, 0.50), 3)
    t["latency_p99_ms"] = round(_percentile(lat, 0.99), 3)
    return t


def summarize(run: dict,
              classes: Optional[Dict[str, str]] = None) -> dict:
    """Per-tenant rollup of a :func:`run_schedule` result: counts by
    status, TTFT p50/p99, goodput (completed AND slo_met — a dropped
    or shed request counts against goodput, exactly like the server-
    side `shed` reason keeps it visible in the counters).

    When any row carries a ``priority`` (a :class:`TenantSpec` with one
    set, docs/serving.md#qos) — or an explicit ``classes`` tenant→class
    mapping is given — the summary grows a ``by_class`` section with
    the same rollup shape per priority class."""
    tenants: Dict[str, dict] = {}
    by_class: Dict[str, dict] = {}
    for row in run["results"]:
        t = tenants.setdefault(row["tenant"], _new_rollup())
        _count_row(t, row)
        cls = (classes or {}).get(row["tenant"]) or row.get("priority")
        if cls is not None:
            _count_row(by_class.setdefault(str(cls), _new_rollup()),
                       row)
    out = {name: _finish_rollup(t) for name, t in tenants.items()}
    totals = {
        "offered": run["offered"], "sent": run["sent"],
        "dropped": run["dropped"],
        "goodput": sum(t["goodput"] for t in out.values()),
        "completed": sum(t["completed"] for t in out.values()),
    }
    totals["goodput_frac"] = round(
        totals["goodput"] / totals["offered"], 4) \
        if totals["offered"] else 0.0
    summary = {"tenants": out, "totals": totals}
    if by_class:
        summary["by_class"] = {cls: _finish_rollup(t)
                               for cls, t in by_class.items()}
    return summary
