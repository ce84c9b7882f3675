"""Per-request SLO attribution and tenant accounting
(docs/serving.md#slo). Counterpart of ``horovod_tpu/serving/slo.py``,
copied: the same targets, tenant labels and verdicts.

Three small pieces the whole serving path shares:

- **Target resolution**: a request may carry explicit TTFT/TPOT
  targets (``"slo": {"ttft_ms": .., "tpot_ms": ..}``); missing fields
  fall back to the tenant's entry in the fleet SLO config file
  (``HOROVOD_TPU_SLO_CONFIG``), then to the config's ``"default"``
  entry, then to the env-level targets (``HOROVOD_TPU_SLO_TTFT_MS`` /
  ``_TPOT_MS``). A request that resolves to no target at all carries
  no SLO — it is served and counted per-tenant, but never judged.

- **Bounded tenant cardinality**: tenant names become metric label
  values, so the first ``HOROVOD_TPU_MAX_TENANTS`` distinct names keep
  their own label and every later one collapses into the ``"other"``
  overflow bucket — a client fabricating tenant names cannot grow the
  registry without bound. Requests with no tenant land under
  ``"default"``.

- **Goodput accounting**: ``hvdtpu_slo_goodput_total{tenant}`` counts
  completed requests that met every attached target;
  ``hvdtpu_slo_violations_total{tenant, reason}`` counts the misses
  (``ttft``/``tpot``) and the requests that never got an answer at all
  (``shed`` — the 429 queue-full path; ``deadline`` — the 504 path),
  so shed load stays visible in goodput math instead of vanishing.
  ``hvdtpu_slo_violation_seconds{tenant}`` carries the exemplar
  linking the worst recent violation to its trace id.

Everything here is process-local registry state: the replica engine
judges with its own clocks, the fleet router re-counts the same
verdicts fleet-side, and the per-replica history sampler trends both
(docs/serving.md#fleet).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
from typing import Dict, Optional

from ..observability import registry as _obs
from ..utils import env as _env

_log = logging.getLogger(__name__)

# Overflow label once the tenant table hits HOROVOD_TPU_MAX_TENANTS,
# and the label untenanted requests land under.
OVERFLOW_TENANT = "other"
DEFAULT_TENANT = "default"

VIOLATION_REASONS = ("ttft", "tpot", "shed", "deadline")


def _metrics():
    r = _obs.registry()
    return {
        "goodput": r.counter(
            "hvdtpu_slo_goodput_total",
            "Completed requests that met every attached SLO target, "
            "by tenant — the numerator of goodput "
            "(docs/serving.md#slo)"),
        "violations": r.counter(
            "hvdtpu_slo_violations_total",
            "SLO misses by tenant and reason: ttft / tpot (completed "
            "but late), shed (429 queue-full), deadline (504) — shed "
            "load stays visible in goodput math"),
        "request_s": r.histogram(
            "hvdtpu_slo_request_seconds",
            "End-to-end latency of SLO-attached completed requests, "
            "by tenant (submit → done on the judging process)",
            buckets=_obs.LATENCY_BUCKETS),
        "tokens": r.counter(
            "hvdtpu_slo_tokens_total",
            "Generated tokens attributed per tenant (SLO-attached "
            "requests)"),
        "violation_s": r.histogram(
            "hvdtpu_slo_violation_seconds",
            "Observed latency of the violated target (TTFT seconds "
            "for a ttft miss, per-token seconds for a tpot miss; "
            "exemplar: trace id of the worst recent violation)",
            buckets=_obs.LATENCY_BUCKETS),
    }


_m = None
_m_lock = threading.Lock()


def metrics() -> dict:
    global _m
    if _m is None:
        with _m_lock:
            if _m is None:
                _m = _metrics()
    return _m


# --------------------------------------------------------------- targets

@dataclasses.dataclass(frozen=True)
class SloTargets:
    """Resolved per-request targets, milliseconds. A None field means
    that dimension is not judged."""

    ttft_ms: Optional[float] = None
    tpot_ms: Optional[float] = None

    def __bool__(self) -> bool:
        return self.ttft_ms is not None or self.tpot_ms is not None

    def to_dict(self) -> dict:
        d = {}
        if self.ttft_ms is not None:
            d["ttft_ms"] = self.ttft_ms
        if self.tpot_ms is not None:
            d["tpot_ms"] = self.tpot_ms
        return d


def parse_slo(obj) -> Optional[SloTargets]:
    """Validate a request's ``slo`` field. None passes through; a dict
    with optional numeric ``ttft_ms``/``tpot_ms`` becomes
    :class:`SloTargets`; anything else raises ``ValueError`` (the HTTP
    400 path)."""
    if obj is None:
        return None
    if isinstance(obj, SloTargets):
        return obj
    if not isinstance(obj, dict):
        raise ValueError("'slo' must be an object with ttft_ms/tpot_ms")
    out = {}
    for key in ("ttft_ms", "tpot_ms"):
        v = obj.get(key)
        if v is None:
            continue
        if isinstance(v, bool) or not isinstance(v, (int, float)) \
                or v <= 0:
            raise ValueError(f"'slo.{key}' must be a positive number")
        out[key] = float(v)
    unknown = set(obj) - {"ttft_ms", "tpot_ms"}
    if unknown:
        raise ValueError(f"unknown 'slo' field(s): {sorted(unknown)}")
    return SloTargets(**out)


def _strip_qos(row):
    """Drop the QoS plane's tenant-row fields (priority/weight/quota,
    docs/serving.md#qos) before SLO validation — the two planes share
    one config file and parse_slo rejects unknown keys."""
    if not isinstance(row, dict):
        return row
    from . import qos as _qos
    return {k: v for k, v in row.items()
            if k not in _qos.QOS_CONFIG_FIELDS}


class SloPolicy:
    """Target resolution: request field > tenant config entry >
    config ``default`` entry > env defaults. The config file
    (``HOROVOD_TPU_SLO_CONFIG``) is read once per policy instance —
    the fleet ships one env to every replica, so the file is
    deployment-static."""

    def __init__(self, config_path: Optional[str] = None):
        path = config_path if config_path is not None \
            else _env.slo_config()
        self._tenants: Dict[str, SloTargets] = {}
        self._default: Optional[SloTargets] = None
        if path:
            try:
                with open(path) as f:
                    cfg = json.load(f)
                for name, row in (cfg.get("tenants") or {}).items():
                    self._tenants[str(name)] = \
                        parse_slo(_strip_qos(row)) or SloTargets()
                if cfg.get("default") is not None:
                    self._default = parse_slo(
                        _strip_qos(cfg["default"]))
            except (OSError, ValueError) as e:
                _log.warning("SLO config %s unreadable: %s", path, e)
        env_ttft = _env.slo_ttft_ms()
        env_tpot = _env.slo_tpot_ms()
        if env_ttft is not None or env_tpot is not None:
            base = self._default or SloTargets()
            self._default = SloTargets(
                ttft_ms=base.ttft_ms if base.ttft_ms is not None
                else env_ttft,
                tpot_ms=base.tpot_ms if base.tpot_ms is not None
                else env_tpot)

    def resolve(self, tenant: Optional[str],
                request_slo=None) -> Optional[SloTargets]:
        """Field-wise overlay: each target dimension takes the most
        specific source that names it. Returns None when nothing
        attaches an SLO (the request is never judged)."""
        req = parse_slo(request_slo)
        tenant_t = self._tenants.get(tenant) if tenant else None
        ttft = tpot = None
        for src in (req, tenant_t, self._default):
            if src is None:
                continue
            if ttft is None and src.ttft_ms is not None:
                ttft = src.ttft_ms
            if tpot is None and src.tpot_ms is not None:
                tpot = src.tpot_ms
        if ttft is None and tpot is None:
            return None
        return SloTargets(ttft_ms=ttft, tpot_ms=tpot)


_policy: Optional[SloPolicy] = None
_policy_lock = threading.Lock()


def policy() -> SloPolicy:
    """The process-global policy (config read once, first use)."""
    global _policy
    if _policy is None:
        with _policy_lock:
            if _policy is None:
                _policy = SloPolicy()
    return _policy


def _reset_policy() -> None:
    """Test hook: drop the cached policy so env/config changes apply."""
    global _policy
    _policy = None


# ---------------------------------------------------------- tenant label

_tenant_table: Dict[str, str] = {}
_tenant_lock = threading.Lock()


def resolve_tenant(name: Optional[str]) -> str:
    """Bounded-cardinality label for a tenant name: the first
    ``HOROVOD_TPU_MAX_TENANTS`` distinct names map to themselves,
    later ones to ``"other"``; no/empty name maps to ``"default"``.
    The mapping is sticky for the process lifetime, so a tenant that
    made the table keeps its label."""
    if not name:
        return DEFAULT_TENANT
    name = str(name)[:64]
    with _tenant_lock:
        label = _tenant_table.get(name)
        if label is None:
            if len(_tenant_table) < _env.max_tenants():
                label = name
            else:
                label = OVERFLOW_TENANT
            _tenant_table[name] = label
        return label


def _reset_tenants() -> None:
    """Test hook: empty the tenant table (mirrors _reset_policy)."""
    with _tenant_lock:
        _tenant_table.clear()


# ------------------------------------------------------------- verdicts

def judge(targets: SloTargets, ttft_s: Optional[float],
          tpot_s: Optional[float]) -> dict:
    """The verdict a completed request is stamped with: measured
    TTFT/TPOT against the attached targets. ``tpot_s`` is the mean
    time per output token after the first (None for single-token
    generations — that dimension then trivially passes)."""
    ttft_bad = (targets.ttft_ms is not None and ttft_s is not None
                and ttft_s * 1e3 > targets.ttft_ms)
    tpot_bad = (targets.tpot_ms is not None and tpot_s is not None
                and tpot_s * 1e3 > targets.tpot_ms)
    verdict = {
        "slo_met": not (ttft_bad or tpot_bad),
        "ttft_violation": ttft_bad,
        "tpot_violation": tpot_bad,
    }
    if ttft_s is not None:
        verdict["ttft_ms"] = round(ttft_s * 1e3, 3)
    if tpot_s is not None:
        verdict["tpot_ms"] = round(tpot_s * 1e3, 3)
    verdict.update({f"target_{k}": v
                    for k, v in targets.to_dict().items()})
    return verdict


def record_completion(tenant: str, verdict: dict,
                      latency_s: float, ttft_s: Optional[float],
                      tpot_s: Optional[float], n_tokens: int,
                      trace_id: Optional[str] = None) -> None:
    """Count one judged completion into the ``hvdtpu_slo_*`` families.
    ``tenant`` must already be a resolved label
    (:func:`resolve_tenant`)."""
    m = metrics()
    m["request_s"].labels(tenant=tenant).observe(latency_s,
                                                 exemplar=trace_id)
    m["tokens"].labels(tenant=tenant).inc(n_tokens)
    if verdict["slo_met"]:
        m["goodput"].labels(tenant=tenant).inc()
        return
    if verdict.get("ttft_violation"):
        m["violations"].labels(tenant=tenant, reason="ttft").inc()
        if ttft_s is not None:
            m["violation_s"].labels(tenant=tenant).observe(
                ttft_s, exemplar=trace_id)
    if verdict.get("tpot_violation"):
        m["violations"].labels(tenant=tenant, reason="tpot").inc()
        if tpot_s is not None:
            m["violation_s"].labels(tenant=tenant).observe(
                tpot_s, exemplar=trace_id)


def record_shed(tenant: str, reason: str) -> None:
    """Count a request that never completed: ``shed`` (queue-full 429)
    or ``deadline`` (504)."""
    metrics()["violations"].labels(tenant=tenant, reason=reason).inc()


def verdict_summary(verdict: Optional[dict]) -> str:
    """Compact verdict string for trace tables and flight-recorder
    notes: ``met``, or the comma-joined violated dimensions."""
    if not verdict:
        return "-"
    if verdict.get("slo_met"):
        return "met"
    bad = [k[:4] for k in ("ttft_violation", "tpot_violation")
           if verdict.get(k)]
    return ",".join(bad) or "miss"
