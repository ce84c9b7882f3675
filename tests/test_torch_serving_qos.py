"""The port's QoS plane, SLO attribution and request tracing against the
JAX package's: the cases of ``tests/test_qos.py``, ``tests/test_slo.py``
and ``tests/test_reqtrace.py``.

The decision cases run on both packages' modules and must observe the
same (queue picks, policies, shed and quota decisions, Retry-After,
autoscaler decisions, SLO targets, tenant labels, verdicts); the
assertions inside each case hold on both. The engine cases drive the
port's ``InferenceEngine`` on JAX's small config (fp32, on the CPU), and
its admission order, spans and verdicts are compared with JAX's engine
where a run of both is cheap.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel.mesh import create_mesh as jax_mesh
from horovod_tpu.serving import InferenceEngine as JaxEngine
from horovod_tpu.serving import ServingConfig as JaxConfig
from horovod_tpu.serving import qos as jqos
from horovod_tpu.serving import reqtrace as jrt
from horovod_tpu.serving import slo as jslo
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.serving import (InferenceEngine, QueueFullError,
                                       QuotaExceededError, ServingConfig)
from horovod_tpu_torch.serving import qos as tqos
from horovod_tpu_torch.serving import reqtrace as trt
from horovod_tpu_torch.serving import slo as tslo

JAX = types.SimpleNamespace(qos=jqos, slo=jslo, name="jax")
TORCH = types.SimpleNamespace(qos=tqos, slo=tslo, name="torch")
SLO_ENV = ("HOROVOD_TPU_SLO_TTFT_MS", "HOROVOD_TPU_SLO_TPOT_MS",
           "HOROVOD_TPU_SLO_CONFIG")


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    for name in SLO_ENV:
        monkeypatch.delenv(name, raising=False)
    for m in (jslo, tslo):
        m._reset_policy()
        m._reset_tenants()
    yield
    for m in (jslo, tslo):
        m._reset_policy()
        m._reset_tenants()


class _Item:
    def __init__(self, name):
        self.name = name


def _loaded(q, weights=None, per_class=50):
    out = q.ClassQueues(weights)
    for c in q.PRIORITY_CLASSES:
        for i in range(per_class):
            out.append(_Item(f"{c}{i}"), qos_class=c)
    return out


# --------------------------------------------------------------- queues

def weight_proportionality(m, tmp):
    q = _loaded(m.qos, {"interactive": 4, "default": 2, "bulk": 1})
    picks = [q.select().qos_class for _ in range(70)]
    assert [picks.count(c) for c in ("interactive", "default", "bulk")] \
        == [40, 20, 10]
    return picks


def no_starvation(m, tmp):
    q = _loaded(m.qos, {"interactive": 4, "default": 2, "bulk": 1})
    first = [q.select().qos_class for _ in range(7)]
    assert "bulk" in first and "default" in first
    return first


def fractional_weights(m, tmp):
    q = m.qos.ClassQueues({"interactive": 0.4, "default": 0.2,
                           "bulk": 0.1})
    q.append(_Item("b0"), qos_class="bulk")
    return q.select().qos_class


def fifo_allowed_pushback_remove(m, tmp):
    q = _loaded(m.qos, per_class=2)
    out = [q.select(lambda c: c == m.qos.TOP_CLASS).name,
           q.select(lambda c: False), len(q)]
    first = q.select()
    q.pushback(first)
    out += [first.name, q.select().name]
    victim = q.heads()[-1]
    out += [q.remove(victim), q.remove(victim), len(q),
            [r.name for r in q], q.depths()]
    return out


def reserved_slot_simulation(m, tmp):
    slots, reserved = 4, 2
    q = m.qos.ClassQueues()
    for i in range(16):
        q.append(_Item(f"b{i}"), qos_class="bulk")
    active = []
    while len(active) < slots:
        non_top = sum(1 for r in active if r.qos_class != m.qos.TOP_CLASS)
        req = q.select(lambda c, n=non_top: c == m.qos.TOP_CLASS
                       or n < slots - reserved)
        if req is None:
            break
        active.append(req)
    assert len(active) == 2
    q.append(_Item("vip"), qos_class="interactive")
    req = q.select(lambda c: c == m.qos.TOP_CLASS)
    return [r.name for r in active], req.name


# --------------------------------------------------------------- policy

def _write(tmp, name, obj):
    p = tmp / name
    p.write_text(obj if isinstance(obj, str) else json.dumps(obj))
    return str(p)


def qos_policy_rows(m, tmp):
    path = _write(tmp, "qos.json", {"tenants": {
        "vip": {"priority": "interactive", "weight": 8, "ttft_ms": 100},
        "batch": {"priority": "bulk", "quota_tokens_per_s": 500},
        "plain": {"ttft_ms": 200}},
        "default": {"priority": "default", "weight": 3}})
    pol = m.qos.QosPolicy(path)
    bad = m.qos.QosPolicy(_write(tmp, "bad.json", "{nope"))
    out = [(pol.class_of(t), pol.spec_of(t).weight, pol.quota_of(t))
           for t in ("vip", "batch", "plain", None)]
    errors = []
    for kw in (dict(priority="platinum"), dict(weight=0)):
        with pytest.raises(ValueError) as e:
            m.qos.TenantQos(**kw)
        errors.append(str(e.value))
    return out, pol.class_weights(), bad.class_of("anyone"), errors


def predictive_shed(m, tmp):
    buckets = {8: 0.010, 16: 0.022}

    def bucket(n):
        b = 8
        while b < n:
            b *= 2
        return b

    f = m.qos.predict_prefill_s
    return ([f(n, buckets, bucket) for n in (6, 12, 30, 0)],
            f(30, {}, bucket), f(40, buckets, bucket, chunk_tokens=16),
            [m.qos.shed_decision(*a) for a in
             [(0.02, 0.05, 0.01), (0.10, 0.05, 0.01), (-5.0, 0.0, 0.0)]])


def quota_ledger(m, tmp):
    def policy(quota=100, priority="default"):
        return m.qos.QosPolicy(_write(tmp, f"q{quota}{priority}.json", {
            "tenants": {"t": {"priority": priority,
                              "quota_tokens_per_s": quota}}}))

    led = m.qos.QuotaLedger(policy())
    out = [led.admit("t", 150, now=0.0), led.admit("t", 50, now=0.0),
           led.admit("t", 50, now=0.0), led.admit("t", 50, now=1.0),
           led.admit("unknown", 10**9, now=0.0),
           led.admit(None, 10**9, now=0.0)]
    led = m.qos.QuotaLedger(policy())
    out += [led.admit("t", 200, now=0.0), led.admit("t", 150, now=0.0),
            led.admit("t", 100, now=1.0)]
    led = m.qos.QuotaLedger(policy())
    for i in range(10):
        led.note_completion("t", 50, now=float(i))
    out += [led.drain_rate("t", now=10.0),
            led.retry_after_s("t", deficit=100.0, now=10.0),
            led.drain_rate("t", now=100.0),
            m.qos.QuotaLedger(policy()).retry_after_s("t", 100.0, now=0.0),
            m.qos.QuotaLedger(policy(1000, "bulk")).retry_after_s(
                "t", deficit=1.0, now=0.0),
            m.qos.QuotaLedger(policy(1)).retry_after_s(
                "t", deficit=10**6, now=0.0)]
    return out


AUTOSCALE = dict(high_load=1.5, low_load=0.25, sustain_s=3.0,
                 cooldown_s=10.0, alert_hold_s=5.0)
# (replicas, [(now, n, load, kwargs)], alert) scripts of test_qos.py.
AUTOSCALE_SCRIPTS = [
    ({}, [(0.0, 2, 2.0), (2.0, 2, 2.0), (3.5, 2, 2.0), (4.0, 3, 2.0)],
     None),
    ({}, [(0.0, 2, 2.0), (1.0, 2, 1.0), (2.0, 2, 2.0), (4.9, 2, 2.0),
          (5.1, 2, 2.0)], None),
    ({}, [(0.0, 4, 2.0), (10.0, 4, 2.0)], None),
    ({}, [(0.0, 3, 0.1), (9.0, 3, 0.1), (10.5, 3, 0.1)], None),
    ({}, [(0.0, 2, 0.1), (100.0, 2, 0.1)], None),
    ({}, [(0.0, 3, 0.1), (5.0, 3, 1.0), (11.0, 3, 0.1)], None),
    ({}, [(0.0, 2, 0.0), (3.5, 2, 0.0)], "queue_depth_runaway"),
    ({}, [(6.0, 2, 0.0)], "queue_depth_runaway"),
    ({}, [(0.0, 2, 0.0, {"retry_pressure": 2.0}),
          (3.5, 2, 0.0, {"retry_pressure": 2.0})], None),
    ({"ttft_target_ms": 500.0},
     [(0.0, 2, 0.0, {"ttft_p99_ms": 900.0}),
      (3.5, 2, 0.0, {"ttft_p99_ms": 900.0})], None),
]


def autoscaler(m, tmp):
    out = []
    for over, steps, alert in AUTOSCALE_SCRIPTS:
        s = m.qos.AutoscalerState(m.qos.AutoscalerConfig(
            2, 4, **dict(AUTOSCALE, **over)))
        if alert:
            s.note_alert(alert, 0.0)
        out.append([s.observe(*step[:3], **(step[3] if len(step) > 3
                                            else {})) for step in steps])
    for lo, hi in ((0, 2), (3, 2)):
        with pytest.raises(ValueError):
            m.qos.AutoscalerConfig(lo, hi)
    return out


# ------------------------------------------------------------------ SLO

def parse_slo(m, tmp):
    out = [m.slo.parse_slo(None)]
    for good in ({"ttft_ms": 500, "tpot_ms": 50.5}, {"ttft_ms": 100}):
        t = m.slo.parse_slo(good)
        out.append((t.ttft_ms, t.tpot_ms, bool(t), t.to_dict()))
    for bad in ("fast", 42, ["ttft_ms"], {"ttft_ms": 0}, {"ttft_ms": -1},
                {"ttft_ms": True}, {"ttft_ms": "500"}, {"deadline_ms": 5}):
        with pytest.raises(ValueError) as e:
            m.slo.parse_slo(bad)
        out.append(str(e.value))
    return out


def _targets(t):
    return None if t is None else (t.ttft_ms, t.tpot_ms)


def slo_policy(m, tmp):
    cfg = _write(tmp, "slo.json", {
        "tenants": {"interactive": {"ttft_ms": 200}},
        "default": {"ttft_ms": 1000, "tpot_ms": 80}})
    p = m.slo.SloPolicy(config_path=cfg)
    bad = m.slo.SloPolicy(config_path=_write(tmp, "broken.json", "{x"))
    qos_fields = m.slo.SloPolicy(config_path=_write(tmp, "q.json", {
        "tenants": {"vip": {"priority": "interactive", "weight": 8,
                            "ttft_ms": 123}}}))
    return [_targets(m.slo.SloPolicy().resolve("anyone", None)),
            _targets(p.resolve("interactive", None)),
            _targets(p.resolve("interactive", {"ttft_ms": 50})),
            _targets(p.resolve("stranger", None)),
            _targets(bad.resolve("x", None)),
            _targets(qos_fields.resolve("vip"))]


def slo_env_default(m, tmp):
    import os
    os.environ["HOROVOD_TPU_SLO_TTFT_MS"] = "750"
    try:
        return _targets(m.slo.SloPolicy().resolve(None, None))
    finally:
        del os.environ["HOROVOD_TPU_SLO_TTFT_MS"]


def tenant_cardinality(m, tmp):
    import os
    os.environ["HOROVOD_TPU_MAX_TENANTS"] = "2"
    try:
        m.slo._reset_tenants()
        return [m.slo.resolve_tenant(t) for t in
                ("a", "b", "c", "a", "c", None, "")]
    finally:
        del os.environ["HOROVOD_TPU_MAX_TENANTS"]
        m.slo._reset_tenants()


def judge(m, tmp):
    v = [m.slo.judge(m.slo.SloTargets(ttft_ms=100, tpot_ms=50), 0.05,
                     0.01),
         m.slo.judge(m.slo.SloTargets(ttft_ms=10), 0.05, None),
         m.slo.judge(m.slo.SloTargets(tpot_ms=1), 0.5, None)]
    assert v[0]["slo_met"] and not v[1]["slo_met"] and v[2]["slo_met"]
    return v, [m.slo.verdict_summary(x) for x in
               (None, {"slo_met": True},
                {"slo_met": False, "ttft_violation": True,
                 "tpot_violation": True})]


CASES = [weight_proportionality, no_starvation, fractional_weights,
         fifo_allowed_pushback_remove, reserved_slot_simulation,
         qos_policy_rows, predictive_shed, quota_ledger, autoscaler,
         parse_slo, slo_policy, slo_env_default, tenant_cardinality, judge]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_decisions_match_jax(case, tmp_path):
    (tmp_path / "torch").mkdir()
    (tmp_path / "jax").mkdir()
    assert case(TORCH, tmp_path / "torch") == case(JAX, tmp_path / "jax")


def test_registry_cardinality_is_bounded(monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_MAX_TENANTS", "3")
    fam = tslo.metrics()["goodput"]
    for i in range(50):
        fam.labels(tenant=tslo.resolve_tenant(f"attacker{i}")).inc()
    vals = hvd.metrics_snapshot()["hvdtpu_slo_goodput_total"]["values"]
    assert len({k for k in vals if "attacker" in k}) == 3
    assert vals['tenant="other"'] >= 47.0


# -------------------------------------------------------------- engine

SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, remat=False)
ENGINE = dict(block_size=4, kv_blocks=40, max_batch_slots=4, max_queue=8,
              max_new_tokens=8, min_prefill_bucket=8)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32))


@pytest.fixture(scope="module")
def models():
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **SMALL)
    params = jax.device_get(jtfm.init_params(jcfg, jax.random.PRNGKey(0)))
    model = ttfm.Transformer(ttfm.TransformerConfig(dtype=torch.float32,
                                                    **SMALL),
                             params=_torch_tree(params), device="cpu")
    return jcfg, params, model


def _engine(models, **over):
    return InferenceEngine(models[2], ServingConfig(**dict(ENGINE, **over)),
                           device="cpu")


def _jax_engine(models, **over):
    jcfg, params, _ = models
    return JaxEngine(params, jcfg, jax_mesh(devices=jax.devices()[:1], tp=1),
                     JaxConfig(**dict(ENGINE, **over)))


def _qos_config(tmp_path, monkeypatch, rows):
    monkeypatch.setenv("HOROVOD_TPU_SLO_CONFIG",
                       _write(tmp_path, "qos.json", {"tenants": rows}))
    for m in (jqos, tqos):
        m._reset_policy()


def test_reserved_slots_validation(models):
    for bad in (-1, 4):
        with pytest.raises(ValueError, match="reserved_slots"):
            _engine(models, reserved_slots=bad)


def test_reserved_slot_invariant_under_bulk_backlog(models, tmp_path,
                                                    monkeypatch):
    _qos_config(tmp_path, monkeypatch, {
        "bulk": {"priority": "bulk"}, "vip": {"priority": "interactive"}})
    eng = _engine(models, reserved_slots=2, max_queue=16)
    bulk = [eng.submit([1, 2, 3 + i], tenant="bulk", max_new_tokens=6)
            for i in range(8)]
    eng._admit()
    assert eng.active_count == 2
    vip = eng.submit([9, 9, 9], tenant="vip", max_new_tokens=2)
    eng._admit()
    assert vip.status == "active"
    eng.run_until_idle()
    assert all(r.status == "completed" for r in bulk + [vip])


def test_dwrr_admission_order_matches_jax(models, tmp_path, monkeypatch):
    """The same backlog of interactive and bulk tenants admits in the
    same order through both engines, and gives the same tokens."""
    _qos_config(tmp_path, monkeypatch, {
        "bulk": {"priority": "bulk"}, "vip": {"priority": "interactive"}})
    out = []
    for make in (_engine, _jax_engine):
        eng = make(models, max_batch_slots=1, max_queue=16)
        reqs = [eng.submit([1 + i, 2, 3], tenant=t, max_new_tokens=2)
                for i, t in enumerate(["bulk"] * 4 + ["vip"] * 4)]
        order = []
        while not all(r.done for r in reqs):
            eng.step()
            order += [r.id for r in reqs if r.status != "queued"
                      and r.id not in order]
        out.append((order, [r.result() for r in reqs]))
    assert out[0] == out[1]
    assert out[0][0][:3].count(4) + out[0][0][:3].count(5) >= 1


def test_quota_429_retry_after(models, tmp_path, monkeypatch):
    _qos_config(tmp_path, monkeypatch, {
        "t": {"priority": "default", "quota_tokens_per_s": 10}})
    got = []
    for make in (_engine, _jax_engine):
        eng = make(models)
        eng.submit([1, 2, 3], tenant="t", max_new_tokens=8)
        with pytest.raises(Exception) as e:
            eng.submit([1, 2, 3], tenant="t", max_new_tokens=8)
        got.append((type(e.value).__name__, e.value.retry_after_s,
                     e.value.tenant))
        eng.run_until_idle()
    assert got[0] == got[1] and got[0][0] == QuotaExceededError.__name__


def test_predictive_shed_fails_hopeless_deadline(models):
    eng = _engine(models)
    eng.generate([1, 2, 3], max_new_tokens=2)
    eng.generate([1, 2, 3], max_new_tokens=2)   # warm prefill + decode
    eng._prefill_cost = {b: 10.0 for b in eng._prefill_cost}
    req = eng.submit([4, 5, 6], deadline_s=1.0)
    eng.run_until_idle()
    assert req.status == "failed" and req.shed
    assert hvd.metrics_snapshot()["hvdtpu_serving_shed_total"]["values"][
        'reason="deadline_pred"'] >= 1


def test_slo_verdicts_and_tenant_metrics(models):
    eng = _engine(models)
    plain = eng.submit([1, 2, 3])
    ok = eng.submit([1, 2, 3], tenant="gold",
                    slo={"ttft_ms": 1e6, "tpot_ms": 1e6})
    bad = eng.submit([4, 5, 6], tenant="gold", slo={"ttft_ms": 1e-4})
    bronze = eng.submit([7, 8, 9], tenant="bronze")
    eng.run_until_idle()
    assert plain.tenant is None and plain.slo_verdict is None
    assert ok.slo_verdict["slo_met"] is True
    assert bad.slo_verdict["slo_met"] is False
    assert bad.slo_verdict["ttft_violation"] is True
    assert bronze.tenant == "bronze" and bronze.slo_verdict is None
    snap = hvd.metrics_snapshot()
    assert snap["hvdtpu_slo_goodput_total"]["values"]['tenant="gold"'] >= 1
    assert snap["hvdtpu_slo_violations_total"]["values"][
        'reason="ttft",tenant="gold"'] >= 1
    ex = snap["hvdtpu_slo_violation_seconds"]["values"][
        'tenant="gold"'].get("exemplar")
    assert ex and ex["trace_id"] == bad.trace_id
    assert snap["hvdtpu_serving_requests_total"]["values"][
        'status="completed",tenant="bronze"'] >= 1
    assert snap["hvdtpu_serving_ttft_seconds"]["values"][""]["count"] >= 1


def test_queue_full_records_shed_with_tenant(models):
    eng = _engine(models, max_queue=1)
    eng.submit([1, 2, 3])
    with pytest.raises(QueueFullError):
        eng.submit([1, 2, 4], tenant="burst", slo={"ttft_ms": 100})
    assert hvd.metrics_snapshot()["hvdtpu_slo_violations_total"][
        "values"]['reason="shed",tenant="burst"'] >= 1
    eng.run_until_idle()


# ------------------------------------------------------------ reqtrace

def _rows_and_spans(path):
    from horovod_tpu_torch.ops.timeline_py import TRACE_META_EVENT
    events = json.loads(open(path).read())
    meta = [e for e in events if e.get("name") == TRACE_META_EVENT]
    spans = [(e["name"], sorted((e.get("args") or {}).keys()))
             for e in events if e.get("ph") == "X"]
    return meta, spans


def test_writer_meta_and_span_roundtrip(tmp_path):
    path = str(tmp_path / "t.json")
    w = trt.start(path, rank=3, proc="replica2")
    trt.span("abc.1", "PREFILL", 1.0, 1.5, {"bucket": 8})
    trt.stop()
    assert trt.writer() is None
    meta, spans = _rows_and_spans(path)
    assert meta[-1]["args"]["proc"] == "replica2"
    assert meta[-1]["args"]["rank"] == 3 and w.proc == "replica2"
    assert spans == [("PREFILL", ["bucket"])]


def test_engine_spans_match_jax(models, tmp_path):
    """One prefix-cached request and one plain one: the port's engine
    writes the spans JAX's writes, with the same args, in order."""
    got = []
    for make, rt, name in ((_engine, trt, "torch"), (_jax_engine, jrt,
                                                     "jax")):
        path = str(tmp_path / f"{name}.json")
        eng = make(models, prefix_cache=True)
        rt.start(path)
        try:
            for p in ([1, 2, 3, 4, 5, 6, 7], [1, 2, 3, 4, 5, 6, 8]):
                eng.submit(p, trace_id=f"req{p[-1]}", max_new_tokens=3)
                eng.run_until_idle()
        finally:
            rt.stop()
        got.append(_rows_and_spans(path)[1])
    assert got[0] == got[1]
    assert [n for n, _ in got[0]][:3] == ["QUEUE_WAIT", "ADMIT", "PREFILL"]


def test_ttft_exemplar_names_a_request(models):
    eng = _engine(models)
    req = eng.submit([3, 1, 4, 1, 5], trace_id="exemplar-req")
    eng.run_until_idle()
    ex = hvd.metrics_snapshot()["hvdtpu_serving_ttft_seconds"]["values"][
        ""].get("exemplar")
    assert req.status == "completed" and ex and ex["trace_id"]
