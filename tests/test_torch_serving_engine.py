"""The port's continuous-batching ``InferenceEngine`` against the JAX
package's, on the same seed-made parameters (JAX's ``init_params`` at
JAX's small config, fp32, carried over to the port's ``Transformer``):
the cases of ``tests/test_serving.py`` other than the fleet's, on the
CPU.

Every token comparison is exact: the two engines sample the same tokens
from logits that agree to 1e-5 (greedy), and the same seeded numpy
stream from them (temperature > 0). The scheduler's edges are JAX's own
assertions run on the port's engine.
"""

import dataclasses
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.checkpoint import CheckpointEngine as JaxCheckpointEngine
from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel.mesh import create_mesh as jax_mesh
from horovod_tpu.serving import InferenceEngine as JaxEngine
from horovod_tpu.serving import ServingConfig as JaxConfig
from horovod_tpu.serving import loader as jloader
from horovod_tpu_torch.adaptation import faults
from horovod_tpu_torch.checkpoint import checkpoint_hook
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.serving import (DEADLINE_ERROR, DrainingError,
                                       InferenceEngine, QueueFullError,
                                       ServingConfig, TORCH_MODEL_PREFIX,
                                       config_from_manifest, load_params,
                                       serving_config, transformer_extra)

SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, remat=False)
DRAFT = dict(vocab=64, d_model=16, n_heads=2, n_layers=1, d_ff=32,
             max_seq=64, remat=False)
ENGINE = dict(block_size=4, kv_blocks=40, max_batch_slots=4, max_queue=8,
              max_new_tokens=8, min_prefill_bucket=8)
LOOP_TIMEOUT_S = 30


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32))


def _pair(kw, seed, scale=1.0):
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **kw)
    params = jax.device_get(jax.tree_util.tree_map(
        lambda x: x * scale, jtfm.init_params(jcfg, jax.random.PRNGKey(seed))))
    model = ttfm.Transformer(ttfm.TransformerConfig(dtype=torch.float32,
                                                    **kw),
                             params=_torch_tree(params), device="cpu")
    return types.SimpleNamespace(jcfg=jcfg, params=params, model=model)


@pytest.fixture(scope="module")
def flagship():
    return _pair(SMALL, 0)


@pytest.fixture(scope="module")
def drafters():
    return {"random": _pair(DRAFT, 9), "zero": _pair(DRAFT, 9, 0.0)}


@pytest.fixture(scope="module")
def mesh1():
    return jax_mesh(devices=jax.devices()[:1], tp=1)


def _engine(f, drafter=None, **over):
    return InferenceEngine(f.model, ServingConfig(**dict(ENGINE, **over)),
                           drafter=None if drafter is None
                           else drafter.model, device="cpu")


def _jax_engine(f, mesh, drafter=None, **over):
    kw = {} if drafter is None else dict(draft_params=drafter.params,
                                         draft_cfg=drafter.jcfg)
    return JaxEngine(f.params, f.jcfg, mesh, JaxConfig(**dict(ENGINE, **over)),
                     **kw)


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 64, n)] for n in lengths]


def _run(eng, prompts, max_new_tokens=6, **kw):
    reqs = [eng.submit(p, max_new_tokens=max_new_tokens, **kw)
            for p in prompts]
    eng.run_until_idle()
    return [r.result(timeout=LOOP_TIMEOUT_S) for r in reqs]


def _snap(name, label=""):
    return hvd.metrics_snapshot().get(name, {"values": {}})["values"].get(
        label, 0)


# --------------------------------------------------------- against JAX

SHORT = _prompts(21, [3, 11, 7, 5, 9])
LONG = _prompts(7, [33, 3, 17, 9, 41])
SYSTEM = _prompts(33, [9])[0]
SHARED = [SYSTEM + p for p in _prompts(34, [3, 3, 3])]

# name: (engine levers, drafter, prompts, submit kwargs)
LEVERS = {
    "greedy": (dict(), None, SHORT, {}),
    "one_slot": (dict(max_batch_slots=1), None, SHORT, {}),
    "int8": (dict(kv_quant="int8"), None, SHORT, {}),
    "fp8": (dict(kv_quant="fp8"), None, SHORT, {}),
    "prefix_cache": (dict(prefix_cache=True), None, SHARED, {}),
    "chunked": (dict(prefill_chunk=8, kv_blocks=64), None, LONG, {}),
    "spec_self": (dict(spec_tokens=4), "self", SHORT, {}),
    "spec_random": (dict(spec_tokens=3), "random", SHORT, {}),
    "spec_adapt_zero": (dict(spec_tokens=4, spec_adapt=True,
                             max_new_tokens=24), "zero",
                        [[7, 3, 11], [2] * 5, [40, 1]],
                        dict(max_new_tokens=24)),
    "all_levers": (dict(kv_quant="int8", prefix_cache=True, spec_tokens=4,
                        prefill_chunk=8, kv_blocks=64), "self",
                   SHARED + LONG[:2], {}),
    "sampled": (dict(temperature=1.0, seed=5), None, SHORT, {}),
    "sampled_spec": (dict(temperature=1.0, seed=5, spec_tokens=4), "self",
                     SHORT, {}),
    "eos": (dict(eos_id=13, max_new_tokens=16), None, SHORT,
            dict(max_new_tokens=16)),
}


@pytest.mark.parametrize("name", sorted(LEVERS))
def test_tokens_match_jax(flagship, drafters, mesh1, name):
    levers, dname, prompts, kw = LEVERS[name]
    drafter = {None: None, "self": flagship}.get(dname) or drafters.get(
        dname)
    kw = dict(dict(max_new_tokens=6), **kw)
    got = _run(_engine(flagship, drafter, **levers), prompts, **kw)
    want = _run(_jax_engine(flagship, mesh1, drafter, **levers), prompts,
                **kw)
    assert got == want


def test_session_turns_match_jax(flagship, mesh1):
    out = []
    for eng in (_engine(flagship), _jax_engine(flagship, mesh1)):
        ctx = [7] * 9
        t1 = _run(eng, [ctx], max_new_tokens=4, session_id="conv")[0]
        turn2 = ctx + t1 + [9, 11]
        r2 = eng.submit(turn2, max_new_tokens=4, session_id="conv")
        eng.run_until_idle()
        out.append((t1, r2.result(timeout=LOOP_TIMEOUT_S), r2.cached_tokens, eng.session_ids()))
    assert out[0] == out[1]
    assert out[0][2] == 9 + 4 - 1


# ------------------------------------------------------------- engine

def test_batched_equals_sequential(flagship):
    prompts = _prompts(0, [3, 11, 7, 5, 9])
    batched = _run(_engine(flagship), prompts)
    solo = _engine(flagship, max_batch_slots=1)
    assert batched == [solo.generate(p, max_new_tokens=6) for p in prompts]


def test_pool_is_written_in_place(flagship):
    eng = _engine(flagship, kv_quant="int8")
    ptrs = [t.data_ptr() for layer in eng._cache for t in layer.values()]
    _run(eng, SHORT)
    assert [t.data_ptr() for layer in eng._cache
            for t in layer.values()] == ptrs
    assert eng._cache[0]["k"].view(torch.uint8).any()


def test_queue_full_rejects(flagship):
    eng = _engine(flagship, max_queue=2)
    eng.submit([1, 2, 3])
    eng.submit([4, 5, 6])
    before = _snap("hvdtpu_serving_requests_total", 'status="rejected"')
    with pytest.raises(QueueFullError):
        eng.submit([7, 8, 9])
    assert _snap("hvdtpu_serving_requests_total",
                 'status="rejected"') == before + 1
    eng.run_until_idle()


def test_kv_exhaustion_defers_admission(flagship):
    ref = _engine(flagship)
    eng = _engine(flagship, kv_blocks=8)
    p1, p2 = [1] * 9, [2] * 9
    r1, r2 = eng.submit(p1), eng.submit(p2)
    assert eng.step()
    assert eng.active_count == 1 and eng.queue_depth == 1
    assert r2.status == "queued"
    eng.run_until_idle()
    assert r1.result(timeout=LOOP_TIMEOUT_S) == ref.generate(p1)
    assert r2.result(timeout=LOOP_TIMEOUT_S) == ref.generate(p2)
    assert eng._alloc.in_use == 0


def test_oversized_request_rejected_upfront(flagship):
    eng = _engine(flagship, kv_blocks=4)
    with pytest.raises(ValueError, match="KV blocks"):
        eng.submit([1] * 9, max_new_tokens=8)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit([1] * 60, max_new_tokens=8)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([])
    with pytest.raises(ValueError, match="out of range"):
        eng.submit([64])


def test_mid_stream_eviction_on_max_tokens(flagship):
    ref = _engine(flagship)
    eng = _engine(flagship, kv_blocks=10, max_batch_slots=2)
    long = eng.submit([3] * 5, max_new_tokens=8)
    short = eng.submit([4] * 5, max_new_tokens=3)
    third = eng.submit([5] * 5, max_new_tokens=3)
    eng.step()
    assert eng.active_count == 2 and third.status == "queued"
    while not short.done:
        eng.step()
    assert not long.done
    eng.run_until_idle()
    assert long.result(timeout=LOOP_TIMEOUT_S) == ref.generate([3] * 5, max_new_tokens=8)
    assert short.result(timeout=LOOP_TIMEOUT_S) == ref.generate([4] * 5, max_new_tokens=3)
    assert third.result(timeout=LOOP_TIMEOUT_S) == ref.generate([5] * 5, max_new_tokens=3)


def test_eos_stops_generation(flagship):
    probe = _engine(flagship).generate([6] * 4, max_new_tokens=8)
    eos = probe[1]
    out = _engine(flagship, eos_id=eos).generate([6] * 4, max_new_tokens=8)
    assert out == probe[:out.index(eos) + 1]
    assert out[-1] == eos and len(out) < 8
    spec = _engine(flagship, flagship, eos_id=eos, spec_tokens=4)
    assert spec.generate([6] * 4, max_new_tokens=8) == out


def test_drain_completes_accepted_rejects_new(flagship):
    eng = _engine(flagship, max_batch_slots=1)
    active = eng.submit([7] * 4, max_new_tokens=4)
    queued = eng.submit([8] * 4, max_new_tokens=4)
    eng.step()
    eng.drain()
    assert active.status == "completed" and len(active.result(timeout=1.0)) == 4
    assert queued.status == "completed" and len(queued.result(timeout=1.0)) == 4
    with pytest.raises(DrainingError):
        eng.submit([9] * 4)


def test_temperature_sampling_is_seeded(flagship):
    outs = [_engine(flagship, temperature=1.0, seed=3).generate(
        [5, 6, 7], max_new_tokens=6) for _ in range(2)]
    assert outs[0] == outs[1]


def test_expired_deadline_fails_at_admission(flagship):
    eng = _engine(flagship)
    live = eng.submit([1, 2, 3], max_new_tokens=2)
    expired = eng.submit([4, 5, 6], deadline_s=-0.001)
    eng.run_until_idle()
    assert live.status == "completed"
    assert expired.status == "failed" and expired.error == DEADLINE_ERROR
    with pytest.raises(RuntimeError, match="deadline"):
        expired.result(timeout=1.0)


def test_next_tokens_streams_incrementally(flagship):
    eng = _engine(flagship)
    req = eng.submit([3, 1, 4], max_new_tokens=5)
    got, steps = [], 0
    while not (req.done and len(got) == len(req.tokens)):
        if not req.done:
            eng.step()
            steps += 1
            assert steps < 100
        got.extend(req.next_tokens(len(got), timeout=5.0))
    assert got == req.result(timeout=1.0)
    assert req.next_tokens(len(got), timeout=0.5) == []


def test_retry_after_tracks_drain_rate(flagship):
    eng = _engine(flagship, max_queue=16)
    assert eng.retry_after_s() == 1
    for _ in range(4):
        eng.generate([1, 2], max_new_tokens=2)
    assert eng.retry_after_s() == 1
    for _ in range(8):
        eng.submit([1, 2], max_new_tokens=2)
    assert eng.retry_after_s() == 20
    eng.run_until_idle()


@pytest.fixture
def fault_spec(monkeypatch):
    def arm(spec, replica=None):
        monkeypatch.setenv("HOROVOD_TPU_FAULT_SPEC", spec)
        if replica is None:
            monkeypatch.delenv("HOROVOD_TPU_REPLICA_ID", raising=False)
        else:
            monkeypatch.setenv("HOROVOD_TPU_REPLICA_ID", str(replica))
        faults.reset()
    yield arm
    monkeypatch.delenv("HOROVOD_TPU_FAULT_SPEC", raising=False)
    faults.reset()


def test_drain_during_slow_prefill_completes_accepted(flagship, fault_spec):
    fault_spec("rank=0:slow_prefill=300ms", replica=0)
    eng = _engine(flagship, max_batch_slots=1)
    assert eng._inj is not None
    r1 = eng.submit([7] * 4, max_new_tokens=4)
    r2 = eng.submit([8] * 4, max_new_tokens=4)
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            if not eng.step():
                time.sleep(0.005)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    time.sleep(0.05)
    eng.drain()
    stop.set()
    t.join(timeout=LOOP_TIMEOUT_S)
    assert not t.is_alive()
    assert r1.status == "completed" and len(r1.result(timeout=1.0)) == 4
    assert r2.status == "completed" and len(r2.result(timeout=1.0)) == 4
    assert _snap("hvdtpu_fault_injections_total",
                 'kind="slow_prefill"') >= 1


def test_counters_gauges_and_shape_buckets(flagship):
    """``hvdtpu_serving_compiles_total`` counts each (phase, shape)
    bucket's first use: one decode shape, one per prefill bucket."""
    eng = _engine(flagship)
    before = {p: _snap("hvdtpu_serving_compiles_total", f'phase="{p}"')
              for p in ("decode", "prefill")}
    eng.generate([1, 2, 3, 4], max_new_tokens=4)
    eng.generate([1] * 12, max_new_tokens=4)
    eng.generate([2] * 5, max_new_tokens=4)
    assert _snap("hvdtpu_serving_compiles_total",
                 'phase="decode"') - before["decode"] == 1
    assert _snap("hvdtpu_serving_compiles_total",
                 'phase="prefill"') - before["prefill"] == 2   # 8, 16
    snap = hvd.metrics_snapshot()
    assert snap["hvdtpu_serving_ttft_seconds"]["values"][""]["count"] >= 1
    assert snap["hvdtpu_serving_tpot_seconds"]["values"][""]["count"] >= 1
    assert snap["hvdtpu_serving_tokens_total"]["values"][
        'kind="generated"'] >= 12
    assert snap["hvdtpu_serving_kv_blocks_total"]["values"][""] == 39


def test_kv_bytes_resident_gauge(flagship):
    eng = _engine(flagship, kv_quant="int8")
    eng.submit([1] * 9, max_new_tokens=8)
    eng.step()
    assert _snap("hvdtpu_serving_kv_bytes_resident") == \
        eng._alloc.in_use * ttfm.kv_bytes_per_block(flagship.model.cfg, 4,
                                                    "int8")
    eng.run_until_idle()


def test_quantized_pool_holds_more_sequences_per_byte():
    cfg = ttfm.TransformerConfig(vocab=32, d_model=128, n_heads=2,
                                 n_layers=1, d_ff=64, max_seq=32,
                                 dtype=torch.float32, remat=False)
    model = ttfm.Transformer(cfg, device="cpu")
    budget = 8 * ttfm.kv_bytes_per_block(cfg, 8)
    admitted = {}
    for kv in (None, "int8"):
        per = ttfm.kv_bytes_per_block(cfg, 8, kv)
        eng = InferenceEngine(model, ServingConfig(
            block_size=8, kv_blocks=budget // per + 1, max_batch_slots=16,
            max_queue=32, max_new_tokens=8, min_prefill_bucket=8,
            kv_quant=kv), device="cpu")
        for _ in range(16):
            eng.submit([1] * 9, max_new_tokens=8)
        eng.step()
        admitted[kv] = eng.active_count
        assert eng._alloc.in_use * per <= budget
        eng.run_until_idle()
    assert admitted[None] == 4 and admitted["int8"] >= 15


# ------------------------------------------------------- speculative

def test_draft_counters_and_bounds(flagship, drafters):
    before = [_snap(f"hvdtpu_serving_draft_{k}_tokens_total")
              for k in ("proposed", "accepted")]
    spec = _engine(flagship, drafters["random"], spec_tokens=4)
    assert len(spec.generate([5, 9, 2], max_new_tokens=6)) == 6
    prop, acc = [_snap(f"hvdtpu_serving_draft_{k}_tokens_total") - b
                 for k, b in zip(("proposed", "accepted"), before)]
    assert prop > 0 and 0 <= acc <= prop


def test_speculative_config_validation(flagship, drafters):
    with pytest.raises(ValueError, match="drafter"):
        _engine(flagship, spec_tokens=4)
    with pytest.raises(ValueError, match="drafter"):
        _engine(flagship, spec_tokens=4, spec_adapt=True)
    bad = ttfm.Transformer(ttfm.TransformerConfig(
        dtype=torch.float32, **dict(DRAFT, vocab=32)), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        InferenceEngine(flagship.model, ServingConfig(spec_tokens=4),
                        drafter=bad, device="cpu")
    with pytest.raises(ValueError, match=">= 2"):
        _engine(flagship, drafters["random"], spec_tokens=1)


def test_spec_adapt_backs_off_and_probes(flagship, drafters):
    eng = _engine(flagship, drafters["zero"], spec_tokens=4,
                  spec_adapt=True, max_new_tokens=64)
    probes = _snap("hvdtpu_autotune_spec_moves_total", 'direction="probe"')
    out = eng.generate([5, 9, 2], max_new_tokens=40)
    assert out == _engine(flagship).generate([5, 9, 2], max_new_tokens=40)
    assert max(s.k_eff for s in eng._spec_ctl._slots.values()) <= 2
    assert _snap("hvdtpu_autotune_spec_moves_total",
                 'direction="probe"') > probes
    full = _engine(flagship, flagship, spec_tokens=4, spec_adapt=True)
    assert full.generate([1, 2, 3]) == _engine(flagship).generate([1, 2, 3])
    assert all(s.k_eff == 4 for s in full._spec_ctl._slots.values())


# ------------------------------------------------------- prefix cache

def _hits():
    return _snap("hvdtpu_serving_prefix_cache_hits_total")


def test_prefix_cache_hits_and_matches_uncached(flagship):
    ref = _engine(flagship).generate([7] * 13, max_new_tokens=6)
    eng = _engine(flagship, prefix_cache=True)
    h0 = _hits()
    assert eng.generate([7] * 13, max_new_tokens=6) == ref
    h1 = _hits()
    assert eng.generate([7] * 13, max_new_tokens=6) == ref
    assert (h1 - h0, _hits() - h1) == (0, 3)
    system = [3] * 8
    plain = _engine(flagship)
    for tail in ([1, 2, 3], [4, 5, 6]):
        h = _hits()
        assert eng.generate(system + tail, max_new_tokens=5) == \
            plain.generate(system + tail, max_new_tokens=5)
    assert _hits() - h == 2
    h = _hits()
    eng.generate([2, 3, 4], max_new_tokens=3)
    eng.generate([2, 3, 4], max_new_tokens=3)
    assert _hits() == h


def test_prefix_sharing_and_pool_pressure(flagship):
    eng = _engine(flagship, prefix_cache=True, max_batch_slots=2)
    r1 = eng.submit([9] * 13, max_new_tokens=4)
    r2 = eng.submit([9] * 13, max_new_tokens=4)
    eng.step()
    assert eng._alloc.in_use == 5
    eng.run_until_idle()
    assert r1.result(timeout=LOOP_TIMEOUT_S) == r2.result(timeout=1.0) and eng._alloc.in_use == 3
    eng = _engine(flagship, kv_blocks=7, prefix_cache=True)
    plain = _engine(flagship)
    for p in ([5] * 13, [6] * 13):
        assert eng.generate(p, max_new_tokens=4) == \
            plain.generate(p, max_new_tokens=4)
    assert len(eng._prefix) == 5
    assert eng._alloc.in_use == 5 and eng._alloc.free == 1


# --------------------------------------------------- chunked prefill

def test_decode_proceeds_between_chunks(flagship):
    ref = _engine(flagship)
    eng = _engine(flagship, prefill_chunk=8)
    short = eng.submit([5, 6, 7], max_new_tokens=8)
    eng.step()
    long = eng.submit([9] * 33, max_new_tokens=4)
    eng.step()
    assert long.prefill_pos is not None
    while long.prefill_pos is not None:
        before = len(short.tokens)
        eng.step()
        if not short.done:
            assert len(short.tokens) == before + 1
    eng.run_until_idle()
    assert short.result(timeout=LOOP_TIMEOUT_S) == ref.generate([5, 6, 7], max_new_tokens=8)
    assert long.result(timeout=LOOP_TIMEOUT_S) == ref.generate([9] * 33, max_new_tokens=4)


def test_chunk_metrics_and_tick_histogram(flagship):
    before = _snap("hvdtpu_serving_prefill_chunks_total")
    _engine(flagship, prefill_chunk=8).generate([1] * 33, max_new_tokens=4)
    assert _snap("hvdtpu_serving_prefill_chunks_total") - before == 5
    assert hvd.metrics_snapshot()["hvdtpu_serving_decode_tick_seconds"][
        "values"][""]["count"] >= 1


def test_chunked_pool_exhaustion_and_eviction(flagship):
    ref = _engine(flagship)
    eng = _engine(flagship, prefill_chunk=8, kv_blocks=13)
    long = eng.submit([3] * 33, max_new_tokens=4)
    eng.step()
    assert long.prefill_pos is not None
    p2 = eng.submit([4] * 9, max_new_tokens=8)
    eng.step()
    assert p2.status == "queued"
    eng.run_until_idle()
    assert long.result(timeout=LOOP_TIMEOUT_S) == ref.generate([3] * 33, max_new_tokens=4)
    assert p2.result(timeout=LOOP_TIMEOUT_S) == ref.generate([4] * 9, max_new_tokens=8)
    assert eng._alloc.in_use == 0
    eng = _engine(flagship, prefill_chunk=8)
    short = eng.submit([5] * 4, max_new_tokens=3)
    eng.step()
    long = eng.submit([6] * 41, max_new_tokens=4)
    steps = 0
    while not short.done:
        eng.step()
        steps += 1
        assert steps < 50
    assert long.prefill_pos is not None
    eng.run_until_idle()
    assert long.result(timeout=LOOP_TIMEOUT_S) == ref.generate([6] * 41, max_new_tokens=4)


def test_budget_halves_chunk_under_measured_cost(flagship, monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_SERVING_TICK_BUDGET_MS", "50")
    eng = _engine(flagship, prefill_chunk=32)
    lens = [eng._chunk_len(100)]
    for bucket, cost in ((32, 0.2), (16, 0.08), (8, 0.2)):
        eng._note_chunk_cost(bucket, cost)
        lens.append(eng._chunk_len(100))
    for _ in range(4):
        eng._note_chunk_cost(32, 0.0)
    assert lens == [32, 16, 8, 8]
    assert eng._chunk_cost[32] == pytest.approx(0.0125)
    assert eng._chunk_len(100) == 32


def test_retry_after_accounts_chunk_backlog(flagship):
    cold = _engine(flagship, prefill_chunk=8, max_queue=16)
    cold._chunk_cost[8] = 0.5
    cold.submit([2] * 33, max_new_tokens=2)
    assert cold.retry_after_s() == 3
    cold.run_until_idle()
    eng = _engine(flagship, prefill_chunk=8, max_queue=16)
    for _ in range(4):
        eng.generate([1, 2], max_new_tokens=2)
    eng._chunk_cost[8] = 0.5
    for _ in range(2):
        eng.submit([2] * 33, max_new_tokens=2)
    assert eng.retry_after_s() == 10
    eng.run_until_idle()


def test_long_prompt_burst_fault_injects_requests(flagship, fault_spec):
    fault_spec("rank=*:long_prompt_burst=2x33:from_step=2")
    fired = _snap("hvdtpu_fault_injections_total",
                  'kind="long_prompt_burst"')
    done = _snap("hvdtpu_serving_requests_total", 'status="completed"')
    eng = _engine(flagship, prefill_chunk=8, kv_blocks=64)
    eng.generate([1, 2, 3], max_new_tokens=8)
    eng.run_until_idle()
    assert _snap("hvdtpu_fault_injections_total",
                 'kind="long_prompt_burst"') - fired == 2
    assert _snap("hvdtpu_serving_requests_total",
                 'status="completed"') - done == 3


# --------------------------------------------------- session leases

def test_session_lease_reuse_and_divergence(flagship):
    ref = _engine(flagship)
    eng = _engine(flagship)
    ctx = [7] * 9
    t1 = _run(eng, [ctx], max_new_tokens=4, session_id="conv")[0]
    hits = _snap("hvdtpu_serving_session_hits_total")
    turn2 = ctx + t1 + [9, 11]
    r2 = eng.submit(turn2, max_new_tokens=4, session_id="conv")
    eng.run_until_idle()
    assert r2.cached_tokens == len(ctx) + len(t1) - 1
    assert r2.result(timeout=LOOP_TIMEOUT_S) == ref.generate(turn2, max_new_tokens=4)
    assert _snap("hvdtpu_serving_session_hits_total") - hits == 1
    div = [1, 2, 3, 4, 5]
    r3 = eng.submit(div, max_new_tokens=4, session_id="conv")
    eng.run_until_idle()
    assert r3.cached_tokens == 0
    assert r3.result(timeout=LOOP_TIMEOUT_S) == ref.generate(div, max_new_tokens=4)
    assert eng.session_ids() == ["conv"]


def test_session_lease_pressure_and_caps(flagship):
    eng = _engine(flagship, prefix_cache=True)
    _run(eng, [[5] * 6], max_new_tokens=8, session_id="s1")
    assert len(eng._prefix) == 1 and eng._alloc.in_use == 4
    assert eng._free_pressure() and eng.session_ids() == ["s1"]
    assert eng._free_pressure() and eng.session_ids() == []
    assert len(eng._prefix) == 3 and eng._alloc.in_use == 3
    ref = _engine(flagship)
    eng = _engine(flagship, kv_blocks=13)
    _run(eng, [[5] * 13], max_new_tokens=4, session_id="s1")
    ev = _snap("hvdtpu_serving_session_evictions_total")
    assert _run(eng, [[6] * 33], max_new_tokens=4) == \
        [ref.generate([6] * 33, max_new_tokens=4)]
    assert eng.session_ids() == []
    assert _snap("hvdtpu_serving_session_evictions_total") - ev == 1
    eng = _engine(flagship, session_leases=2)
    for i, sid in enumerate(("a", "b", "c")):
        _run(eng, [[i + 1] * 5], max_new_tokens=2, session_id=sid)
    assert eng.session_ids() == ["b", "c"]
    eng = _engine(flagship, session_leases=0)
    _run(eng, [[3] * 7], max_new_tokens=4, session_id="x")
    assert eng.session_ids() == [] and eng._alloc.in_use == 0


def test_session_lease_with_chunked_prefill(flagship):
    ref = _engine(flagship)
    eng = _engine(flagship, prefill_chunk=8)
    ctx = [3] * 20
    t1 = _run(eng, [ctx], session_id="c")[0]
    turn2 = ctx + t1 + [1, 2]
    r2 = eng.submit(turn2, max_new_tokens=6, session_id="c")
    eng.run_until_idle()
    assert r2.cached_tokens == len(ctx) + 5
    assert r2.result(timeout=LOOP_TIMEOUT_S) == ref.generate(turn2, max_new_tokens=6)


# ----------------------------------------------------- refusals

def test_engine_refuses_tp_mesh_sp_and_wrong_device(flagship, drafters):
    """A tp mesh of more than one rank is served (rank 0 schedules, the
    others follow: tests/test_torch_serving_tp.py); under it the engine
    refuses a drafter on a mesh other than the flagship's, as JAX's
    requires one mesh for both."""
    class _Mesh:
        mesh_dim_names = ("tp",)

        def size(self, i):
            return 2

    cpu = torch.device("cpu")
    tp = types.SimpleNamespace(cfg=dataclasses.replace(
        flagship.model.cfg, tp_axis="tp"), mesh=_Mesh(), device=cpu)
    draft = types.SimpleNamespace(cfg=dataclasses.replace(
        drafters["random"].model.cfg, tp_axis="tp"), mesh=_Mesh(),
        device=cpu)
    with pytest.raises(ValueError, match="one mesh") as e:
        InferenceEngine(tp, ServingConfig(spec_tokens=2), drafter=draft,
                        device="cpu")
    assert "4c" not in str(e.value)
    sp = types.SimpleNamespace(cfg=dataclasses.replace(
        flagship.model.cfg, sp_axis="sp"), mesh=None)
    with pytest.raises(ValueError, match="serving_config"):
        InferenceEngine(sp, device="cpu")
    meta = types.SimpleNamespace(cfg=flagship.model.cfg, mesh=None,
                                 device=torch.device("meta"))
    with pytest.raises(ValueError, match="the model is on meta"):
        InferenceEngine(meta, device="cpu")


# ------------------------------------------------------------ loader

def _save_jax_ws4(path, flagship):
    from jax.sharding import NamedSharding, PartitionSpec as P
    train_cfg = dataclasses.replace(flagship.jcfg, tp_axis="tp")
    mesh = jax_mesh(dp=2, tp=4)
    sharded = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        flagship.params, jtfm.param_specs(train_cfg),
        is_leaf=lambda x: isinstance(x, P))
    # The four simulated processes write in turn, rank 0 last: its
    # commit reads every process's sidecars, and the barrier is a no-op.
    for p in (1, 2, 3, 0):
        eng = JaxCheckpointEngine(
            str(path), process_index=p, process_count=4,
            process_fn=lambda d: d.id // 2, barrier=lambda n: None)
        eng.save(sharded, 7, extra=jloader.transformer_extra(train_cfg))
        eng.wait()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def test_jax_commit_serves_in_the_port(tmp_path, flagship, mesh1):
    """A JAX tp=4 commit over 4 processes, with JAX's
    ``transformer_extra``: the port rebuilds the config, loads the
    parameters bit for bit and serves JAX's engine's tokens."""
    _save_jax_ws4(tmp_path, flagship)
    from horovod_tpu_torch.checkpoint import CheckpointEngine
    man = CheckpointEngine(str(tmp_path)).restore_manifest()
    cfg = serving_config(config_from_manifest(man))
    assert cfg == dataclasses.replace(flagship.model.cfg, tp_axis=None)
    params = load_params(str(tmp_path), cfg, device="cpu")
    for a, b in zip(_leaves(params), _leaves(flagship.params)):
        np.testing.assert_array_equal(a, b)
    model = ttfm.Transformer(cfg, params=params, device="cpu")
    eng = InferenceEngine(model, ServingConfig(**ENGINE), device="cpu")
    assert _run(eng, SHORT) == _run(_jax_engine(flagship, mesh1), SHORT)


@pytest.mark.parametrize("form", ["tree", "state_dict"])
def test_port_commit_serves(tmp_path, flagship, mesh1, form):
    """The port's ``checkpoint_hook`` commit (the model under
    ``['model']``, an optimizer beside it) loads bit for bit in the
    port, in both key forms, and, as the parameter tree, in JAX's
    ``load_params(key_prefix=TORCH_MODEL_PREFIX)``, whose engine then
    gives the port's tokens."""
    model = flagship.model
    tree_model = types.SimpleNamespace(state_dict=model.params_tree)
    opt = types.SimpleNamespace(state_dict=lambda: {
        "state": {"momentum": torch.zeros(8)}})
    save = checkpoint_hook(str(tmp_path), model=tree_model
                           if form == "tree" else model, optimizer=opt,
                           every=1, extra=transformer_extra(model.cfg))
    save(3, block=True)
    from horovod_tpu_torch.checkpoint import CheckpointEngine
    man = CheckpointEngine(str(tmp_path)).restore_manifest()
    cfg = serving_config(config_from_manifest(man))
    params = load_params(str(tmp_path), cfg, key_prefix=TORCH_MODEL_PREFIX,
                         device="cpu")
    for a, b in zip(_leaves(params), _leaves(flagship.params)):
        np.testing.assert_array_equal(a, b)
    got = _run(InferenceEngine(ttfm.Transformer(cfg, params=params,
                                                device="cpu"),
                               ServingConfig(**ENGINE), device="cpu"),
               SHORT)
    if form == "state_dict":
        assert got == _run(_engine(flagship), SHORT)
        return
    jman = JaxCheckpointEngine(str(tmp_path)).restore_manifest()
    jcfg = jloader.serving_config(jloader.config_from_manifest(jman), mesh1)
    jparams = jloader.load_params(str(tmp_path), jcfg, mesh1,
                                  key_prefix=jloader.TORCH_MODEL_PREFIX)
    for a, b in zip(_leaves(jax.device_get(jparams)),
                    _leaves(flagship.params)):
        np.testing.assert_array_equal(a, b)
    jeng = JaxEngine(jparams, jcfg, mesh1, JaxConfig(**ENGINE))
    assert got == _run(jeng, SHORT)


def test_manifest_extra_is_the_same_json(flagship):
    assert transformer_extra(flagship.model.cfg) == \
        jloader.transformer_extra(flagship.jcfg)
    bf16 = dataclasses.replace(flagship.model.cfg, dtype=torch.bfloat16)
    man = {"extra": jloader.transformer_extra(dataclasses.replace(
        flagship.jcfg, dtype=jnp.bfloat16))}
    assert config_from_manifest(man) == bf16
    with pytest.raises(KeyError, match="transformer_config"):
        config_from_manifest({"extra": {}})


def test_unprefixed_load_rejects_unknown_leaves(tmp_path, flagship):
    from horovod_tpu_torch.checkpoint import CheckpointEngine
    eng = CheckpointEngine(str(tmp_path), process_count=1,
                           barrier=lambda n: None)
    eng.save({"model": flagship.model.params_tree(), "extra": torch.ones(2)},
             1, block=True, extra=transformer_extra(flagship.model.cfg))
    with pytest.raises(KeyError, match="param_specs"):
        load_params(str(tmp_path), flagship.model.cfg, device="cpu")
