"""The port's numerics plane (``horovod_tpu_torch/observability/
numerics.py``) against the JAX package's
(``horovod_tpu/observability/numerics.py``): the counterpart of
``tests/test_numerics.py``.

In this process, each case of ``tests/test_numerics.py`` on the same
numpy inputs through both packages: nonfinite counts exact (numpy
arrays and tensors), the payload sentinel, the deferred step stats,
digests of fp32 and bf16 leaves equal to JAX's ``fingerprint_tree``,
majority verdicts, the ``bitflip_param`` hook choosing the same leaf by
the same ``leaf=`` spec, the policy's quality backoff and the
checkpoint manifest's value fingerprints.

Then spawned gloo jobs (2 layers, d_model 64, each with its own time
limit):

- 2 ranks: the armed mesh step's aux (grad norm, update ratio within
  1e-5 relative, the per-rank nonfinite vector exact) against JAX's
  ``build_train_step`` aux on the same mesh of virtual CPU devices at
  dp = 2, dp = 2 with ZeRO-1, tp = 2, and the dp ``TrainStep`` at 2
  ranks; the plane-off step runs no extra ``all_reduce`` and its
  parameters equal the armed step's bit for bit. dp = 1 runs here.
- 3 ranks on the dp ``TrainStep``: ``bitflip_param`` on rank 1 is named
  by rank 0's fingerprint compare, leaf by its JAX keypath; ``nan_at``
  on rank 1 is named as rank 1.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from horovod_tpu_torch.observability import numerics as tnum

JOB_TIMEOUT_S = 240
CFG = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_seq=16, remat=False)
LR, WD = 1e-2, 1e-4
STEPS = 2
REL_TOL = 1e-5
# name: (mesh axes, config options, ZeRO-1); "dp_engine" is the dp
# TrainStep through the engine, held to JAX's dp = 2 mesh step.
MESHES = {"dp2": (dict(dp=2), {}, False),
          "dp2_zero1": (dict(dp=2), {}, True),
          "tp2": (dict(tp=2), dict(tp_axis="tp"), False)}
FAULT_WORLD = 3
FLIP_STEP = 1
# Each dp step of the fault job enqueues four requests (one bucket, the
# loss, the numerics vector, a barrier): tick 8 is step 2's bucket, the
# job's last step.
NAN_TICK = 8


@pytest.fixture(autouse=True)
def _planes():
    """Both planes armed, no pending digests left behind."""
    from horovod_tpu.observability import numerics as jnum
    for m in (jnum, tnum):
        m.set_enabled(True)
        m.reset_fingerprints()
    tnum._monitor = None        # a fresh monitor: no refire suppression
    yield
    for m in (jnum, tnum):
        m.step_stats().flush()
        m.set_enabled(False)
        m.reset_fingerprints()


def _counter(snapshot, family, key):
    snap = snapshot(prefix=family)
    return (snap.get(family) or {"values": {}})["values"].get(key, 0)


def _jcounter(family, key):
    import horovod_tpu as hvd
    return _counter(hvd.metrics_snapshot, family, key)


def _tcounter(family, key):
    from horovod_tpu_torch.observability import registry
    return _counter(registry.snapshot, family, key)


# ---------------------------------------------------------------------------
# Nonfinite sentinels
# ---------------------------------------------------------------------------

def _clean():
    return np.arange(1024, dtype=np.float32)


def _exact():
    a = np.zeros(64, np.float32)
    a[3] = np.nan
    a[10], a[11] = np.inf, -np.inf
    return a


def _overflow():
    return np.full(16, 3e19, np.float32)


def _multidim():
    a = np.ones((4, 4), np.float32)
    a[1, 2] = np.nan
    return a


@pytest.mark.parametrize("make", [_clean, _exact, lambda: np.arange(8),
                                  _overflow, _multidim],
                         ids=["clean", "exact", "integer", "overflow",
                              "multidim"])
def test_count_nonfinite_matches_jax(make):
    from horovod_tpu.observability import numerics as jnum
    a = make()
    want = jnum.count_nonfinite(a)
    assert tnum.count_nonfinite(a) == want
    assert tnum.count_nonfinite(torch.from_numpy(a)) == want


def test_scan_payload_disabled_is_noop():
    from horovod_tpu.observability import numerics as jnum
    a = np.full(8, np.nan, np.float32)
    jnum.set_enabled(False)
    tnum.set_enabled(False)
    assert tnum.scan_payload(a) == jnum.scan_payload(a) == 0


def test_scan_payload_counts_and_alerts():
    from horovod_tpu.observability import numerics as jnum
    fam, key = "hvdtpu_numerics_nonfinite_total", 'source="collective"'
    akey = 'kind="nonfinite_rate",severity="critical"'
    a = np.ones(128, np.float32)
    a[17] = np.nan
    before = _tcounter(fam, key)
    assert tnum.scan_payload(torch.from_numpy(a)) == jnum.scan_payload(a) == 1
    assert _tcounter(fam, key) == before + 1
    assert _tcounter("hvdtpu_health_alerts_total", akey) >= 1


# ---------------------------------------------------------------------------
# Deferred step stats
# ---------------------------------------------------------------------------

def _gauge(snapshot, name):
    return snapshot(prefix=name)[name]["values"][""]


def _snapshot(m):
    import horovod_tpu as hvd
    from horovod_tpu_torch.observability import registry
    return registry.snapshot if m is tnum else hvd.metrics_snapshot


def _both(fn):
    """Run ``fn(numerics_module, to_value)`` on both packages: numpy
    values for JAX, tensors for the port."""
    from horovod_tpu.observability import numerics as jnum
    fn(jnum, lambda v: v)
    fn(tnum, lambda v: torch.from_numpy(np.asarray(v)))


def test_step_stats_one_step_deferral():
    seen = {}

    def run(m, val):
        snap = _snapshot(m)
        stats = m.StepStats()
        stats.note(0, val(np.float32(1.0)), {
            "grad_norm": val(np.float32(2.5)),
            "update_ratio": val(np.float32(0.01)),
            "nonfinite_by_rank": val(np.zeros(2, np.float32))})
        stats.note(1, val(np.float32(0.9)),
                   {"grad_norm": val(np.float32(3.5))})
        first = _gauge(snap, "hvdtpu_numerics_grad_norm")
        stats.flush()
        seen[m is tnum] = (first, _gauge(snap, "hvdtpu_numerics_grad_norm"),
                           _gauge(snap, "hvdtpu_numerics_loss"))
    _both(run)
    assert seen[True] == pytest.approx(seen[False])
    assert seen[True][0] == pytest.approx(2.5)      # step 0, not step 1


@pytest.mark.parametrize("case", ["per_rank_vector", "nonfinite_loss"])
def test_step_stats_nonfinite_matches_jax(case):
    fam = "hvdtpu_numerics_nonfinite_total"
    key = 'source="grad"' if case == "per_rank_vector" else 'source="loss"'
    deltas = {}

    def run(m, val):
        count = _tcounter if m is tnum else _jcounter
        before = count(fam, key)
        stats = m.StepStats()
        if case == "per_rank_vector":
            stats.note(5, val(np.float32(1.0)), {
                "nonfinite_by_rank": val(np.array([0.0, 4.0, 0.0],
                                                  np.float32))})
        else:
            stats.note(9, val(np.float32(np.nan)), {})
        stats.flush()
        deltas[m is tnum] = count(fam, key) - before
    _both(run)
    assert deltas[True] == deltas[False] == (4 if case == "per_rank_vector"
                                             else 1)


def test_step_stats_alert_names_the_rank():
    stats = tnum.StepStats()
    stats.note(7, torch.tensor(1.0),
               {"nonfinite_by_rank": torch.tensor([0.0, 0.0, 3.0])})
    stats.flush()
    alerts = [a for a in tnum._alert_monitor().alerts
              if a.kind == "nonfinite_rate"
              and a.evidence.get("source") == "grad"]
    assert alerts and alerts[-1].evidence["rank"] == 2
    assert alerts[-1].evidence["step"] == 7


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------

def test_identical_values_identical_digests():
    from horovod_tpu.observability import numerics as jnum
    a = np.arange(4096, dtype=np.float32) / 3.0
    want = jnum.fingerprint_leaf("w", a)
    assert tnum.fingerprint_leaf("w", a) == want
    assert tnum.fingerprint_leaf("w", torch.from_numpy(a.copy())) == want


@pytest.mark.parametrize("index,bit,field", [(0, 5, 1), (1234, 12, 0)],
                         ids=["element0_crc", "unsampled_norm"])
def test_bitflip_changes_digest_as_jax(index, bit, field):
    from horovod_tpu.observability import numerics as jnum
    a = np.arange(1.0, 4097.0, dtype=np.float32)
    jflip = jnum.flip_mantissa_bit(a, index=index, bit=bit)
    tflip = tnum.flip_mantissa_bit(torch.from_numpy(a), index=index,
                                   bit=bit)
    np.testing.assert_array_equal(tflip.numpy(), jflip)
    np.testing.assert_array_equal(tnum.flip_mantissa_bit(a, index, bit),
                                  jflip)
    assert tnum.fingerprint_leaf("w", tflip) == \
        jnum.fingerprint_leaf("w", jflip)
    assert tnum.fingerprint_leaf("w", tflip)[field] != \
        tnum.fingerprint_leaf("w", a)[field]


def _lm_tree():
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtfm
    cfg = jtfm.TransformerConfig(dtype=jnp.float32, **CFG)
    return jax.device_get(jtfm.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fingerprint_tree_matches_jax(dtype):
    """A module's digests (keys = JAX keypaths of
    ``params_to_jax(state_dict)``) equal JAX's ``fingerprint_tree`` of
    the JAX tree of the same values, fp32 and bf16."""
    import jax
    import jax.numpy as jnp
    from horovod_tpu.observability import numerics as jnum
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.models import transformer as ttfm
    tree = _lm_tree()
    model = ttfm.Transformer(ttfm.TransformerConfig(dtype=torch.float32,
                                                    **CFG), device="cpu")
    model.load_state_dict(interop.params_from_jax(tree))
    if dtype == "bfloat16":
        model = model.to(torch.bfloat16)
        jtree = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.bfloat16), tree)
    else:
        jtree = tree
    want = jnum.fingerprint_tree(jtree)
    got = tnum.fingerprint_tree(model)
    assert got == want
    # A plain tree of tensors digests alike.
    ttree = jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(
            getattr(torch, dtype)), tree)
    assert tnum.fingerprint_tree(ttree) == want


def test_majority_compare_names_leaf_and_rank():
    from horovod_tpu.observability import numerics as jnum
    a = np.arange(256, dtype=np.float32)
    out = {}
    for m in (jnum, tnum):
        good = m.fingerprint_tree({"w": a, "b": a[:8]})
        bad = m.fingerprint_tree(
            {"w": m.flip_mantissa_bit(a, index=0, bit=3), "b": a[:8]})
        out[m is tnum] = m.compare_fingerprints({0: good, 1: bad, 2: good})
    assert out[True] == out[False] == [("['w']", 1)]


def test_record_fingerprint_fires_rank_divergence():
    from horovod_tpu.observability import numerics as jnum
    a = np.arange(64, dtype=np.float32)
    fam = "hvdtpu_numerics_fingerprints_total"
    verdicts = {}
    for m, count in ((jnum, _jcounter), (tnum, _tcounter)):
        good = m.fingerprint_tree({"w": a})
        bad = m.fingerprint_tree(
            {"w": m.flip_mantissa_bit(a, index=0, bit=3)})
        before = count(fam, 'event="mismatch"')
        got = [m.record_fingerprint(0, 10, good, 3),
               m.record_fingerprint(2, 10, good, 3),
               m.record_fingerprint(1, 10, bad, 3)]
        verdicts[m is tnum] = (got, count(fam, 'event="mismatch"') - before)
    assert verdicts[True] == verdicts[False] == ([[], [], [("['w']", 1)]], 1)
    alerts = [x for x in tnum._alert_monitor().alerts
              if x.kind == "rank_divergence"]
    assert alerts[-1].evidence["rank"] == 1
    assert alerts[-1].evidence["leaf"] == "['w']"


def test_stale_step_evicted_and_still_compared():
    from horovod_tpu.observability import numerics as jnum
    a = np.arange(64, dtype=np.float32)
    out = {}
    for m in (jnum, tnum):
        good = m.fingerprint_tree({"w": a})
        bad = m.fingerprint_tree(
            {"w": m.flip_mantissa_bit(a, index=0, bit=3)})
        got = m.record_fingerprint(0, 0, good, 3) + \
            m.record_fingerprint(2, 0, bad, 3)
        for step in range(1, 6):
            got += m.record_fingerprint(0, step, good, 3)
        out[m is tnum] = got
    assert out[True] == out[False]
    assert ("['w']", 2) in out[True]


# ---------------------------------------------------------------------------
# bitflip_param
# ---------------------------------------------------------------------------

@pytest.fixture
def _faults():
    from horovod_tpu.adaptation import faults as jfaults
    from horovod_tpu_torch.adaptation import faults as tfaults

    def arm(spec):
        if spec is None:
            os.environ.pop("HOROVOD_TPU_FAULT_SPEC", None)
        else:
            os.environ["HOROVOD_TPU_FAULT_SPEC"] = spec
        jfaults.reset()
        tfaults.reset()
    old = os.environ.get("HOROVOD_TPU_FAULT_SPEC")
    yield arm
    arm(old)


def test_armed_clause_flips_target_leaf_once(_faults):
    import jax.numpy as jnp
    from horovod_tpu.observability import numerics as jnum
    _faults("rank=0:bitflip_param=2:leaf=w")
    fam, key = "hvdtpu_fault_injections_total", 'kind="bitflip"'
    jtree = {"w": jnp.arange(1.0, 9.0), "b": jnp.zeros(4)}
    ttree = {"w": torch.arange(1.0, 9.0), "b": torch.zeros(4)}
    before = _tcounter(fam, key)
    assert tnum.maybe_bitflip(ttree, 0) is ttree
    assert jnum.maybe_bitflip(jtree, 0) is jtree
    tout, jout = tnum.maybe_bitflip(ttree, 2), jnum.maybe_bitflip(jtree, 2)
    np.testing.assert_array_equal(tout["w"].numpy(), np.asarray(jout["w"]))
    assert float(tout["w"][0]) != 1.0
    assert torch.equal(tout["b"], torch.zeros(4))
    assert float(ttree["w"][0]) == 1.0          # a CPU tree is copied
    assert _tcounter(fam, key) == before + 1
    assert tnum.maybe_bitflip(ttree, 2) is ttree


def test_unarmed_is_identity(_faults):
    _faults(None)
    tree = {"w": torch.ones(4)}
    assert tnum.maybe_bitflip(tree, 0) is tree


@pytest.mark.parametrize("pattern", ["", "wq", "layers'][1]['wo", "ln_f"])
def test_leaf_spec_picks_jax_leaf_in_a_module(_faults, pattern):
    """One ``leaf=`` substring picks the same leaf in both packages: the
    module's parameter is flipped in place (the object survives), its
    values equal JAX's flipped leaf."""
    import jax
    from horovod_tpu.observability import numerics as jnum
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.models import transformer as ttfm
    spec = "rank=0:bitflip_param=0" + (f":leaf={pattern}" if pattern else "")
    _faults(spec)
    tree = _lm_tree()
    model = ttfm.Transformer(ttfm.TransformerConfig(dtype=torch.float32,
                                                    **CFG), device="cpu")
    model.load_state_dict(interop.params_from_jax(tree))
    before = {n: p for n, p in model.named_parameters()}
    assert tnum.maybe_bitflip(model, 0) is model
    jout = jax.device_get(jnum.maybe_bitflip(tree, 0))
    got = interop.params_to_jax(model.state_dict())
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jout)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    changed = [jax.tree_util.keystr(k) for k in flat_j
               if not np.array_equal(flat_j[k], flat_t[k])]
    assert changed == []
    flipped = [jax.tree_util.keystr(k) for k, v in
               jax.tree_util.tree_flatten_with_path(tree)[0]
               if not np.array_equal(np.asarray(v), flat_j[k])]
    assert len(flipped) == 1 and pattern in flipped[0]
    assert all(p is before[n] for n, p in model.named_parameters())


# ---------------------------------------------------------------------------
# The policy's quality backoff
# ---------------------------------------------------------------------------

def _policies():
    from horovod_tpu.adaptation import policy as jpol
    from horovod_tpu_torch.adaptation import policy as tpol
    out = []
    for m in (jpol, tpol):
        cfg = m.AdaptationConfig(threshold_s=0.05, sustain_s=1.0,
                                 cooldown_s=2.0, interval_s=0.0,
                                 alert_hold_s=10.0)
        out.append(m.AdaptationPolicy(cfg, allow_evict=False))
    return out


@pytest.mark.parametrize("case", ["unwinds", "hold_blocks", "no_pressure"])
def test_quality_backoff_matches_jax(case):
    seen = []
    for p in _policies():
        if case == "unwinds":
            p.tier = 3
            p.note_alert("quantization_drift", rank=1, now=100.0)
            seen.append((p.tier, p.config.tiers[:p.tier]))
        elif case == "hold_blocks":
            p.tier = 2
            p.note_alert("quantization_drift", rank=0, now=100.0)
            seen.append((p.tier, p._escalate(0, 1.0, now=105.0) is None,
                         p._escalate(0, 1.0, now=111.0) is not None))
        else:
            p.note_alert("quantization_drift", rank=0, now=50.0)
            seen.append((p.tier, p._alert_pressure(now=51.0)))
    assert seen[0] == seen[1]


# ---------------------------------------------------------------------------
# Checkpoint value fingerprints
# ---------------------------------------------------------------------------

def test_manifest_digests_are_the_planes(tmp_path):
    from horovod_tpu.observability import numerics as jnum
    from horovod_tpu_torch.checkpoint import CheckpointEngine, manifest
    eng = CheckpointEngine(str(tmp_path), barrier=lambda name: None)
    tree = {"w": torch.arange(8.0, dtype=torch.float64),
            "b": torch.zeros(3)}
    eng.save(tree, 1, block=True)
    fps = manifest.read_manifest(str(tmp_path), 1)["fingerprints"]
    assert fps["['w']"] == tnum.fingerprint_leaf("['w']", tree["w"]) == \
        jnum.fingerprint_leaf("['w']", np.arange(8.0))


def test_verify_fingerprint_roundtrip_and_mismatch(tmp_path):
    from horovod_tpu_torch.checkpoint import (CheckpointEngine,
                                              CorruptShardError, manifest)
    from horovod_tpu_torch.checkpoint import engine as ck_engine
    eng = CheckpointEngine(str(tmp_path), barrier=lambda name: None)
    w = torch.arange(8.0, dtype=torch.float64)
    eng.save({"w": w}, 1, block=True)
    man = manifest.read_manifest(str(tmp_path), 1)
    ck_engine.verify_fingerprint("['w']", w, man)
    with pytest.raises(CorruptShardError, match="fingerprint"):
        ck_engine.verify_fingerprint(
            "['w']", tnum.flip_mantissa_bit(w, index=5, bit=2), man)


# ---------------------------------------------------------------------------
# The train steps' aux on gloo ranks
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _batch(n=4):
    rng = np.random.RandomState(1)
    tok = rng.randint(0, CFG["vocab"], size=(n, CFG["max_seq"] + 1))
    return tok[:, :-1].astype(np.int64), tok[:, 1:].astype(np.int64)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32))


def _factory(p):
    return torch.optim.AdamW(p, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=WD)


def _run_mesh(tree, axes, kw, zero1):
    """(armed auxes, off params, armed params, all_reduce calls off and
    armed) of STEPS mesh steps on this rank."""
    import torch.distributed as dist
    from horovod_tpu_torch.models import transformer as ttfm
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import build_train_step
    mesh = create_mesh(**axes)
    cfg = ttfm.TransformerConfig(dtype=torch.float32, **kw, **CFG)
    tok, tgt = (torch.from_numpy(x) for x in _batch())
    calls = {"n": 0}
    inner = dist.all_reduce

    def counted(*a, **k):
        calls["n"] += 1
        return inner(*a, **k)
    dist.all_reduce = counted
    out = {}
    try:
        for armed in (False, True):
            tnum.set_enabled(armed)
            step = build_train_step(cfg, _factory, mesh=mesh, device="cpu")
            model = step.make_model(params=step.shard_params(tree))
            opt = step.make_optimizer(model, zero1=zero1)
            calls["n"], auxes = 0, []
            for _ in range(STEPS):
                step(model, opt, step.shard_batch(tok), step.shard_batch(tgt))
                if armed:
                    auxes.append({k: v.detach().clone()
                                  for k, v in step.last_aux.items()})
            out[armed] = (calls["n"], {k: v.detach().clone() for k, v in
                                       model.state_dict().items()}, auxes)
    finally:
        dist.all_reduce = inner
        tnum.step_stats().flush()
        tnum.set_enabled(False)
    return out


def _run_dp(tree, world, rank):
    """The dp TrainStep (through the engine) on this rank's batch shard."""
    from horovod_tpu_torch.models import transformer as ttfm
    from horovod_tpu_torch.parallel.train import build_train_step
    cfg = ttfm.TransformerConfig(dtype=torch.float32, **CFG)
    tok, tgt = (torch.from_numpy(x) for x in _batch())
    n = tok.shape[0] // world
    mine = slice(rank * n, (rank + 1) * n)
    step = build_train_step(cfg, _factory, device="cpu")
    model = step.make_model()
    model.load_state_dict(tree_state(tree))
    opt = step.make_optimizer(model)
    auxes = []
    for _ in range(STEPS):
        step(model, opt, tok[mine], tgt[mine])
        auxes.append({k: v.detach().clone() for k, v in step.last_aux.items()})
    return auxes


def tree_state(tree):
    from horovod_tpu_torch import interop
    return interop.params_from_jax(tree)


def _mesh_worker(rank, port, outdir):
    import horovod_tpu_torch as hvd
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=2)
    raw = np.load(os.path.join(outdir, "tree.npy"), allow_pickle=True).item()
    tree = _torch_tree(raw)
    out = {name: _run_mesh(tree, axes, kw, zero1)
           for name, (axes, kw, zero1) in MESHES.items()}
    tnum.set_enabled(True)
    out["dp_engine"] = _run_dp(raw, 2, rank)
    tnum.step_stats().flush()
    tnum.set_enabled(False)
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def _fault_worker(rank, port, outdir):
    os.environ["HOROVOD_TPU_FAULT_SPEC"] = (
        f"rank=1:bitflip_param={FLIP_STEP}:leaf=wq;rank=1:nan_at={NAN_TICK}")
    os.environ["HOROVOD_TPU_NUMERICS"] = "1"
    os.environ["HOROVOD_TPU_NUMERICS_FP_INTERVAL"] = "1"
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as ttfm
    from horovod_tpu_torch.parallel.train import build_train_step
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=FAULT_WORLD)
    raw = np.load(os.path.join(outdir, "tree.npy"), allow_pickle=True).item()
    cfg = ttfm.TransformerConfig(dtype=torch.float32, **CFG)
    step = build_train_step(cfg, _factory, device="cpu")
    model = step.make_model()
    model.load_state_dict(tree_state(raw))
    opt = step.make_optimizer(model)
    tok, tgt = (torch.from_numpy(x[:FAULT_WORLD]) for x in _batch())
    for _ in range(3):
        step(model, opt, tok[rank:rank + 1], tgt[rank:rank + 1])
        hvd.allreduce(torch.zeros(1), name=f"barrier.{step.steps}")
    tnum.step_stats().flush()
    time.sleep(0.2)
    hvd.allreduce(torch.zeros(1), name="barrier.end")
    alerts = [(a.kind, a.evidence) for a in tnum._alert_monitor().alerts]
    hvd.shutdown()
    torch.save(alerts, os.path.join(outdir, f"rank{rank}.pt"))


def _spawn(worker, world, outdir):
    ctx = mp.spawn(worker, args=(_free_port(), str(outdir)), nprocs=world,
                   join=False)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world}-rank job did not finish within "
                        f"{JOB_TIMEOUT_S} s")
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"))
            for r in range(world)]


@pytest.fixture(scope="module")
def tree():
    return _lm_tree()


@pytest.fixture(scope="module")
def mesh_ranks(tree, tmp_path_factory):
    d = tmp_path_factory.mktemp("numerics_mesh")
    np.save(d / "tree.npy", tree, allow_pickle=True)
    return _spawn(_mesh_worker, 2, d)


@pytest.fixture(scope="module")
def fault_ranks(tree, tmp_path_factory):
    d = tmp_path_factory.mktemp("numerics_faults")
    np.save(d / "tree.npy", tree, allow_pickle=True)
    return _spawn(_fault_worker, FAULT_WORLD, d)


def _jax_auxes(tree, axes, kw, zero1):
    """JAX's aux of STEPS armed steps on a mesh of virtual devices."""
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu.models import transformer as jtfm
    from horovod_tpu.observability import numerics as jnum
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.train import build_train_step
    from horovod_tpu.parallel.zero import zero1_init
    cfg = jtfm.TransformerConfig(dtype=jnp.float32, **kw, **CFG)
    n = int(np.prod(list(axes.values())))
    mesh = create_mesh(devices=jax.devices()[:n], **axes)
    opt = optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=WD)
    state = (zero1_init(opt, tree, n_shards=axes["dp"],
                        param_specs=jtfm.param_specs(cfg), mesh=mesh)
             if zero1 else opt.init(tree))

    class Capture:
        def __init__(self):
            self.auxes = []

        def note(self, step, loss, aux):
            self.auxes.append(jax.device_get(aux))

        def flush(self):
            pass
    capture, saved = Capture(), jnum._step_stats
    jnum._step_stats = capture
    try:
        make, shard_p, shard_b = build_train_step(cfg, mesh, opt)
        step, _ = make(tree, state)
        tok, tgt = _batch()
        params = shard_p(tree)
        for _ in range(STEPS):
            params, state, _ = step(params, state, shard_b(jnp.asarray(tok)),
                                    shard_b(jnp.asarray(tgt)))
    finally:
        jnum._step_stats = saved
    return capture.auxes


def _assert_aux(got, want, what):
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("grad_norm", "update_ratio"):
            gv, wv = float(g[key]), float(w[key])
            assert abs(gv - wv) <= REL_TOL * abs(wv), \
                f"{what} step {i} {key}: {gv} vs JAX {wv}"
        np.testing.assert_array_equal(g["nonfinite_by_rank"].numpy(),
                                      np.asarray(w["nonfinite_by_rank"]))


@pytest.mark.parametrize("name", sorted(MESHES) + ["dp_engine"])
def test_step_aux_matches_jax(mesh_ranks, tree, name):
    axes, kw, zero1 = MESHES.get(name, (dict(dp=2), {}, False))
    want = _jax_auxes(tree, axes, kw, zero1)
    for r, out in enumerate(mesh_ranks):
        got = out[name] if name == "dp_engine" else out[name][True][2]
        _assert_aux(got, want, f"{name} rank {r}")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_plane_off_adds_nothing_and_changes_no_bit(mesh_ranks, name):
    for out in mesh_ranks:
        (n_off, off, _), (n_on, on, _) = out[name][False], out[name][True]
        assert n_on == n_off + STEPS        # one all_reduce a step
        for key in off:
            assert torch.equal(off[key], on[key]), key


def test_step_aux_matches_jax_at_dp1(tree):
    import horovod_tpu_torch as thvd
    thvd.shutdown()
    thvd.init(device="cpu")
    try:
        out = _run_mesh(_torch_tree(tree), dict(dp=1), {}, False)
    finally:
        thvd.shutdown()
    _assert_aux(out[True][2], _jax_auxes(tree, dict(dp=1), {}, False),
                "dp1")
    assert out[True][0] == out[False][0] + STEPS
    for key in out[False][1]:
        assert torch.equal(out[False][1][key], out[True][1][key]), key


def test_bitflip_on_rank1_named_by_rank0(fault_ranks):
    div = [ev for kind, ev in fault_ranks[0] if kind == "rank_divergence"
           and ev["step"] == FLIP_STEP]
    assert div, fault_ranks[0]
    assert {(ev["rank"], ev["leaf"]) for ev in div} == {
        (1, "['layers'][0]['wq']")}


def test_nan_at_on_rank1_named_as_rank1(fault_ranks):
    nan = [ev for kind, ev in fault_ranks[1] if kind == "nonfinite_rate"
           and ev["source"] == "collective"]
    assert len(nan) == 1 and nan[0]["rank"] == 1, fault_ranks[1]
    for r in (0, 2):
        assert not [ev for kind, ev in fault_ranks[r]
                    if kind == "nonfinite_rate"
                    and ev["source"] == "collective"]
