"""The port's engine and step telemetry against the JAX package's.

- The engine's families (``ops/collective.py`` ``_EngineMetrics``), on
  2 and 4 gloo ranks in spawned jobs running the op sequence JAX's
  engine runs here (an allreduce, a fused pair, a blockwise-wire
  allreduce, an allgather, a broadcast): JAX's names, kinds, help and
  labels, and on every rank JAX's counts (ops, wire bytes by spec,
  fused group sizes and bytes, the op phases' observations); the
  flight recorder's group events with the same sequence on every rank;
  a stalled name in the stalled-tensor gauges with the coordinator's
  missing rank, cleared once it completes.
- ``StepTimer``/``StepMetrics`` against JAX's ``StepTimer`` on one
  scripted clock and the same registry increments: the phase split and
  shares, samples/s, the collective share, model FLOP/s and MFU;
  ``flops_of_step`` against JAX's ``flops_of_lowered`` on a matmul, the
  flash attention counted by torch's SDPA formulas, and a train step on
  the flash op counting what the same step through the plain attention
  counts; the peak table; the HBM gauges' host fallback; the ``STEP_*``
  spans in the engine's live timeline; a CUDA group's execute phase read
  from its events once they have passed (emulated events).
- The optimizer's bucket families against the JAX torch shim's for the
  same model and steps, the pipeline's against JAX's schedule record,
  the loader's against JAX's loader, the checkpoint engine's against
  JAX's engine; every Part A family's kind and help are JAX's;
  ``prometheus_text`` parses; the top-level exports.
"""

import json
import math
import os
import pickle
import re
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import horovod_tpu as jhvd
from horovod_tpu.observability import registry as jreg
from horovod_tpu.observability import step_metrics as jsm
from horovod_tpu_torch.observability import flight_recorder as tfr
from horovod_tpu_torch.observability import registry as treg
from horovod_tpu_torch.observability import step_metrics as tsm
from horovod_tpu_torch.ops import collective as tcoll

JOB_TIMEOUT_S = 120
STALL_S = 0.3

ENGINE_FAMILIES = (
    "hvdtpu_op_phase_seconds", "hvdtpu_ops_total",
    "hvdtpu_op_execute_seconds_total", "hvdtpu_fused_group_size",
    "hvdtpu_fused_group_bytes", "hvdtpu_wire_bytes_enqueued_total",
    "hvdtpu_cycles_total", "hvdtpu_cycle_busy_seconds_total",
    "hvdtpu_cycle_idle_seconds_total", "hvdtpu_engine_stalled_tensors",
    "hvdtpu_engine_stalled_tensor_seconds",
    "hvdtpu_adaptation_applied_groups_total")
STEP_FAMILIES = (
    "hvdtpu_step_seconds", "hvdtpu_step_phase_seconds",
    "hvdtpu_step_phase_share", "hvdtpu_samples_total",
    "hvdtpu_samples_per_second", "hvdtpu_collective_step_share",
    "hvdtpu_allreduce_step_share", "hvdtpu_mfu",
    "hvdtpu_model_flops_per_second", "hvdtpu_hbm_bytes_in_use",
    "hvdtpu_hbm_peak_bytes")
SHIM_FAMILIES = (
    "hvdtpu_torch_bucket_fires_total", "hvdtpu_torch_bucket_bytes_total",
    "hvdtpu_torch_buckets", "hvdtpu_torch_grad_view_rebinds_total",
    "hvdtpu_torch_grad_view_params", "hvdtpu_torch_skipped_steps_total")
PIPELINE_FAMILIES = ("hvdtpu_pipeline_bubble_share", "hvdtpu_pipeline_ticks")
DATA_FAMILIES = (
    "hvdtpu_data_samples_total", "hvdtpu_data_batches_total",
    "hvdtpu_data_epochs_total", "hvdtpu_data_load_seconds_total",
    "hvdtpu_data_cursor_commits_total", "hvdtpu_data_resume_skips_total")
PREFETCH_FAMILIES = (
    "hvdtpu_data_prefetch_depth", "hvdtpu_data_prefetch_occupancy",
    "hvdtpu_data_wait_seconds_total", "hvdtpu_data_h2d_seconds_total")
CKPT_FAMILIES = (
    "hvdtpu_checkpoint_bytes_written_total",
    "hvdtpu_checkpoint_shards_written_total",
    "hvdtpu_checkpoint_save_seconds", "hvdtpu_checkpoint_blocked_seconds_total",
    "hvdtpu_checkpoint_restore_seconds", "hvdtpu_checkpoint_gc_steps_total",
    "hvdtpu_checkpoint_corrupt_shards_total",
    "hvdtpu_checkpoint_last_committed_step")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(fn, n, *args):
    ctx = mp.spawn(fn, args=(n, _free_port()) + args, nprocs=n, join=False)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {n}-rank job did not finish within "
                        f"{JOB_TIMEOUT_S} s")


def _delta(before, after, names):
    """Per family and label: a counter's or gauge's increase, a
    histogram's (count, sum) increase; children the run left unchanged
    (an earlier test in the process may have made them) are left out."""
    out = {}
    for name in names:
        b = before.get(name, {}).get("values", {})
        vals = {}
        for lab, v in after.get(name, {}).get("values", {}).items():
            if isinstance(v, dict):
                w = b.get(lab) or {"count": 0, "sum": 0.0}
                d = (v["count"] - w["count"], v["sum"] - w["sum"])
                if d[0]:
                    vals[lab] = d
            elif v != b.get(lab, 0.0):
                vals[lab] = v - b.get(lab, 0.0)
        out[name] = vals
    return out


# ---------------------------------------------------------------------------
# The engine, on gloo ranks, against JAX's engine here
# ---------------------------------------------------------------------------

def _sequence(hvd, comp, make):
    """The op sequence both packages run (``make(shape)`` a tensor)."""
    hvd.allreduce(make((128,)), name="m.a")
    hvd.grouped_allreduce([make((64,)), make((32,))], name="m.f")
    hvd.allreduce(make((512,)), name="m.w", compression=comp.int8_blockwise)
    hvd.allgather(make((4, 4)), name="m.g")
    hvd.broadcast(make((8,)), 0, name="m.b")


def _engine_worker(rank, n, port, outdir):
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}",
             rank=rank, world_size=n)
    hvd.allreduce(torch.ones(1), name="m.warm")
    before = treg.snapshot()
    ring0 = len(tfr.recorder()._ring)
    _sequence(hvd, hvd.Compression, lambda shape: torch.ones(shape))
    after = treg.snapshot()
    groups = [(kind, payload[:3])
              for _, kind, payload in list(tfr.recorder()._ring)[ring0:]
              if kind.startswith("group_")]
    eng = tcoll.engine()
    eng.stall_warning_s = STALL_S
    mid = None
    if rank == 0:
        h = hvd.allreduce_async(torch.ones(4), name="m.stuck")
        time.sleep(4 * STALL_S)
        mid = treg.snapshot("hvdtpu_engine_stalled")
        h.wait()
    else:
        time.sleep(5 * STALL_S)
        hvd.allreduce(torch.ones(4), name="m.stuck")
    time.sleep(3 * STALL_S)     # the next check after the episode
    end = treg.snapshot("hvdtpu_engine_stalled")
    hvd.shutdown()
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"delta": _delta(before, after, ENGINE_FAMILIES),
                     "meta": {k: (after[k]["type"], after[k]["help"])
                              for k in ENGINE_FAMILIES if k in after},
                     "groups": groups, "mid": mid, "end": end}, f)


@pytest.fixture(scope="module")
def jax_engine_delta():
    """JAX's engine on the same sequence, in this process."""
    import jax.numpy as jnp
    from horovod_tpu.compression import Compression
    before = jhvd.metrics_snapshot()
    _sequence(jhvd, Compression, lambda shape: jnp.ones(shape))
    after = jhvd.metrics_snapshot()
    return _delta(before, after, ENGINE_FAMILIES), after


@pytest.fixture(scope="module", params=[2, 4])
def port_engine_runs(request, tmp_path_factory):
    n = request.param
    out = tmp_path_factory.mktemp(f"engine{n}")
    _spawn(_engine_worker, n, str(out))
    runs = []
    for r in range(n):
        with open(out / f"rank{r}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    return runs


COUNTED = ("hvdtpu_ops_total", "hvdtpu_wire_bytes_enqueued_total",
           "hvdtpu_fused_group_size", "hvdtpu_fused_group_bytes")


def test_engine_counts_match_jax(port_engine_runs, jax_engine_delta):
    want, _ = jax_engine_delta
    for run in port_engine_runs:
        got = run["delta"]
        for name in COUNTED:
            assert got[name] == want[name], name
        # The phases: JAX's observations per (op, phase).
        assert {k: v[0] for k, v in got["hvdtpu_op_phase_seconds"].items()
                if v[0]} == {k: v[0] for k, v in
                             want["hvdtpu_op_phase_seconds"].items() if v[0]}
        assert all(v[1] >= 0 for v in
                   got["hvdtpu_op_phase_seconds"].values())
        # Execute seconds, per op JAX labels, all positive.
        ex = got["hvdtpu_op_execute_seconds_total"]
        assert {k for k, v in ex.items() if v > 0} == {
            k for k, v in want["hvdtpu_op_execute_seconds_total"].items()
            if v > 0}
        # The port's loop ticks its cycle counters (JAX's native core
        # here does not tick the Python loop's).
        assert got["hvdtpu_cycles_total"][""] > 0
        assert got["hvdtpu_cycle_busy_seconds_total"][""] > 0
    assert want["hvdtpu_ops_total"] == {'op="allreduce"': 4.0,
                                        'op="allgather"': 1.0,
                                        'op="broadcast"': 1.0}
    assert want["hvdtpu_wire_bytes_enqueued_total"] == {
        'spec="raw"': 992.0, 'spec="int8x256"': 512.0 + 2 * 4}


def test_engine_families_are_jax_kind_and_help(port_engine_runs,
                                               jax_engine_delta):
    _, jsnap = jax_engine_delta
    for run in port_engine_runs:
        for name in ENGINE_FAMILIES:
            assert run["meta"][name] == (jsnap[name]["type"],
                                         jsnap[name]["help"]), name


def test_flight_recorder_group_events_agree_across_ranks(port_engine_runs):
    groups = port_engine_runs[0]["groups"]
    kinds = [k for k, _ in groups]
    assert kinds.count("group_deliver") == 5
    assert kinds.count("group_done") == 5
    seqs = [p[0] for k, p in groups if k == "group_deliver"]
    assert seqs == list(range(seqs[0], seqs[0] + 5))
    assert [p[1] for k, p in groups if k == "group_done"] == [
        "allreduce", "allreduce", "allreduce", "allgather", "broadcast"]
    for run in port_engine_runs[1:]:
        assert run["groups"] == groups


def test_stalled_tensor_gauges_name_the_missing_rank(port_engine_runs):
    mid = port_engine_runs[0]["mid"]
    assert mid["hvdtpu_engine_stalled_tensors"]["values"][""] == 1.0
    info = mid["hvdtpu_engine_stalled_tensor_seconds"]["values"]
    missing = ",".join(str(r) for r in range(1, len(port_engine_runs)))
    key = f'missing_ranks="{missing}",tensor="m.stuck"'
    assert key in info and info[key] >= STALL_S
    end = port_engine_runs[0]["end"]
    assert end["hvdtpu_engine_stalled_tensors"]["values"][""] == 0.0
    assert end["hvdtpu_engine_stalled_tensor_seconds"]["values"] == {}


# ---------------------------------------------------------------------------
# StepTimer against JAX's on one clock
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def monotonic(self):
        return self.t


def _feed(reg_mod, exec_s, negotiate_s):
    """What the engine records during a step, into a package's registry."""
    r = reg_mod.registry()
    r.counter("hvdtpu_op_execute_seconds_total",
              "Cumulative wall seconds executing fused collective groups"
              ).labels(op="allgather").inc(exec_s)
    r.histogram("hvdtpu_op_phase_seconds",
                "Per-collective latency by lifecycle phase (negotiate = "
                "enqueue until the group is agreed/delivered; queue = "
                "delivery until XLA dispatch; execute = fused program wall "
                "time)", buckets=reg_mod.LATENCY_BUCKETS).labels(
        op="allgather", phase="negotiate").observe(negotiate_s)


def _script(timer, clock, reg_mod):
    """Two steps: the first with an h2d mark and collective seconds, then
    an input gap, a prefetcher credit and a short step."""
    out = []
    clock.t = 10.0
    timer.begin()
    clock.t = 10.02
    timer.mark_h2d_done()
    _feed(reg_mod, 0.03, 0.01)
    clock.t = 10.1
    timer.end(samples=32)
    out.append(dict(timer.last_phases, step=timer.last_step_s,
                    rate=timer.last_samples_per_s,
                    share=timer.last_collective_share))
    timer.credit_h2d(0.02)
    clock.t = 10.15
    timer.begin()
    _feed(reg_mod, 0.5, 0.0)
    clock.t = 10.2
    timer.end()
    out.append(dict(timer.last_phases, step=timer.last_step_s,
                    rate=timer.last_samples_per_s,
                    share=timer.last_collective_share))
    return out


def test_step_timer_matches_jax_on_one_clock(monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_PEAK_FLOPS", "1e12")
    clock = _Clock()
    monkeypatch.setattr(jsm, "time", clock)
    monkeypatch.setattr(tsm, "time", clock)
    jt = jsm.StepTimer("parity_fw", batch_size=16, flops_per_step=1e9)
    tt = tsm.StepTimer("parity_fw", batch_size=16, flops_per_step=1e9,
                       device="cpu")
    want = _script(jt, clock, jreg)
    got = _script(tt, clock, treg)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k] == pytest.approx(w[k], abs=1e-12), k
    assert got[1]["share"] == 1.0           # 0.5 s in a 50 ms step
    jsnap, tsnap = jreg.snapshot(), treg.snapshot()
    for name in ("hvdtpu_step_phase_share", "hvdtpu_samples_per_second",
                 "hvdtpu_collective_step_share",
                 "hvdtpu_allreduce_step_share", "hvdtpu_mfu",
                 "hvdtpu_model_flops_per_second"):
        tv = {k: v for k, v in tsnap[name]["values"].items()
              if "parity_fw" in k}
        jv = {k: v for k, v in jsnap[name]["values"].items()
              if "parity_fw" in k}
        assert tv.keys() == jv.keys() and tv, name
        for k in tv:
            assert tv[k] == pytest.approx(jv[k], rel=1e-12), (name, k)
    # Unclamped (step 1), the split covers the cycle: input plus step.
    first = got[0]
    assert sum(first[p] for p in tsm.STEP_PHASES) == pytest.approx(
        first["input"] + first["step"], abs=1e-12)
    for name in ("hvdtpu_step_seconds", "hvdtpu_step_phase_seconds"):
        tv = {k: v["count"] for k, v in tsnap[name]["values"].items()
              if "parity_fw" in k}
        jv = {k: v["count"] for k, v in jsnap[name]["values"].items()
              if "parity_fw" in k}
        assert tv == jv and tv


def test_mfu_not_exported_without_peak(monkeypatch):
    monkeypatch.delenv("HOROVOD_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("HOROVOD_PEAK_FLOPS", raising=False)
    timer = tsm.StepTimer("nopeak_fw", flops_per_step=1e9, device="cpu")
    with timer:
        pass
    snap = treg.snapshot()
    assert snap["hvdtpu_model_flops_per_second"]["values"][
        'framework="nopeak_fw"'] > 0
    assert 'framework="nopeak_fw"' not in snap.get(
        "hvdtpu_mfu", {}).get("values", {})


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", None), ("NVIDIA A100-SXM4-80GB", None)])
def test_peak_by_device_name(monkeypatch, name, peak):
    monkeypatch.delenv("HOROVOD_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("HOROVOD_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert tsm._local_peak_flops(torch.device("cuda", 0)) == peak
    monkeypatch.setenv("HOROVOD_TPU_PEAK_FLOPS", "1.5e14")
    assert tsm._local_peak_flops(torch.device("cuda", 0)) == 1.5e14
    assert tsm._local_peak_flops(torch.device("cpu")) == 1.5e14


def test_hbm_gauges_fall_back_to_host_rss_on_cpu():
    timer = tsm.StepTimer("hbm_fw", device="cpu")
    with timer:
        pass
    snap = treg.snapshot()
    assert snap["hvdtpu_hbm_bytes_in_use"]["values"]['device="host"'] > 0
    assert snap["hvdtpu_hbm_peak_bytes"]["values"]['device="host"'] > 0


def test_flops_of_step_matches_jax_on_a_matmul():
    import jax
    import jax.numpy as jnp
    a = torch.ones(64, 64)
    got = tsm.flops_of_step(torch.matmul, a, a)
    assert got == 2 * 64 ** 3
    want = jsm.flops_of_lowered(jax.jit(lambda x: x @ x).lower(
        jnp.ones((64, 64))).compile())
    assert want is None or want == got


def test_flash_attention_counts_sdpa_model_flops():
    """Forward 4·B·H·S²·D and backward 8·B·H·S²·D (torch's SDPA backward
    formula less its recompute of the scores), the plain attention's
    batched matmuls' count."""
    from horovod_tpu_torch.ops.flash_attention import flash_attention
    from horovod_tpu_torch.parallel.ring_attention import full_attention
    b, s, h, d = 2, 64, 3, 16
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g, requires_grad=True)
               for _ in range(3))

    def run(fn):
        fn(q, k, v, causal=True).sum().backward()

    flash = tsm.flops_of_step(run, flash_attention)
    plain = tsm.flops_of_step(run, full_attention)
    assert flash == plain == 12 * b * h * s * s * d


@pytest.fixture(scope="module")
def port_world():
    import horovod_tpu_torch as hvd
    old = os.environ.get("HOROVOD_TPU_NUMERICS")
    os.environ["HOROVOD_TPU_NUMERICS"] = "1"
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()
    if old is None:
        os.environ.pop("HOROVOD_TPU_NUMERICS", None)
    else:
        os.environ["HOROVOD_TPU_NUMERICS"] = old


def test_train_step_on_flash_counts_the_plain_step(port_world):
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel.train import build_train_step
    tok = torch.randint(0, 64, (2, 65),
                        generator=torch.Generator().manual_seed(1))
    counts = {}
    for flash in (True, False):
        cfg = tfm.TransformerConfig(vocab=64, d_model=32, n_heads=4,
                                    d_ff=64, n_layers=2, max_seq=64,
                                    dtype=torch.float32, use_flash=flash)
        step = build_train_step(cfg, lambda p: torch.optim.SGD(p, lr=0.1),
                                device="cpu")
        model = step.make_model(generator=torch.Generator().manual_seed(0))
        opt = step.make_optimizer(model)
        counts[flash] = tsm.flops_of_step(step, model, opt, tok[:, :-1],
                                          tok[:, 1:])
    assert counts[True] == counts[False] > 0


def test_step_spans_emitted_into_live_timeline(port_world, tmp_path):
    from horovod_tpu_torch.ops.timeline_py import PyTimeline
    eng = tcoll.engine()
    old = eng.timeline
    tl = PyTimeline(str(tmp_path / "steps.json"))
    eng.timeline = tl
    try:
        timer = port_world.StepMetrics()
        with timer:
            time.sleep(0.002)
        time.sleep(0.02)   # input gap
        with timer:
            time.sleep(0.002)
    finally:
        eng.timeline = old
        tl.close()
    events = json.loads((tmp_path / "steps.json").read_text())
    names = [e.get("name") for e in events if e.get("ph") == "X"]
    assert "STEP_COMPUTE" in names and "STEP_INPUT" in names
    steps = [p for _, kind, p in tfr.recorder()._ring if kind == "step_end"]
    assert steps and len(steps[-1]) == 6


class _FakeEvent:
    """The timing surface of a CUDA event; done once ``done`` is set."""

    def __init__(self, done=True):
        self.done, self.synced = done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.synced = self.done = True

    def elapsed_time(self, end):
        return 250.0


def test_cuda_group_execute_is_read_from_its_events(port_world):
    """A CUDA group's execute phase is the time between the events
    recorded around it on the engine's stream, recorded once the card
    has passed them, oldest first: ``collect_timings`` stops at the first
    unfinished group, a ``StepTimer`` step's end collects what finished,
    and ``block`` waits for the rest."""
    eng = tcoll.engine()
    base = 10 ** 6

    def ran(i, done):
        return tcoll._Ran(tcoll.ALLREDUCE, base + i, "NCCL_ALLREDUCE", 10.0,
                          10.5, [(f"ev{i}", (4,))], _FakeEvent(),
                          _FakeEvent(done))

    runs = [ran(0, True), ran(1, False), ran(2, True)]
    before = tsm._collective_execute_seconds()
    with eng._ran_lock:
        eng._ran.extend(runs)
    eng.collect_timings()
    assert tsm._collective_execute_seconds() - before == pytest.approx(0.25)
    assert list(eng._ran) == runs[1:]
    timer = port_world.StepMetrics()
    with timer:
        runs[1].end.done = True
    assert tsm._collective_execute_seconds() - before == pytest.approx(0.75)
    assert not eng._ran
    last = ran(3, False)
    with eng._ran_lock:
        eng._ran.append(last)
    eng.collect_timings(block=True)
    assert last.end.synced and not eng._ran
    assert tsm._collective_execute_seconds() - before == pytest.approx(1.0)
    done = [p for _, kind, p in tfr.recorder()._ring
            if kind == "group_done" and p[0] >= base]
    assert [p[0] - base for p in done] == [0, 1, 2, 3]
    assert all(p[3:] == (500.0, 250.0) for p in done)


# ---------------------------------------------------------------------------
# The optimizer's bucket plane against the JAX torch shim's
# ---------------------------------------------------------------------------

def _shim_run(hvd_mod, numerics):
    """Three steps of a small model: bucketed at 1 KiB with gradient
    views, the second step after zero_grad(set_to_none=True) outside the
    optimizer (the views rebind), the third with a NaN gradient under
    skip_nonfinite_steps; the families' increase."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 16),
                                torch.nn.Linear(16, 8),
                                torch.nn.Linear(8, 4))
    names = list(SHIM_FAMILIES)
    before = numerics[0]()
    opt = hvd_mod.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), bucket_cap_mb=1 / 1024,
        gradient_as_bucket_view=True, skip_nonfinite_steps=True)
    x = torch.ones(2, 16)
    for i in range(3):
        if i == 1:
            for p in model.parameters():
                p.grad = None
        else:
            opt.zero_grad()
        loss = model(x).sum() * (float("nan") if i == 2 else 1.0)
        loss.backward()
        with pytest.warns(UserWarning) if i == 2 else _nothing():
            opt.step()
    after = numerics[0]()
    return _delta(before, after, names), after


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_bucket_families_match_the_jax_shim(port_world):
    import horovod_tpu.torch as jshim
    from horovod_tpu.observability import numerics as jnum
    was = jnum.enabled()
    jnum.set_enabled(True)
    try:
        want, jsnap = _shim_run(jshim, (jreg.snapshot,))
    finally:
        jnum.set_enabled(was)
    got, tsnap = _shim_run(port_world, (treg.snapshot,))
    gauges = ("hvdtpu_torch_buckets", "hvdtpu_torch_grad_view_params")
    assert {k: v for k, v in got.items() if k not in gauges} == \
        {k: v for k, v in want.items() if k not in gauges}
    assert got["hvdtpu_torch_bucket_fires_total"]['trigger="hook"'] > 0
    assert got["hvdtpu_torch_grad_view_rebinds_total"][""] > 0
    assert got["hvdtpu_torch_skipped_steps_total"][""] == 1.0
    for name in SHIM_FAMILIES:
        assert (tsnap[name]["type"], tsnap[name]["help"]) == \
            (jsnap[name]["type"], jsnap[name]["help"])
    # The buckets and views gauges: the last optimizer's configuration.
    for name in ("hvdtpu_torch_buckets", "hvdtpu_torch_grad_view_params"):
        assert tsnap[name]["values"] == jsnap[name]["values"]


def test_set_bucket_cap_mb_notes_the_repartition(port_world):
    model = torch.nn.Sequential(torch.nn.Linear(16, 16),
                                torch.nn.Linear(16, 4))
    opt = port_world.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), bucket_cap_mb=1.0)
    opt.set_bucket_cap_mb(1 / 1024)
    note = [p for _, kind, p in tfr.recorder()._ring if kind == "autotune"]
    assert note[-1][:3] == ("bucket_repartition", "torch_bucket_mb",
                            str(1 / 1024))
    assert note[-1][5] == f"buckets 1 -> {len(opt._buckets)}"
    assert treg.snapshot("hvdtpu_torch_buckets")["hvdtpu_torch_buckets"][
        "values"][""] == len(opt._buckets)


# ---------------------------------------------------------------------------
# The pipeline, the loader and the checkpoint engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,n,m,v", [
    ("gpipe", 2, 4, 1), ("1f1b", 2, 4, 1), ("zb-h1", 2, 4, 1),
    ("interleaved", 2, 4, 2)])
def test_pipeline_families_match_jax(schedule, n, m, v):
    from horovod_tpu.parallel import pipeline as jpipe
    from horovod_tpu_torch.parallel import pipeline as tpipe
    sched = tpipe.schedule_info(schedule, n, m, num_virtual=v)
    tpipe._recorded_schedules.discard(
        __import__("dataclasses").astuple(sched))
    tpipe._record_schedule(sched)
    jpipe._record_schedule(jpipe.schedule_info(schedule, n, m,
                                               num_virtual=v))
    for name in PIPELINE_FAMILIES:
        tv = {k: x for k, x in treg.snapshot()[name]["values"].items()
              if f'schedule="{schedule}"' in k}
        jv = {k: x for k, x in jreg.snapshot()[name]["values"].items()
              if f'schedule="{schedule}"' in k}
        assert tv == jv and tv, name
    note = [p for _, kind, p in tfr.recorder()._ring if kind == "pipeline"]
    assert note[-1][0] == schedule


def test_pipeline_run_records_its_schedule():
    from horovod_tpu_torch.parallel import pipeline as tpipe
    w = [torch.ones(3, 3, requires_grad=True) for _ in range(2)]
    tpipe._recorded_schedules.clear()
    tpipe._virtual_value_and_grad(
        2, lambda p, x: x @ p, lambda y: y.sum(), w, torch.ones(4, 1, 3),
        schedule="1f1b")
    share = treg.snapshot()["hvdtpu_pipeline_bubble_share"]["values"]
    want = tpipe.schedule_info("1f1b", 2, 4).bubble_share
    assert share['schedule="1f1b"'] == round(want, 6)


def _loader_run(data_mod, reg_mod):
    src = np.arange(40 * 3, dtype=np.float32).reshape(40, 3)
    before = reg_mod.snapshot()
    loader = data_mod.build_loader(src, batch_size=4, rank=0, world_size=2,
                                   seed=3)
    for _ in range(7):               # 5 microbatches a rank an epoch
        next(loader)
    cursor = loader.commit_cursor()
    data_mod.build_loader(src, batch_size=4, rank=1, world_size=2,
                          seed=3).restore(cursor)
    return _delta(before, reg_mod.snapshot(), DATA_FAMILIES)


def test_loader_families_match_jax():
    from horovod_tpu import data as jdata
    from horovod_tpu_torch import data as tdata
    got, want = _loader_run(tdata, treg), _loader_run(jdata, jreg)
    for name in DATA_FAMILIES:
        if name == "hvdtpu_data_load_seconds_total":
            assert got[name][""] > 0 and want[name][""] > 0
        else:
            assert got[name] == want[name], name
    assert got["hvdtpu_data_epochs_total"][""] == 1.0
    assert got["hvdtpu_data_resume_skips_total"][""] > 0
    note = [p for _, kind, p in tfr.recorder()._ring if kind == "data"]
    assert [p[0] for p in note[-3:]] == ["epoch", "cursor_commit", "resume"]


def _prefetch_run(data_mod, reg_mod, **device):
    src = np.arange(40 * 3, dtype=np.float32).reshape(40, 3)
    before = reg_mod.snapshot()
    it = data_mod.prefetch_to_device(
        data_mod.build_loader(src, batch_size=4, rank=0, world_size=1,
                              seed=3, epochs=1), depth=3, **device)
    n = sum(1 for _ in it)
    return n, _delta(before, reg_mod.snapshot(), PREFETCH_FAMILIES)


def test_prefetch_families_match_jax():
    from horovod_tpu import data as jdata
    from horovod_tpu_torch import data as tdata
    (tn, got), (jn, want) = (_prefetch_run(tdata, treg, device="cpu"),
                             _prefetch_run(jdata, jreg))
    assert tn == jn == 10
    assert treg.snapshot()["hvdtpu_data_prefetch_depth"]["values"][""] == \
        jreg.snapshot()["hvdtpu_data_prefetch_depth"]["values"][""] == 3
    for name in ("hvdtpu_data_wait_seconds_total",
                 "hvdtpu_data_h2d_seconds_total"):
        assert got[name][""] > 0 and want[name][""] > 0, name
    assert "" in treg.snapshot()["hvdtpu_data_prefetch_occupancy"]["values"]


def _ckpt_run(engine_cls, reg_mod, tree, root, **kw):
    before = reg_mod.snapshot()
    eng = engine_cls(str(root), keep_last=1, **kw)
    eng.save(tree, 1, block=True)
    eng.save(tree, 2, block=True)
    eng.restore()
    return _delta(before, reg_mod.snapshot(), CKPT_FAMILIES)


def test_checkpoint_families_match_jax(tmp_path):
    from horovod_tpu.checkpoint import CheckpointEngine as JEngine
    from horovod_tpu_torch.checkpoint import CheckpointEngine as TEngine
    rng = np.random.RandomState(0)
    arrays = {"w": rng.standard_normal((8, 4)).astype(np.float32),
              "b": np.arange(5, dtype=np.int32)}
    want = _ckpt_run(JEngine, jreg, arrays, tmp_path / "jax",
                     barrier=lambda name: None)
    got = _ckpt_run(TEngine, treg, {k: torch.from_numpy(v)
                                    for k, v in arrays.items()},
                    tmp_path / "port")
    for name in ("hvdtpu_checkpoint_bytes_written_total",
                 "hvdtpu_checkpoint_shards_written_total",
                 "hvdtpu_checkpoint_gc_steps_total",
                 "hvdtpu_checkpoint_corrupt_shards_total"):
        assert got[name] == want[name], name
    for name in ("hvdtpu_checkpoint_save_seconds",
                 "hvdtpu_checkpoint_restore_seconds"):
        assert got[name][""][0] == want[name][""][0] == \
            (2 if "save" in name else 1)
    assert got["hvdtpu_checkpoint_blocked_seconds_total"][""] > 0
    last = "hvdtpu_checkpoint_last_committed_step"
    assert treg.snapshot()[last]["values"][""] == \
        jreg.snapshot()[last]["values"][""] == 2.0


# ---------------------------------------------------------------------------
# Every Part A family: JAX's kind and help; the exposition; the exports
# ---------------------------------------------------------------------------

def test_every_family_has_jax_kind_and_help(port_world):
    """Resolve every Part A family in both packages and compare."""
    from horovod_tpu.checkpoint import engine as jckpt
    from horovod_tpu.data import loader as jloader
    from horovod_tpu.data import prefetch as jprefetch
    from horovod_tpu.parallel import pipeline as jpipe
    from horovod_tpu.torch import _ShimMetrics as JShim
    from horovod_tpu_torch import optimizer as topt
    from horovod_tpu_torch.checkpoint import engine as tckpt
    from horovod_tpu_torch.data import loader as tloader
    from horovod_tpu_torch.data import prefetch as tprefetch
    from horovod_tpu_torch.parallel import pipeline as tpipe
    jhvd.ops.collective._EngineMetrics()
    jsm.StepTimer("meta_fw")
    JShim.get()
    jpipe._PipelineMetrics.get()
    jloader._metrics()
    jprefetch._metrics()
    jckpt._metrics()
    tcoll._EngineMetrics()
    tsm.StepTimer("meta_fw", device="cpu")
    topt._ShimMetrics.get()
    tpipe._PipelineMetrics.get()
    tloader._metrics()
    tprefetch._metrics()
    tckpt._metrics()
    jsnap, tsnap = jreg.snapshot(), treg.snapshot()
    for name in (ENGINE_FAMILIES + STEP_FAMILIES + SHIM_FAMILIES
                 + PIPELINE_FAMILIES + DATA_FAMILIES + PREFETCH_FAMILIES
                 + CKPT_FAMILIES):
        assert (tsnap[name]["type"], tsnap[name]["help"]) == \
            (jsnap[name]["type"], jsnap[name]["help"]), name


_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? '
                     r'(-?[0-9.e+\-]+|[+-]?Inf|NaN)$')


def test_prometheus_text_parses(port_world):
    import horovod_tpu_torch as hvd
    hvd.allreduce(torch.ones(8), name="prom.ar")
    with hvd.StepMetrics(batch_size=2):
        pass
    text = hvd.prometheus_text()
    types = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
        elif line and not line.startswith("#"):
            assert _SAMPLE.match(line), line
    assert types["hvdtpu_op_phase_seconds"] == "histogram"
    assert types["hvdtpu_ops_total"] == "counter"
    assert types["hvdtpu_step_phase_share"] == "gauge"
    assert 'hvdtpu_ops_total{op="allreduce"}' in text
    series = [ln for ln in text.splitlines()
              if ln.startswith("hvdtpu_op_phase_seconds_bucket")]
    assert any('le="+Inf"' in ln for ln in series)


def test_top_level_exports():
    import horovod_tpu_torch as hvd
    for name in ("StepMetrics", "metrics_registry", "prometheus_text",
                 "metrics_snapshot"):
        assert name in hvd.__all__ and hasattr(hvd, name)
    assert hvd.metrics_registry() is treg.registry()
    assert issubclass(hvd.StepMetrics, tsm.StepTimer)
    assert hvd.StepMetrics(device="cpu").framework == "torch"
    assert math.isfinite(len(hvd.prometheus_text()))
