"""The port's self-healing plane against the JAX package's.

Counterparts of ``tests/test_adaptation.py``'s cases that have one in
the port, with JAX's own functions as the oracle where both packages
compute the same thing: the fault grammar and its tick windows, the
policy's ladder and hysteresis (both policies on the same lateness
series give the same events), the coordinator's adaptation (shrink,
wire epochs, the ``slow_rank`` event), the stall blame, the skew
tracker's re-keying, the engine's wire epochs, the typed failures, the
slot penalties and their readmission, the error-feedback reset on a
wire switch, and the runner's fault flags. JAX's hardened TCP client
(``TestCoordinatorClientRetry``) has no counterpart: the port's rounds
ride the gloo control group. The heartbeat cases of
``tests/test_elastic.py`` (``TestCoordinatorFailureDetection``) are
here too.

Then spawned gloo jobs, each with its own time limit: a rank that stops
joining rounds fails the others' ops with a ``heartbeat_timeout``; a
``drop_announce`` rank is blamed by the stall reports and escalated; a
delayed rank drives the ladder up and back down (``mesh_parity``'s
``adapt`` at two ranks), every rank on the same wire, each group equal
to its explicit-wire replay bit for bit, and a nonzero rank's health
alert reaches rank 0's policy; and ``test_adaptation_e2e.py``'s first
scenario at two ranks: the policy evicts the delayed rank, whose typed
``SlowRankFailure`` makes ``run_elastic`` re-rendezvous without it, and
the job finishes at one rank.
"""

import os
import pickle
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_launch_workers as workers
from horovod_tpu.adaptation import AdaptationConfig as JConfig
from horovod_tpu.adaptation import AdaptationPolicy as JPolicy
from horovod_tpu.adaptation import FaultInjector as JInjector
from horovod_tpu.adaptation import parse_spec as jparse
from horovod_tpu_torch.adaptation import (AdaptationConfig,
                                          AdaptationPolicy, FaultInjector,
                                          parse_spec)
from horovod_tpu_torch.adaptation import faults as faults_mod
from horovod_tpu_torch.elastic import SlowRankFailure, WorkerFailure
from horovod_tpu_torch.elastic.failure import failure_from_event
from horovod_tpu_torch.observability import registry as treg
from horovod_tpu_torch.ops import collective as tcoll
from horovod_tpu_torch.ops import control_plane as tcp

TESTS = os.path.dirname(os.path.abspath(__file__))
JOB_TIMEOUT_S = 120
WORKER_ENV = {"PYTHONPATH": TESTS, "OMP_NUM_THREADS": "1"}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(fn, n, *args):
    """Run ``fn(rank, n, port, *args)`` on n processes; fail on a hang."""
    ctx = mp.spawn(fn, args=(n, _free_port()) + args, nprocs=n, join=False)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {n}-rank job did not finish within "
                        f"{JOB_TIMEOUT_S} s")


# ---------------------------------------------------------------------------
# Fault-spec grammar and injector
# ---------------------------------------------------------------------------

FULL_SPEC = ("rank=2:delay=80ms:from_step=50; rank=1:crash_at=30:gen=0; "
             "rank=*:slow_h2d=2ms; "
             "rank=3:drop_announce:from_step=5:until_step=9")
FIELDS = ("rank", "gen", "from_step", "until_step", "delay_s", "slow_h2d_s",
          "crash_at", "drop_announce")


def _fields(clauses):
    return [tuple(getattr(c, f) for f in FIELDS) for c in clauses]


class TestFaultSpec:
    def test_full_grammar(self):
        cl = parse_spec(FULL_SPEC)
        assert _fields(cl) == _fields(jparse(FULL_SPEC))
        assert len(cl) == 4
        assert cl[0].rank == 2 and cl[0].delay_s == pytest.approx(0.08)
        assert cl[0].from_step == 50
        assert cl[1].crash_at == 30 and cl[1].gen == 0
        assert cl[2].rank is None and cl[2].slow_h2d_s == pytest.approx(2e-3)
        assert cl[3].drop_announce and cl[3].until_step == 9

    def test_duration_units(self):
        for text, want in (("rank=0:delay=1.5s", 1.5),
                           ("rank=0:delay=500us", 5e-4),
                           ("rank=0:delay=0.25", 0.25)):
            assert parse_spec(text)[0].delay_s == pytest.approx(want)
            assert parse_spec(text)[0].delay_s == jparse(text)[0].delay_s

    def test_missing_rank_rejected(self):
        with pytest.raises(ValueError, match="rank"):
            parse_spec("delay=80ms")

    def test_unknown_field_rejected(self):
        with pytest.raises(ValueError, match="unknown fault-spec field"):
            parse_spec("rank=0:dealy=80ms")

    def test_injector_filters_rank_and_gen(self):
        text = "rank=2:delay=10ms; rank=1:delay=5ms:gen=1"
        for rank, gen, n in ((2, 0, 1), (1, 0, 0), (1, 1, 1), (0, 0, 0)):
            assert len(FaultInjector(parse_spec(text), rank=rank,
                                     generation=gen).clauses) == n
            assert len(JInjector(jparse(text), rank=rank,
                                 generation=gen).clauses) == n

    def test_window_and_tick(self):
        text = "rank=0:drop_announce:from_step=2:until_step=4"
        got = []
        for inj in (FaultInjector(parse_spec(text), rank=0),
                    JInjector(jparse(text), rank=0)):
            active = []
            for _ in range(6):
                active.append(inj.drop_announce_active())
                inj.on_enqueue()
            got.append(active)
        assert got[0] == got[1] == [False, False, True, True, False, False]

    def test_delay_applied_in_window(self):
        inj = FaultInjector(
            parse_spec("rank=0:delay=30ms:from_step=1:until_step=2"),
            rank=0)
        t0 = time.monotonic()
        inj.on_enqueue()                     # tick 0: outside window
        before = time.monotonic() - t0
        t0 = time.monotonic()
        inj.on_enqueue()                     # tick 1: 30 ms delay
        during = time.monotonic() - t0
        assert before < 0.02 and during >= 0.03
        snap = treg.snapshot("hvdtpu_fault_injections_total")
        assert snap["hvdtpu_fault_injections_total"]["values"][
            'kind="delay"'] >= 1

    def test_env_resolution_off_by_default(self, monkeypatch):
        monkeypatch.delenv("HOROVOD_TPU_FAULT_SPEC", raising=False)
        monkeypatch.delenv("HOROVOD_FAULT_SPEC", raising=False)
        faults_mod.reset()
        try:
            assert faults_mod.injector() is None
        finally:
            faults_mod.reset()

    def test_env_resolution_other_rank_is_none(self, monkeypatch):
        monkeypatch.setenv("HOROVOD_TPU_FAULT_SPEC", "rank=7:delay=1ms")
        faults_mod.reset()
        try:
            assert faults_mod.injector() is None
        finally:
            faults_mod.reset()


# ---------------------------------------------------------------------------
# The policy's ladder: both packages' policies on the same lateness
# ---------------------------------------------------------------------------

def _policies(allow_evict=True, **kw):
    base = dict(threshold_s=0.05, sustain_s=1.0, cooldown_s=2.0,
                interval_s=0.0)
    base.update(kw)
    return (AdaptationPolicy(AdaptationConfig(**base),
                             allow_evict=allow_evict),
            JPolicy(JConfig(**base), allow_evict=allow_evict))


def _drive(policies, series):
    """Each policy's events over ``series`` [(lateness map, t)]."""
    out = []
    for p in policies:
        evs = []
        for lat, t in series:
            evs += p.observe(lat, t)
        out.append(evs)
    return out


class TestAdaptationPolicy:
    def test_monotonic_escalation_then_deescalation(self):
        ps = _policies()
        up = [({2: 0.2, 0: 0.001}, 0.6 * i) for i in range(20)]
        down = [({0: 0.001}, 12.0 + 0.7 * i) for i in range(20)]
        t_evs, j_evs = _drive(ps, up + down)
        assert t_evs == j_evs
        esc = [e["name"] for e in t_evs if e["action"] == "escalate"]
        assert esc == ["shrink", "bf16", "int8x256", "fp8x256", "evict"]
        deesc = [e["name"] for e in t_evs if e["action"] == "deescalate"]
        assert deesc == ["fp8x256", "int8x256", "bf16", "shrink"]
        assert ps[0].evicted == {2}
        assert ps[0].tier == 0 and ps[0].wire_spec() is None

    def test_borderline_rank_no_flapping(self):
        ps = _policies()
        series = [({1: 0.051 if i % 2 == 0 else 0.04}, 0.6 * i)
                  for i in range(60)]
        t_evs, j_evs = _drive(ps, series)
        assert t_evs == j_evs == [] and ps[0].tier == 0

    def test_each_step_needs_its_own_sustain_window(self):
        ps = _policies(sustain_s=1.0)
        for p in ps:
            evs = p.observe({1: 0.2}, 0.0) + p.observe({1: 0.2}, 0.5)
            assert evs == []
            assert [e["name"] for e in p.observe({1: 0.2}, 1.1)] == \
                ["shrink"]
            assert p.observe({1: 0.2}, 1.6) == []

    def test_eviction_edge_triggered_second_straggler(self):
        ps = _policies(tiers=("shrink", "evict"))
        series = [({1: 0.2, 3: 0.3}, 1.2 * i) for i in range(10)]
        t_evs, j_evs = _drive(ps, series)
        assert t_evs == j_evs
        assert [e["rank"] for e in t_evs if e["name"] == "evict"] == [3, 1]
        assert ps[0].evicted == {1, 3} and ps[0].tier == 0

    def test_evict_gated_without_failure_plane(self):
        ps = _policies(allow_evict=False, tiers=("shrink", "evict"))
        t_evs, j_evs = _drive(ps, [({1: 0.2}, 1.2 * i) for i in range(10)])
        assert t_evs == j_evs
        assert [e["name"] for e in t_evs] == ["shrink"]
        assert ps[0].evicted == set()

    def test_wire_spec_tracks_strongest_active_tier(self):
        for p in _policies():
            assert p.wire_spec() is None
            p.tier = 2
            assert p.wire_spec() == "bf16"
            p.tier = 4
            assert p.wire_spec() == "fp8x256"


# ---------------------------------------------------------------------------
# The coordinator: shrink, wire epochs, eviction event
# ---------------------------------------------------------------------------

def _skew(coord, rank_late, lateness, n=6):
    """Feed the coordinator's skew tracker n completed names with
    ``rank_late`` announcing ``lateness`` behind the others."""
    base = time.monotonic()
    for i in range(n):
        t = base + i * 1e-3
        for rk in range(coord.size):
            coord._skew.note(rk, [f"skew.{base}.{i}"],
                             t + (lateness if rk == rank_late else 0.0))


def _adapting(monkeypatch, timeout="5", tiers=None):
    monkeypatch.setenv("HOROVOD_TPU_ADAPTATION", "1")
    monkeypatch.setenv("HOROVOD_TPU_ADAPT_THRESHOLD", "0.01")
    monkeypatch.setenv("HOROVOD_TPU_ADAPT_SUSTAIN", "0")
    monkeypatch.setenv("HOROVOD_TPU_ADAPT_INTERVAL", "0")
    if tiers:
        monkeypatch.setenv("HOROVOD_TPU_ADAPT_TIERS", tiers)
    monkeypatch.setenv("HOROVOD_TPU_FAILURE_TIMEOUT", timeout)
    return tcp.Coordinator(2)


class TestCoordinatorAdaptation:
    def test_shrink_wire_epochs_and_eviction(self, monkeypatch):
        coord = _adapting(monkeypatch)
        base = 1 << 20
        _skew(coord, rank_late=1, lateness=0.05)
        for _ in range(8):
            coord._last_policy_tick = 0.0
            coord.maybe_adapt()
            coord.plan(base)        # groups planned between evaluations
        assert coord.threshold(base) == base // 4
        specs = [sp for _, sp in coord.wire_epochs]
        assert specs == ["bf16", "int8x256", "fp8x256"]
        seqs = [s for s, _ in coord.wire_epochs]
        assert seqs == sorted(seqs)
        failures = coord.check_failures()
        assert any(f["kind"] == "slow_rank" and f["rank"] == 1
                   for f in failures)
        params = coord.params()
        assert list(params) == ["wire_epochs"]
        assert [sp for _, sp in params["wire_epochs"]] == specs

    def test_policy_off_by_default(self, monkeypatch):
        monkeypatch.delenv("HOROVOD_TPU_ADAPTATION", raising=False)
        monkeypatch.delenv("HOROVOD_ADAPTATION", raising=False)
        coord = tcp.Coordinator(2)
        assert coord._policy is None
        _skew(coord, rank_late=1, lateness=0.1)
        coord.maybe_adapt()
        assert coord.threshold(1 << 20) == 1 << 20
        assert coord.wire_epochs == [] and coord.params() == {}

    def test_eviction_gated_without_failure_timeout(self, monkeypatch):
        coord = _adapting(monkeypatch, timeout="0", tiers="evict")
        _skew(coord, rank_late=1, lateness=0.05)
        for _ in range(6):
            coord._last_policy_tick = 0.0
            coord.maybe_adapt()
        assert coord._policy_failures == []


# ---------------------------------------------------------------------------
# Stall blame, heartbeats and failure events
# ---------------------------------------------------------------------------

def _meta(name):
    return tcp.Meta(name, tcp.ALLREDUCE, "float32", (4,))


class TestStallEscalation:
    def test_drop_announce_blamed_and_escalated(self, monkeypatch):
        """A mute-but-breathing rank: it joins every round (its heartbeat
        stays fresh) but its announcement never comes, so only repeated
        stall reports can name it; past the failure timeout the repeat
        offender becomes a typed failure event."""
        coord = tcp.Coordinator(2, stall_warning_s=0.05)
        coord.failure_timeout_s = 0.2
        inj = FaultInjector(parse_spec("rank=1:drop_announce"), rank=1)
        coord.announce(0, [_meta("t0")])
        coord.announce(1, [] if inj.drop_announce_active()
                       else [_meta("t0")])
        assert "t0" in coord._table
        assert 1 not in coord._table["t0"].by_rank
        time.sleep(0.06)
        coord._last_stall_check = 0.0
        assert coord.check_stalls()
        assert 1 in coord._stall_blame
        coord.announce(1, [])           # the heartbeat stays fresh
        assert not any(f["kind"] == "heartbeat_timeout"
                       for f in coord.check_failures())
        time.sleep(0.25)
        coord.announce(0, [])
        coord.announce(1, [])
        coord._last_stall_check = 0.0
        coord.check_stalls()
        stalls = [f for f in coord.check_failures() if f["kind"] == "stall"]
        assert any(f["rank"] == 1 for f in stalls)
        snap = treg.snapshot("hvdtpu_coordinator_")
        assert snap["hvdtpu_coordinator_failure_events_total"]["values"][
            'kind="stall"'] >= 1

    def test_blame_cleared_when_episode_resolves(self):
        coord = tcp.Coordinator(2, stall_warning_s=0.05)
        coord.failure_timeout_s = 10.0
        coord.announce(0, [_meta("t1")])
        time.sleep(0.06)
        coord._last_stall_check = 0.0
        coord.check_stalls()
        assert 1 in coord._stall_blame
        coord.announce(1, [_meta("t1")])
        coord.plan(1 << 20)             # quorum: the name leaves the table
        time.sleep(0.06)
        coord._last_stall_check = 0.0
        coord.check_stalls()
        assert coord._stall_blame == {}


class TestCoordinatorFailureDetection:
    """``tests/test_elastic.py:451-518``: the port's heartbeat is the
    last round a rank joined."""

    def _coord(self):
        coord = tcp.Coordinator(2)
        coord.failure_timeout_s = 0.25
        return coord

    def test_heartbeat_and_stall_escalation(self):
        coord = self._coord()
        coord.announce(0, [_meta("e.t")])
        coord.announce(1, [])
        coord.plan(1 << 20)
        assert coord.check_failures() == []
        time.sleep(0.35)
        coord.announce(0, [])           # rank 0 keeps joining rounds
        failures = coord.check_failures()
        kinds = {f["kind"] for f in failures}
        assert "heartbeat_timeout" in kinds     # rank 1 went silent
        assert "stall" in kinds                 # e.t stuck partial
        ranks = {f["rank"] for f in failures}
        assert 1 in ranks and 0 not in ranks

    def test_never_seen_ranks_not_flagged(self):
        coord = self._coord()
        time.sleep(0.3)
        coord.announce(0, [])
        assert coord.check_failures() == []

    def test_disabled_by_default(self, monkeypatch):
        monkeypatch.delenv("HOROVOD_TPU_FAILURE_TIMEOUT", raising=False)
        monkeypatch.delenv("HOROVOD_FAILURE_TIMEOUT", raising=False)
        coord = tcp.Coordinator(2)
        assert coord.failure_timeout_s == 0.0
        assert coord.check_failures() == []


# ---------------------------------------------------------------------------
# Straggler telemetry re-keyed across world sizes
# ---------------------------------------------------------------------------

class TestSkewRekey:
    def test_evicted_rank_does_not_linger(self):
        coord4 = tcp.Coordinator(4)
        _skew(coord4, rank_late=3, lateness=0.05)
        snap = treg.snapshot()
        vals = snap["hvdtpu_negotiate_lateness_seconds"]["values"]
        assert 'rank="3"' in vals
        assert snap["hvdtpu_straggler_rank"]["values"][""] == 3
        tcp.Coordinator(2)          # the re-rendezvoused world
        snap = treg.snapshot()
        vals = snap["hvdtpu_negotiate_lateness_seconds"]["values"]
        assert set(vals) == {'rank="0"', 'rank="1"'}
        assert snap["hvdtpu_straggler_rank"]["values"][""] == -1
        assert snap["hvdtpu_straggler_lateness_seconds"]["values"][""] == 0.0


# ---------------------------------------------------------------------------
# The engine's wire epochs
# ---------------------------------------------------------------------------

def _bare_engine():
    eng = tcoll.CollectiveEngine.__new__(tcoll.CollectiveEngine)
    eng._metrics = tcoll._EngineMetrics()
    eng._wire_epochs = []
    return eng


def _reqs(dtype=torch.float32, wire=None):
    meta = tcp.Meta("t", tcp.ALLREDUCE, tcp.dtype_name(dtype), (8,),
                    wire=wire)
    return [tcoll._Request(meta, torch.ones(8, dtype=dtype),
                           tcoll.Handle("t", None), None)]


class TestWireOverride:
    def test_epoch_selection_by_seq(self):
        eng = _bare_engine()
        eng._wire_epochs = [(5, "bf16"), (9, "int8x256"), (12, "")]
        g = _reqs()
        assert eng._wire_override_for(4, g) is None
        assert eng._wire_override_for(5, g) == "bf16"
        assert eng._wire_override_for(8, g) == "bf16"
        assert eng._wire_override_for(9, g) == "int8x256"
        assert eng._wire_override_for(12, g) is None   # back to raw

    def test_ineligible_groups_untouched(self):
        eng = _bare_engine()
        eng._wire_epochs = [(0, "int8x256")]
        assert eng._wire_override_for(3, _reqs(dtype=torch.int32)) is None
        assert eng._wire_override_for(3, _reqs(wire="fp8x256")) is None
        assert eng._wire_override_for(3, _reqs()) == "int8x256"
        snap = treg.snapshot("hvdtpu_adaptation_applied")
        assert snap["hvdtpu_adaptation_applied_groups_total"]["values"][
            'spec="int8x256"'] >= 1

    def test_side_channel_installs_epochs(self):
        eng = _bare_engine()
        eng._apply_params({"wire_epochs": [[3, "bf16"]]})
        assert eng._wire_epochs == [(3, "bf16")]


# ---------------------------------------------------------------------------
# Typed failures and slot penalties
# ---------------------------------------------------------------------------

class TestTypedFailurePropagation:
    def test_failure_from_event_types(self):
        f = failure_from_event({"rank": 2, "kind": "slow_rank",
                                "detail": "late"})
        assert isinstance(f, SlowRankFailure) and f.rank == 2
        f = failure_from_event({"rank": 1, "kind": "heartbeat_timeout"})
        assert isinstance(f, WorkerFailure)
        assert not isinstance(f, SlowRankFailure)

    def test_slow_rank_failure_pickles(self):
        f = SlowRankFailure(rank=3, host="h1", detail="late")
        g = pickle.loads(pickle.dumps(f))
        assert isinstance(g, SlowRankFailure)
        assert (g.rank, g.host, g.kind) == (3, "h1", "slow_rank")

    def test_driver_service_reraises_typed_failure(self):
        from horovod_tpu_torch.runner.driver_service import DriverService
        from horovod_tpu_torch.runner.secret import make_secret_key
        from horovod_tpu_torch.runner.timeout import Timeout
        svc = DriverService(2, make_secret_key(), b"")
        try:
            svc._results[0] = (None, SlowRankFailure(rank=1, detail="x"))
            svc._results[1] = ({"ok": True}, None)
            svc._all_done.set()
            with pytest.raises(SlowRankFailure) as ei:
                svc.wait_for_results(Timeout(5, "t {timeout}"))
            assert ei.value.rank == 1
        finally:
            svc.shutdown()

    def test_plain_errors_keep_runtime_error(self):
        from horovod_tpu_torch.runner.driver_service import DriverService
        from horovod_tpu_torch.runner.secret import make_secret_key
        from horovod_tpu_torch.runner.timeout import Timeout
        svc = DriverService(1, make_secret_key(), b"")
        try:
            svc._results[0] = (None, "Traceback ... boom")
            svc._all_done.set()
            with pytest.raises(RuntimeError, match="rank 0"):
                svc.wait_for_results(Timeout(5, "t {timeout}"))
        finally:
            svc.shutdown()


class TestSlotPenaltyReadmission:
    def test_probe_gates_readmission_with_backoff(self):
        from horovod_tpu_torch.elastic.driver import _SlotPenalties
        verdict = {"alive": False}
        calls = []

        def probe(host):
            calls.append(host)
            return verdict["alive"]

        p = _SlotPenalties(0.05, probe=probe, backoff_factor=2.0)
        p.penalize("h1", window_s=0.05)
        slots = [("h1", 2)]
        assert p.apply(slots) == [("h1", 1)]      # penalty active
        time.sleep(0.06)
        assert p.apply(slots) == [("h1", 1)]      # probe fails: renewed
        assert calls == ["h1"]
        assert p._until["h1"][0][1] == pytest.approx(0.1)
        time.sleep(0.11)
        verdict["alive"] = True
        assert p.apply(slots) == [("h1", 2)]      # readmitted
        assert calls == ["h1", "h1"]

    def test_no_probe_expiry_readmits(self):
        from horovod_tpu_torch.elastic.driver import _SlotPenalties
        p = _SlotPenalties(0.03)
        p.penalize("h1")
        assert p.apply([("h1", 1)]) == []
        time.sleep(0.04)
        assert p.apply([("h1", 1)]) == [("h1", 1)]

    def test_slow_rank_window_distinct(self):
        from horovod_tpu_torch.elastic.driver import _SlotPenalties
        p = _SlotPenalties(100.0)
        p.penalize("h1", window_s=0.02)
        time.sleep(0.03)
        assert p.apply([("h1", 1)]) == [("h1", 1)]

    def test_host_alive_local(self):
        from horovod_tpu_torch.elastic.discovery import host_alive
        assert host_alive("localhost")


# ---------------------------------------------------------------------------
# Error feedback across a wire switch (the optimizer's set_compression)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_world():
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _one_step(hvd, opt, w, g):
    opt.zero_grad()
    (w * g).sum().backward()
    opt.step()


class TestErrorFeedbackSpecSwitch:
    def test_residual_reset_on_set_compression(self, port_world):
        """The residual after a step is the gradient less its local
        round trip on the wire; after a switch it is measured against the
        new wire alone (JAX's ``local_roundtrip`` as the oracle)."""
        from horovod_tpu.compression import Compression as JComp
        hvd = port_world
        rng = np.random.RandomState(0)
        g = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
        w = torch.nn.Parameter(torch.zeros(512))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([w], lr=0.1), named_parameters=[("w", w)],
            compression=hvd.Compression.int8_blockwise)
        _one_step(hvd, opt, w, g)
        (res,) = opt._bucket_residuals.values()
        want = np.asarray(g.numpy() - np.asarray(
            JComp.int8_blockwise.local_roundtrip(g.numpy())))
        np.testing.assert_allclose(res.numpy(), want, rtol=1e-6, atol=1e-7)
        opt.set_compression(hvd.Compression.fp8_blockwise)
        _one_step(hvd, opt, w, g)
        (res,) = opt._bucket_residuals.values()
        want = np.asarray(g.numpy() - np.asarray(
            JComp.fp8_blockwise.local_roundtrip(g.numpy())))
        np.testing.assert_allclose(res.numpy(), want, rtol=1e-6, atol=1e-7)

    def test_set_compression_none_drops_error_feedback(self, port_world):
        """JAX re-derives ``error_feedback`` for the new wire: off for no
        compression. The port's buckets keep no residual then, and a
        cast compressor, which would change the buckets' wire dtype, is
        refused."""
        hvd = port_world
        w = torch.nn.Parameter(torch.zeros(64))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([w], lr=0.1), named_parameters=[("w", w)],
            compression=hvd.Compression.int8_blockwise)
        _one_step(hvd, opt, w, torch.ones(64))
        assert opt._bucket_residuals
        opt.set_compression(hvd.Compression.none)
        _one_step(hvd, opt, w, torch.ones(64))
        assert opt._bucket_residuals == {}
        with pytest.raises(ValueError, match="wire dtype"):
            opt.set_compression(hvd.Compression.fp16)


# ---------------------------------------------------------------------------
# The runner's fault flags
# ---------------------------------------------------------------------------

class TestRunnerFaultCLI:
    def test_bad_fault_spec_rejected_at_launch(self):
        from horovod_tpu_torch.runner.__main__ import main
        with pytest.raises(ValueError, match="fault-spec"):
            main(["-np", "1", "--fault-spec", "delay=80ms", "--",
                  sys.executable, "-c", "pass"])

    def test_fault_spec_and_adaptation_exported(self):
        from horovod_tpu_torch.runner.__main__ import main
        rc = main(["-np", "1", "--no-tag-output",
                   "--fault-spec", "rank=9:delay=1ms", "--adaptation",
                   "--", sys.executable, "-c",
                   "import os; assert os.environ['HOROVOD_TPU_FAULT_SPEC']"
                   " == 'rank=9:delay=1ms'; "
                   "assert os.environ['HOROVOD_TPU_ADAPTATION'] == '1'"])
        assert rc == 0


# ---------------------------------------------------------------------------
# Spawned gloo jobs
# ---------------------------------------------------------------------------

def _heartbeat_worker(rank, n, port, outdir):
    """Rank 1's engine stops joining rounds after its first op; rank 0's
    next op must fail with rank 1's heartbeat_timeout, and so must any
    op after it."""
    os.environ["HOROVOD_TPU_FAILURE_TIMEOUT"] = "1.5"
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}",
             rank=rank, world_size=n)
    hvd.allreduce(torch.ones(4), name="hb.first")
    out = {}
    if rank == 1:
        eng = tcoll.engine()
        eng._negotiate = lambda *a, **k: time.sleep(3600)   # wedged
        time.sleep(0.2)
        eng._arrived.set()          # leave the idle wait: into the hang
        with open(os.path.join(outdir, "rank1.pkl"), "wb") as f:
            pickle.dump(out, f)
        time.sleep(4)
        os._exit(0)
    t0 = time.monotonic()
    try:
        hvd.allreduce(torch.ones(4), name="hb.second")
        out["first"] = None
    except Exception as e:
        out["first"] = (type(e).__name__, getattr(e, "rank", None),
                        getattr(e, "kind", None), time.monotonic() - t0)
    try:
        hvd.allreduce(torch.ones(4), name="hb.third")
        out["later"] = None
    except Exception as e:
        out["later"] = (type(e).__name__, getattr(e, "kind", None))
    with open(os.path.join(outdir, "rank0.pkl"), "wb") as f:
        pickle.dump(out, f)
    os._exit(0)


def test_engine_heartbeat_timeout_fails_pending_ops(tmp_path):
    _spawn(_heartbeat_worker, 2, str(tmp_path))
    with open(tmp_path / "rank0.pkl", "rb") as f:
        out = pickle.load(f)
    name, rank, kind, waited = out["first"]
    assert (name, rank, kind) == ("WorkerFailure", 1, "heartbeat_timeout")
    assert waited < 10.0
    assert out["later"] == ("WorkerFailure", "heartbeat_timeout")


def _drop_worker(rank, n, port, outdir):
    """Rank 1 withholds its announcements (it keeps joining rounds):
    rank 0's coordinator blames it from the stall reports and, past the
    failure timeout, every rank's op fails with rank 1's stall event."""
    os.environ.update(HOROVOD_TPU_FAILURE_TIMEOUT="1.0",
                      HOROVOD_TPU_FAULT_SPEC="rank=1:drop_announce:"
                                             "from_step=2")
    import horovod_tpu_torch as hvd
    faults_mod.reset()
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}",
             rank=rank, world_size=n)
    hvd.allreduce(torch.ones(4), name="drop.first")      # tick 1: sent
    eng = tcoll.engine()
    eng._coord.stall_warning_s = 0.2
    # The rank's own stall escalation stays out of the way: the event
    # under test is rank 0's coordinator's.
    eng.failure_timeout_s = 60.0
    out = {}
    try:
        hvd.allreduce(torch.ones(4), name="drop.second")
        out["err"] = None
    except Exception as e:
        out["err"] = (type(e).__name__, getattr(e, "rank", None),
                      getattr(e, "kind", None))
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    os._exit(0)


def test_engine_drop_announce_escalates_to_stall_failure(tmp_path):
    _spawn(_drop_worker, 2, str(tmp_path))
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            out = pickle.load(f)
        assert out["err"][0] == "WorkerFailure", out
        assert out["err"][1:] == (1, "stall"), out


def _alert_worker(rank, n, port, outdir):
    """Rank 1's health monitor fires a step-time regression: its sink
    carries the alert to rank 0's policy in the next round."""
    os.environ["HOROVOD_TPU_ADAPTATION"] = "1"
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.observability import health
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}",
             rank=rank, world_size=n)
    if rank == 1:
        mon = health.default_monitor()
        mon.refire_s = 1e9
        for t in range(30):
            mon.observe({'hvdtpu_step_seconds{framework="t"}|mean':
                         0.010 if t < 20 else 0.013}, t=float(t))
    for k in range(5):
        hvd.allreduce(torch.ones(4), name=f"alert.{k}")
        time.sleep(0.05)
    out = {}
    if rank == 0:
        snap = treg.snapshot()
        out = {k: snap.get(k, {}).get("values", {}) for k in (
            "hvdtpu_coordinator_alert_notes_total",
            "hvdtpu_adaptation_alert_inputs_total")}
    hvd.shutdown()
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def test_health_alert_reaches_rank0_policy(tmp_path):
    """Deviation 34 ended: a nonzero rank's ladder-input alert reaches
    rank 0's coordinator and its policy."""
    _spawn(_alert_worker, 2, str(tmp_path))
    with open(tmp_path / "rank0.pkl", "rb") as f:
        out = pickle.load(f)
    key = 'kind="step_time_regression"'
    assert out["hvdtpu_coordinator_alert_notes_total"][key] == 1.0
    assert out["hvdtpu_adaptation_alert_inputs_total"][key] == 1.0


def test_ladder_climbs_and_unwinds_on_a_delayed_rank():
    """``mesh_parity``'s ``adapt`` at two gloo ranks and a tiny width:
    JAX's ladder order up and down, inside the fault's window, no climb
    without the fault, the same wire on every rank for every group, and
    every group bit for bit its explicit-wire replay."""
    from horovod_tpu_torch.experiments import mesh_parity
    line = mesh_parity._adapt(1, "cpu", dict(vocab=64, d_model=32,
                                             n_heads=4, d_ff=64,
                                             max_seq=32), world=2)
    assert line["climbed"] == ["shrink", "bf16", "int8x256", "fp8x256"]
    assert line["unwound"] == ["fp8x256", "int8x256", "bf16", "shrink"]
    assert line["ladder_ok"]
    assert line["ladder_in_window"], (line["fault_steps"],
                                      line["transitions"])
    assert line["quiet_ok"], line["quiet_escalations"]
    # A tier lasts one sustain window; on a loaded host it may pass
    # without a group, but the top one holds until the unwinding.
    assert "fp8x256" in line["wires_seen"]
    assert set(line["wires_seen"]) <= {"bf16", "int8x256", "fp8x256"}
    assert line["same_wires_every_rank"] and line["same_epochs_every_rank"]
    assert line["epochs"][-1][1] == ""
    assert line["max_abs_diff_vs_explicit"] == 0.0


def test_policy_evicts_delayed_rank_and_run_elastic_recovers(tmp_path):
    """``test_adaptation_e2e.py``'s first scenario at two gloo ranks: rank
    1 delayed 60 ms per collective in generation 0; the policy climbs
    the whole ladder and evicts it; every rank's op fails with its typed
    ``SlowRankFailure``; ``run_elastic`` penalizes its slot with the
    short slow-rank window and relaunches at one rank from the last
    commit, which finishes every step."""
    from horovod_tpu_torch.elastic import FailureConfig, run_elastic
    total = 60
    env = dict(WORKER_ENV,
               HOROVOD_TPU_FAULT_SPEC="rank=1:delay=60ms:gen=0",
               HOROVOD_TPU_ADAPTATION="1",
               HOROVOD_TPU_ADAPT_THRESHOLD="0.02",
               HOROVOD_TPU_ADAPT_SUSTAIN="0.2",
               HOROVOD_TPU_ADAPT_INTERVAL="0")
    cfg = FailureConfig(failure_timeout_s=30.0, max_restarts=2,
                        backoff_s=0.2, slow_blacklist_s=600.0)
    results = run_elastic(
        workers.adaptive_quadratic, args=(total, 2, str(tmp_path)),
        min_np=1, max_np=2, hosts="localhost:2",
        state_dir=str(tmp_path / "estate"), config=cfg, extra_env=env,
        start_timeout=JOB_TIMEOUT_S, run_timeout=JOB_TIMEOUT_S)
    assert len(results) == 1
    final = results[0]
    assert final["gen"] >= 1 and final["size"] == 1
    assert final["steps"] == list(range(final["start"], total))
    assert 0 < final["start"] < total
    with open(tmp_path / "gen0_rank0.pkl", "rb") as f:
        g0 = pickle.load(f)
    assert g0["error"] == ("SlowRankFailure", 1)
    trans = g0["hvdtpu_adaptation_transitions_total"]
    for tier in ("shrink", "bf16", "int8x256", "fp8x256", "evict"):
        assert trans.get(f'action="escalate",tier="{tier}"') == 1.0
    assert g0["hvdtpu_adaptation_evictions_total"] == {'rank="1"': 1.0}
