"""The port's autotuners (``horovod_tpu_torch/autotune``) against the JAX
package's (``horovod_tpu/autotune``): the counterpart of
``tests/test_autotune_global.py``, ``tests/test_autotune_mp.py`` and the
non-slow case of ``tests/test_autotune.py``.

- Each case of ``test_autotune_global.py`` that has a counterpart runs
  one scenario through both packages and compares what comes out: the
  registry and its domains, the enumeration order and rungs, the GP's
  posterior and suggestions for the same observations, the apply
  plane's routing and refusals, the tuner's moves, verdicts and flight
  recorder events on the same measurement table, the windowed step time
  over the same history files, the spec_tokens controller and the
  wire-epoch arbiter's precedence.
- The coordinator's arbitration over the engine's rounds, and a mid-run
  fusion flip (``test_autotune_mp.py``), each in a 2-rank gloo job with
  its own time limit.
- The legacy ``HOROVOD_AUTOTUNE`` tuner in the engine: it explores and
  writes JAX's CSV log, bounded by rounds; and its protocol on a
  synthetic score (at least 3 distinct points, the freeze to the best).
"""

import json
import os
import socket
import threading
import time
import types

import pytest
import torch
import torch.multiprocessing as mp

JOB_TIMEOUT_S = 120


def _ns(port: bool):
    """One package's autotune names, flight recorder and arbiter."""
    if port:
        from horovod_tpu_torch import autotune as at
        from horovod_tpu_torch.observability import flight_recorder as fr
        from horovod_tpu_torch.ops.control_plane import WireEpochArbiter
    else:
        from horovod_tpu import autotune as at
        from horovod_tpu.observability import flight_recorder as fr
        from horovod_tpu.ops.control_plane import WireEpochArbiter
    ns = types.SimpleNamespace(**{k: getattr(at, k) for k in at.__all__
                                  if k != "ParameterManager"})
    ns.fr, ns.WireEpochArbiter = fr, WireEpochArbiter
    return ns


def _events(ns):
    return [e[2] for e in ns.fr.recorder()._snapshot() if e[1] == "autotune"]


def _both(case, *args):
    """The scenario's result through JAX and through the port, which
    must be equal."""
    want, got = case(_ns(False), *args), case(_ns(True), *args)
    assert got == want
    return got


def _raises(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


# --------------------------------------------------------------------------
# Knob space
# --------------------------------------------------------------------------

def _knob_fields(k):
    return (k.name, k.kind, k.domain, k.default, k.safety, k.apply_via,
            k.description)


def case_stock_registry(ns):
    reg = ns.default_registry()
    return ([_knob_fields(k) for k in reg], reg.defaults(),
            [k.name for k in reg.continuous()],
            [k.name for k in reg.discrete()])


def case_include_filters(ns):
    reg = ns.default_registry(include=("fusion_threshold_mb",))
    return reg.names(), "dcn_wire_spec" in reg, len(reg)


def case_validation(ns):
    K = ns.Knob
    return [_raises(K, "k", "fuzzy", (1, 2), 1, "live", "engine_param"),
            _raises(K, "k", "discrete", (1, 2), 1, "yolo", "engine_param"),
            _raises(K, "k", "discrete", (1, 2), 1, "live", "side_door"),
            _raises(K, "k", "continuous", (5.0, 1.0), 2.0, "live",
                    "engine_param"),
            _raises(K, "k", "discrete", (), 1, "live", "engine_param"),
            _raises(K, "k", "discrete", (1, 2), 3, "live", "engine_param")]


def case_clamp(ns):
    cont = ns.Knob("c", "continuous", (1.0, 10.0), 5.0, "live",
                   "engine_param")
    disc = ns.Knob("d", "discrete", (8, 16), 8, "live", "engine_param")
    return ([cont.clamp(v) for v in (0.0, 99.0, 3.5)], disc.clamp(16),
            _raises(disc.clamp, 12))


def case_duplicate_registration(ns):
    reg = ns.KnobRegistry()
    k = ns.Knob("d", "discrete", (8, 16), 8, "live", "engine_param")
    reg.register(k)
    return _raises(reg.register, k)


# --------------------------------------------------------------------------
# Search
# --------------------------------------------------------------------------

def case_enumerate_order(ns):
    a = ns.Knob("a", "discrete", (1, 2), 1, "live", "engine_param")
    b = ns.Knob("b", "discrete", ("x", "y"), "x", "live", "engine_param")
    return ns.enumerate_configs([a, b])


def case_enumerate_constraint(ns):
    a = ns.Knob("a", "discrete", (1, 2, 3), 1, "live", "engine_param")
    return ns.enumerate_configs([a], constraint=lambda c: c["a"] != 2)


def case_halving_rungs(ns):
    cands = [{"x": i} for i in range(16)]
    best, trials = ns.successive_halving(
        cands, lambda cfg, budget: float(cfg["x"]), eta=2, base_budget=2)
    return (best, [(t.config, t.rung, t.budget, t.score) for t in trials],
            [ns.rungs_for(n) for n in (1, 2, 5, 16, 17)])


def case_halving_ties(ns):
    return ns.successive_halving([{"x": i} for i in range(4)],
                                 lambda cfg, budget: 1.0)[0]


def case_halving_bad_inputs(ns):
    return (_raises(ns.successive_halving, [], lambda c, b: 0.0),
            _raises(ns.successive_halving, [{"x": 1}], lambda c, b: 0.0,
                    eta=1))


# --------------------------------------------------------------------------
# GP + legacy-log seeding
# --------------------------------------------------------------------------

def case_gp_interpolates(ns):
    gp = ns.GaussianProcess([(0.0, 100.0)])
    gp.observe([50.0], -1.0)
    return gp.predict([50.0]), gp.predict([10.0])


def case_gp_suggestions(ns):
    """The same observations give the same posterior and suggestions."""
    gp = ns.GaussianProcess([(1.0, 100.0), (0.0, 64.0)])
    out = []
    for x, y in [((10.0, 64.0), -2.0), ((90.0, 8.0), -1.0),
                 ((40.0, 32.0), -1.5), ((70.0, 16.0), -0.9)]:
        gp.observe(list(x), y)
        out.append((gp.suggest(), gp.suggest(n_grid=8),
                    gp.predict([55.0, 20.0]),
                    gp.expected_improvement([55.0, 20.0])))
    return out


def case_gp_empty_ei(ns):
    return ns.GaussianProcess([(0.0, 1.0)]).expected_improvement([0.5])


def case_legacy_log_seeds(ns, tmp_path):
    log = tmp_path / "autotune.csv"
    log.write_text("fusion_mb,cycle_ms,hier_allreduce,hier_allgather,score\n"
                   "64,10.0,1,0,-0.5\ngarbage,row\n32,20.0,0,1,-0.8\n")
    gp = ns.GaussianProcess([(1.0, 100.0)])
    return (ns.seed_points_from_legacy_log(str(log)),
            ns.seed_gp_for_cycle_time(gp, str(log)), len(gp), gp.suggest())


def case_legacy_log_cold_start(ns, tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("time,loss\n1,2\n")
    return (ns.seed_points_from_legacy_log(str(tmp_path / "nope.csv")),
            ns.seed_points_from_legacy_log(str(bad)))


# --------------------------------------------------------------------------
# Apply plane
# --------------------------------------------------------------------------

def case_plane_refusals(ns):
    reg = ns.default_registry()
    plane = ns.ApplyPlane(rebuild=lambda cfg: None,
                          set_engine_param=lambda n, v: None)
    return (plane.supports(reg.get("pipeline_schedule")),
            plane.supports(reg.get("spec_tokens")),
            _raises(plane.apply, reg.get("pipeline_schedule"), "zb-h1"),
            _raises(plane.apply, reg.get("spec_tokens"), 2))


def case_plane_missing_hook(ns):
    reg = ns.default_registry()
    plane = ns.ApplyPlane()
    return (plane.supports(reg.get("dcn_wire_spec")),
            _raises(plane.apply, reg.get("dcn_wire_spec"), "bf16"))


def case_plane_routes(ns):
    reg = ns.default_registry()
    calls = []
    plane = ns.ApplyPlane(
        set_wire=lambda v: calls.append(("wire", v)),
        set_fusion=lambda v: calls.append(("fusion", v)),
        set_bucket_mb=lambda v: calls.append(("bucket", v)),
        set_engine_param=lambda n, v: calls.append(("engine", n, v)))
    plane.apply(reg.get("dcn_wire_spec"), "bf16")
    plane.apply(reg.get("fusion_threshold_mb"), 32)
    plane.apply(reg.get("torch_bucket_mb"), 16)
    plane.apply(reg.get("cycle_time_ms"), 5.0)
    return calls


# --------------------------------------------------------------------------
# The guarded online driver
# --------------------------------------------------------------------------

def _tuner(ns, measurements, **kw):
    applied = []
    it = iter(measurements)
    ticks = iter(range(10_000))
    kw.setdefault("registry", ns.default_registry(
        include=("fusion_threshold_mb",)))
    t = ns.AutoTuner(plane=ns.ApplyPlane(set_fusion=applied.append),
                     measure=lambda budget: next(it),
                     clock=lambda: float(next(ticks)), **kw)
    return t, applied


def _move(m):
    return (m.knob, m.old, m.new, m.baseline_s, m.after_s, m.outcome,
            m.detail)


@pytest.mark.parametrize("table", [[1.0, 0.80], [1.0, 0.999], [1.0, 2.0],
                                   [None, None], [1.0, 1.05, 1.0, 0.5]],
                         ids=["win_kept", "no_gain_reverted",
                              "regression_rolled_back", "blind_reverted",
                              "two_moves"])
def test_try_move_verdicts_match_jax(table):
    def case(ns):
        t, applied = _tuner(ns, table)
        n0 = len(_events(ns))
        moves = [_move(t.try_move("fusion_threshold_mb", v))
                 for v in (32, 16)[:len(table) // 2]]
        events = [e for e in _events(ns)[n0:]
                  if e[1] == "fusion_threshold_mb"]
        return (moves, applied, dict(t.current),
                [(e[0], e[2], e[3], e[4], e[5]) for e in events])
    _both(case)


def case_run_sweeps_domain(ns):
    t, applied = _tuner(ns, [1.0] * 100)
    moves = t.run()
    return [_move(m) for m in moves], applied, _events(ns)[-1][0]


def case_run_skips_unsupported(ns):
    it = iter([1.0] * 100)
    return ns.AutoTuner(plane=ns.ApplyPlane(),
                        measure=lambda b: next(it)).run()


def case_run_continuous(ns):
    applied = []
    it = iter([1.0] * 10)
    t = ns.AutoTuner(registry=ns.default_registry(include=("cycle_time_ms",)),
                     plane=ns.ApplyPlane(
                         set_engine_param=lambda n, v: applied.append((n, v))),
                     measure=lambda b: next(it))
    moves = t.run()
    return [_move(m)[:3] + (m.outcome,) for m in moves], applied, len(t._gp)


def case_seed_log_warm_start(ns, tmp_path):
    log = tmp_path / "legacy.csv"
    log.write_text("fusion_mb,cycle_ms,hier_allreduce,hier_allgather,score\n"
                   "64,10.0,1,0,-0.5\n64,40.0,1,0,-0.9\n")
    t = ns.AutoTuner(registry=ns.default_registry(include=("cycle_time_ms",)),
                     seed_log=str(log))
    return len(t._gp), t._gp.suggest()


def case_tune_rebuild(ns):
    t = ns.AutoTuner(registry=ns.default_registry(
        include=("pipeline_schedule", "num_microbatches")))

    def score(cfg, budget):
        base = 1.0 if cfg["pipeline_schedule"] == "zb-h1" else 0.0
        return base + cfg["num_microbatches"] / 100.0

    best, trials = t.tune_rebuild(
        score, constraint=lambda c: c["num_microbatches"] >= 8)
    events = _events(ns)
    return (best, dict(t.current),
            [(x.config, x.rung, x.budget, x.score) for x in trials],
            events[-1][0], any(p[0] == "trial" for p in events))


# --------------------------------------------------------------------------
# Windowed step time over the history plane
# --------------------------------------------------------------------------

def _write_history(directory, rank, values):
    path = os.path.join(directory, f"history-rank{rank}.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"history": 1, "label": f"rank{rank}",
                            "rank": rank, "world": 2}) + "\n")
        for i, v in enumerate(values):
            f.write(json.dumps({
                "t_us": (i + 1) * 1_000_000,
                "s": {'hvdtpu_step_seconds{framework="torch"}|mean': v,
                      'hvdtpu_allreduce_seconds|mean': 99.0}}) + "\n")
    return path


def case_windowed_means(ns, tmp_path):
    _write_history(str(tmp_path), 0, [9.0, 1.0, 2.0])
    _write_history(str(tmp_path), 1, [9.0, 3.0, 4.0])
    return (ns.WindowedStepTime([str(tmp_path)], window=2).read(),
            ns.WindowedStepTime([str(tmp_path)]).read())


def case_windowed_missing(ns, tmp_path):
    return ns.WindowedStepTime([str(tmp_path / "none")]).read()


def case_windowed_foreign(ns, tmp_path):
    path = os.path.join(str(tmp_path), "history-rank0.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"history": 1, "rank": 0}) + "\n")
        f.write(json.dumps({"t_us": 1_000_000,
                            "s": {"hvdtpu_allreduce_seconds|mean": 1.0}})
                + "\n")
    return ns.WindowedStepTime([path]).read()


# --------------------------------------------------------------------------
# spec_tokens controller
# --------------------------------------------------------------------------

def case_spec_backoff(ns):
    c = ns.SpecTokensController(4)
    return c.slot_k(7), [c.observe(7, proposed=4, accepted=0)
                         for _ in range(4)]


def case_spec_raise(ns):
    c = ns.SpecTokensController(4)
    for _ in range(4):
        c.observe(0, 4, 0)
    return c.slot_k(0), [c.observe(0, 1, 1) for _ in range(6)]


def case_spec_probe(ns):
    c = ns.SpecTokensController(8, probe_every=16)
    for _ in range(8):
        c.observe(3, 8, 0)
    ks = [c.note_plain_step(3) for _ in range(16)]
    return ks, c._slots[3].ewma, c._slots[3].plain_steps


def case_spec_width(ns):
    c = ns.SpecTokensController(6)
    for _ in range(8):
        c.observe(0, 6, 0)
    out = (c.slot_k(0), c.slot_k(1), c.width([0, 1]), c.width([0]),
           c.width([]), [c.note_plain_step(1) for _ in range(3)])
    c.reset(1)
    return out + (1 in c._slots, _raises(ns.SpecTokensController, 0))


# --------------------------------------------------------------------------
# The wire-epoch arbiter
# --------------------------------------------------------------------------

def _arb(ns):
    seq = {"v": 0}
    return ns.WireEpochArbiter(threading.Lock(), lambda: seq["v"]), seq


def case_arbiter_noop(ns):
    arb, _ = _arb(ns)
    return (arb.propose_wire("tuner", ""), arb.propose_wire("tuner", "bf16"),
            arb.propose_wire("ladder", "bf16"))


def case_arbiter_tuner_vs_pending_ladder(ns):
    arb, _ = _arb(ns)
    return (arb.propose_wire("ladder", "bf16"),
            arb.propose_wire("tuner", "int8x256"), list(arb.wire_epochs))


def case_arbiter_ladder_replaces_tuner(ns):
    arb, _ = _arb(ns)
    return (arb.propose_wire("tuner", "bf16"),
            arb.propose_wire("ladder", "int8x256"), list(arb.wire_epochs),
            list(arb._wire_src))


def case_arbiter_same_source_restamps(ns):
    arb, _ = _arb(ns)
    arb.propose_wire("ladder", "bf16")
    return arb.propose_wire("ladder", "int8x256"), list(arb.wire_epochs)


def case_arbiter_planned_seq_frees(ns):
    arb, seq = _arb(ns)
    arb.propose_wire("ladder", "bf16")
    seq["v"] = 3
    return arb.propose_wire("tuner", "int8x256"), list(arb.wire_epochs)


def case_arbiter_fusion_independent(ns):
    arb, _ = _arb(ns)
    return (arb.propose_wire("ladder", "bf16"),
            arb.propose_fusion("tuner", 1 << 20), list(arb.fusion_epochs),
            arb.propose_fusion("ladder", 1 << 20))


CASES = [case_stock_registry, case_include_filters, case_validation,
         case_clamp, case_duplicate_registration, case_enumerate_order,
         case_enumerate_constraint, case_halving_rungs, case_halving_ties,
         case_halving_bad_inputs, case_gp_interpolates, case_gp_suggestions,
         case_gp_empty_ei, case_plane_refusals, case_plane_missing_hook,
         case_plane_routes, case_run_sweeps_domain,
         case_run_skips_unsupported, case_run_continuous, case_tune_rebuild,
         case_spec_backoff, case_spec_raise, case_spec_probe,
         case_spec_width, case_arbiter_noop,
         case_arbiter_tuner_vs_pending_ladder,
         case_arbiter_ladder_replaces_tuner,
         case_arbiter_same_source_restamps, case_arbiter_planned_seq_frees,
         case_arbiter_fusion_independent]
PATH_CASES = [case_legacy_log_seeds, case_legacy_log_cold_start,
              case_seed_log_warm_start, case_windowed_means,
              case_windowed_missing, case_windowed_foreign]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_matches_jax(case):
    _both(case)


@pytest.mark.parametrize("case", PATH_CASES, ids=lambda c: c.__name__[5:])
def test_matches_jax_on_files(case, tmp_path):
    _both(case, tmp_path)


def test_autotune_exports_jax_names():
    import horovod_tpu.autotune as jat
    import horovod_tpu_torch.autotune as tat
    assert set(jat.__all__) <= set(tat.__all__)


# --------------------------------------------------------------------------
# The coordinator's tuner moves over the engine's rounds
# --------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(worker, outdir, world=2):
    ctx = mp.spawn(worker, args=(_free_port(), str(outdir)), nprocs=world,
                   join=False)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=0.5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world}-rank job did not finish within "
                        f"{JOB_TIMEOUT_S} s")
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"))
            for r in range(world)]


def _init(rank, port):
    import horovod_tpu_torch as hvd
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=2)
    return hvd


def _arbitration_worker(rank, port, outdir):
    hvd = _init(rank, port)
    from horovod_tpu_torch.ops import collective as coll
    eng = coll.engine()
    out = {"verdicts": []}

    def plan_one(name):
        hvd.allreduce(torch.ones(4), average=False, name=name)
    if rank == 0:
        v = out["verdicts"]
        v.append(eng.tuner_move("fusion_threshold_mb", 0.0005))
        out["threshold"] = eng._coord.threshold(1 << 26)
        v.append(eng.tuner_move("dcn_wire_spec", "bf16"))
        # The ladder reacts in the same planning gap: it replaces the
        # tuner's pending epoch.
        v.append(eng._coord._arbiter.propose_wire("ladder", "int8x256"))
        v.append(eng.tuner_move("dcn_wire_spec", "fp8x256"))
        v.append(eng.tuner_move("dcn_wire_spec", "int8x256"))
        v.append(eng.tuner_move("warp_speed", 9))
    hvd.broadcast(torch.zeros(1), 0, name="sync.0")
    plan_one("t0")
    if rank == 0:
        out["verdicts"].append(eng.tuner_move("dcn_wire_spec", "bf16"))
        out["verdicts"].append(eng.tuner_move("cycle_time_ms", 7.5))
    hvd.broadcast(torch.zeros(1), 0, name="sync.1")
    plan_one("t1")
    out["wire_epochs"] = [list(e) for e in eng._wire_epochs]
    out["cycle_time_ms"] = eng.cycle_time_ms
    out["fusion_epochs"] = [list(e)
                            for e in eng._coord._arbiter.fusion_epochs]
    out["threshold_after"] = eng._coord.threshold(1 << 26)
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def test_coordinator_moves_arbitrate_against_the_ladder(tmp_path):
    """JAX's ``TestCoordinatorTunerMoves`` over the engine's rounds:
    rank 0's proposals ride its rounds and the verdicts come back with
    the plan; every rank's plan carries one arbitrated history."""
    ranks = _spawn(_arbitration_worker, tmp_path)
    v = ranks[0]["verdicts"]
    base = v[0]["from_seq"]
    assert v[0] == {"accepted": True, "from_seq": base, "reason": "ok"}
    assert ranks[0]["threshold"] == int(0.0005 * (1 << 20))
    assert v[1]["accepted"]
    assert v[2]["reason"] == "replaced_tuner"
    assert v[3] == {"accepted": False, "from_seq": base,
                    "reason": "conflict_with_ladder"}
    assert v[4]["reason"] == "noop"
    assert v[5] == {"accepted": False, "from_seq": -1,
                    "reason": "unknown_knob"}
    # Broadcast and t0 planned two groups: the tuner is free again at
    # the next epoch boundary.
    assert v[6] == {"accepted": True, "from_seq": base + 2, "reason": "ok"}
    assert v[7] == {"accepted": True, "from_seq": -1, "reason": "live"}
    # The fusion cap lives in rank 0's coordinator alone: only its
    # planner cuts groups.
    assert ranks[0]["fusion_epochs"] == [[base, 524]]
    assert ranks[0]["threshold_after"] == 524
    assert ranks[1]["fusion_epochs"] == []
    for out in ranks:
        assert out["wire_epochs"] == [[base, "int8x256"], [base + 2, "bf16"]]
        assert out["cycle_time_ms"] == 7.5


FLIP_STEPS, FLIP_AT, BURST = 12, 4, 3


def _flip_worker(rank, port, outdir):
    hvd = _init(rank, port)
    from horovod_tpu_torch.ops import collective as coll
    eng = coll.engine()
    out = {"results": [], "groups": []}
    for step in range(FLIP_STEPS):
        if step == FLIP_AT and rank == 0:
            # 512 bytes: less than one 100-float tensor, so every burst
            # after the flip must split into singleton groups.
            out["verdict"] = eng.tuner_move("fusion_threshold_mb",
                                            512 / (1 << 20))
        # Every rank submits the burst at once, so it plans in one round.
        hvd.broadcast(torch.zeros(1), 0, name=f"flip.sync.{step}")
        handles = [hvd.allreduce_async(
            torch.full((100,), float(rank + 1 + i + step)), average=False,
            name=f"flip.{step}.{i}") for i in range(BURST)]
        out["results"].append([float(hvd.synchronize(h)[0])
                               for h in handles])
        out["groups"].append([h.group for h in handles])
    out["threshold"] = eng._coord.threshold(1 << 26)
    out["epochs"] = [list(e) for e in eng._coord._arbiter.fusion_epochs]
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def test_mid_run_fusion_flip_lands_without_changing_results(tmp_path):
    """``test_autotune_mp.py``: the flip lands at one group seq on every
    rank and every result stays at its closed form."""
    ranks = _spawn(_flip_worker, tmp_path)
    v = ranks[0]["verdict"]
    assert v["accepted"] and v["reason"] == "ok" and v["from_seq"] >= 0
    # Rank 0's planner holds the cap and cuts every rank's groups with it.
    assert ranks[0]["threshold"] == 512
    assert ranks[0]["epochs"] == [[v["from_seq"], 512]]
    for out in ranks:
        for step, vals in enumerate(out["results"]):
            assert vals == [3.0 + 2 * (i + step) for i in range(BURST)]
        assert all([len(g) for g in gs] == [1] * BURST
                   for gs in out["groups"][FLIP_AT:])
    assert ranks[0]["results"] == ranks[1]["results"]
    assert ranks[0]["groups"] == ranks[1]["groups"]


# --------------------------------------------------------------------------
# The legacy HOROVOD_AUTOTUNE tuner
# --------------------------------------------------------------------------

HEADER = "fusion_mb,cycle_ms,hier_allreduce,hier_allgather,score"


def test_legacy_tuner_explores_and_logs(tmp_path, monkeypatch):
    """``test_autotune.py``'s non-slow case in the port's engine, bounded
    by rounds: HOROVOD_AUTOTUNE=1 explores (fusion MB, cycle ms) points,
    logs JAX's CSV and the plan carries the point; results stay right."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collective as coll
    log = tmp_path / "autotune.csv"
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(log))
    monkeypatch.setenv("HOROVOD_CYCLE_TIME", "1")
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        eng = coll.engine()
        pm = eng._coord._pm
        x = torch.ones(64, 64)
        i = 0
        while pm.steps < 2 and eng.rounds < 2000:
            out = hvd.allreduce(x, average=False, name=f"tune.{i}")
            assert torch.equal(out, x)
            i += 1
        params = {"autotune_active": eng.autotune_active,
                  "autotune_done": eng.autotune_done,
                  "cycle_time_ms": eng.cycle_time_ms}
    finally:
        hvd.shutdown()
    lines = log.read_text().strip().splitlines()
    assert lines[0] == HEADER
    assert len(lines) >= 3, lines
    for line in lines[1:]:
        parts = line.split(",")
        assert len(parts) == 5
        assert 0.0 <= float(parts[0]) <= 64.0
        assert 1.0 <= float(parts[1]) <= 100.0
    assert params["autotune_active"] and not params["autotune_done"]
    assert params["cycle_time_ms"] == pytest.approx(pm.cycle_ms)


def test_legacy_tuner_protocol(tmp_path):
    """JAX's constants (10 cycles a sample, 3 warm-up samples, 5 a step,
    30 steps), >= 3 distinct points, both flags explored, the freeze to
    the best-scoring point, on a synthetic score."""
    from horovod_tpu_torch.autotune import ParameterManager
    log = tmp_path / "pm.csv"
    pm = ParameterManager(64.0, 5.0, str(log))
    changes = 0
    cycles = 0
    while not pm.done:
        # Bytes a cycle peak at 24 MB fusion and 10 ms cycles.
        score = 100.0 - abs(pm.fusion_mb - 24.0) - abs(pm.cycle_ms - 10.0)
        changes += pm.update(int(score * 1e6 * 1e-3), 1e-3)
        cycles += 1
    assert cycles == (3 + 30 * 5) * 10 and changes == 30
    lines = log.read_text().strip().splitlines()
    assert lines[0] == HEADER and len(lines) == 31
    rows = [tuple(float(v) for v in ln.split(",")) for ln in lines[1:]]
    assert len({(r[0], r[1]) for r in rows}) >= 3
    assert any(r[2] == 1.0 for r in rows) and any(r[3] == 1.0 for r in rows)
    best = max(rows, key=lambda r: r[4])
    assert abs(pm.fusion_mb - best[0]) <= 6e-4
    assert abs(pm.cycle_ms - best[1]) <= 6e-4
    assert pm.params()["autotune_done"] and pm.update(1, 1.0) is False


# --------------------------------------------------------------------------
# The switches and defaults from the environment
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tpu,legacy,armed", [
    (None, None, False), ("1", None, True), (None, "1", True),
    ("0", "1", False), ("1", "0", True)])
def test_engine_tuner_switch_reads_as_jax_core(monkeypatch, tpu, legacy,
                                               armed):
    """Rank 0's coordinator arms the legacy tuner as JAX's core does:
    ``EnvOr("HOROVOD_TPU_AUTOTUNE", "HOROVOD_AUTOTUNE")``."""
    from horovod_tpu_torch.ops.control_plane import Coordinator
    for name, v in (("HOROVOD_TPU_AUTOTUNE", tpu),
                    ("HOROVOD_AUTOTUNE", legacy)):
        if v is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, v)
    monkeypatch.delenv("HOROVOD_AUTOTUNE_LOG", raising=False)
    monkeypatch.delenv("HOROVOD_TPU_AUTOTUNE_LOG", raising=False)
    coord = Coordinator(1)
    assert (coord._pm is not None) is armed
    assert Coordinator(1, primary=False)._pm is None


def test_legacy_tuner_owns_fusion_and_cycle(monkeypatch):
    """While the legacy tuner is armed, the global tuner's fusion and
    cycle moves are rejected, and the planner cuts with the legacy
    point; a wire move still goes through the arbiter."""
    from horovod_tpu_torch.ops.control_plane import Coordinator
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.delenv("HOROVOD_TPU_AUTOTUNE", raising=False)
    monkeypatch.delenv("HOROVOD_AUTOTUNE_LOG", raising=False)
    monkeypatch.delenv("HOROVOD_TPU_AUTOTUNE_LOG", raising=False)
    coord = Coordinator(1)
    refused = {"accepted": False, "from_seq": -1,
               "reason": "legacy_tuner_active"}
    assert coord.tuner_move("fusion_threshold_mb", 16) == refused
    assert coord.tuner_move("cycle_time_ms", 7.5) == refused
    assert coord.tuner_move("dcn_wire_spec", "bf16")["accepted"]
    assert coord._arbiter.fusion_epochs == []
    assert coord.threshold(1 << 26) == coord._pm.fusion_bytes
    p = coord.params()
    assert p["cycle_time_ms"] == coord._pm.cycle_ms
    assert set(p) == {"wire_epochs", "cycle_time_ms", "autotune_active",
                      "autotune_done"}


@pytest.mark.parametrize("env,kw,want", [
    ({}, {}, (0.10, 2)),
    ({"HOROVOD_TPU_AUTOTUNE_GUARD_REL": "0.25",
      "HOROVOD_TPU_AUTOTUNE_TRIAL_BUDGET": "3"}, {}, (0.25, 3)),
    ({"HOROVOD_AUTOTUNE_GUARD_REL": "0.3",
      "HOROVOD_AUTOTUNE_TRIAL_BUDGET": "4"}, {}, (0.3, 4)),
    ({"HOROVOD_TPU_AUTOTUNE_GUARD_REL": "0.25",
      "HOROVOD_TPU_AUTOTUNE_TRIAL_BUDGET": "3"},
     {"guard_rel": 0.05, "trial_budget": 1}, (0.05, 1))])
def test_tuner_defaults_from_env(monkeypatch, env, kw, want):
    """``AutoTuner``'s guard and budget default to the environment's
    (JAX's defaults when unset); explicit arguments win. The budget is
    what each window is measured with, the guard what rolls back."""
    import horovod_tpu.autotune as jat
    from horovod_tpu_torch.autotune import (ApplyPlane, AutoTuner,
                                            default_registry)
    for name in ("GUARD_REL", "TRIAL_BUDGET"):
        for pre in ("HOROVOD_TPU_AUTOTUNE_", "HOROVOD_AUTOTUNE_"):
            monkeypatch.delenv(pre + name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert (jat.AutoTuner().guard_rel, jat.AutoTuner().trial_budget) \
        == (0.10, 2)
    state = {"mb": 64}
    budgets = []
    # 16 MB is 12% worse than 64 (under the step-time detector's 15%):
    # rolled back under a guard below 0.12, reverted above it.
    meas = {16: 1.12, 32: 1.0, 64: 1.0, 128: 1.0}

    def measure(budget):
        budgets.append(budget)
        return meas[state["mb"]]
    tuner = AutoTuner(registry=default_registry(
        include=("fusion_threshold_mb",)),
        plane=ApplyPlane(set_fusion=lambda mb: state.update(mb=mb)),
        measure=measure, **kw)
    assert (tuner.guard_rel, tuner.trial_budget) == want
    moves = tuner.run()
    assert set(budgets) == {want[1]}
    first = moves[0]
    assert first.new == 16
    assert first.outcome == ("rolled_back" if want[0] < 0.12
                             else "reverted")
