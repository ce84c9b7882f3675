"""The port's elastic state and failure typing (``horovod_tpu_torch/
elastic``) against ``tests/test_elastic.py`` of the JAX package, and
the loader cursor's ride (``tests/test_data.py``'s two cursor cases).

- ``TestWorkerFailure``, ``TestFailureDetector``, ``TestElasticState``,
  ``TestElasticStateShardedBackend`` and ``TestEngineStallEscalation``
  ported case for case (every leaf is replicated here: the leaves
  sharded across ranks, ZeRO-1's and tp's, run on 4 gloo ranks in
  ``test_torch_checkpoint_mp.py``), and a corrupt commit's fallback;
  ``failure_from_event`` against JAX's.
- Modules and optimizers restored in place: an ``nn.Module`` and a
  ``DistributedOptimizer`` (AdamW) committed after 2 steps, a fresh
  pair (another seed, an optimizer that has not stepped) restored, and
  2 replayed steps bit for bit the uninterrupted run's, on both
  backends; the parameter objects stay the same.
- ``generation()`` from ``HOROVOD_TPU_ELASTIC_GENERATION``.
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import data
from horovod_tpu_torch.elastic import (ElasticState, FailureConfig,
                                       FailureDetector, SlowRankFailure,
                                       WorkerFailure, failure_from_event)


@pytest.fixture(scope="module", autouse=True)
def _port():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


class _FakeWorker:
    def __init__(self, rc=None):
        self.rc = rc

    def poll(self):
        return self.rc


class _FakeJob:
    def __init__(self, rcs):
        self.workers = [_FakeWorker(rc) for rc in rcs]
        self.terminated = False

    def terminate(self):
        self.terminated = True


class TestWorkerFailure:
    def test_typed_fields_and_pickle(self):
        wf = WorkerFailure(rank=3, host="gpu-w-3", kind="killed",
                           detail="exited with code -9")
        assert isinstance(wf, hvd.HorovodInternalError)
        wf2 = pickle.loads(pickle.dumps(wf))
        assert (wf2.rank, wf2.host, wf2.kind) == (3, "gpu-w-3", "killed")
        assert "gpu-w-3" in str(wf2)

    def test_backoff_schedule(self):
        cfg = FailureConfig(backoff_s=1.0, backoff_factor=2.0,
                            max_backoff_s=5.0)
        b = cfg.backoff_s
        seq = []
        for _ in range(4):
            b = cfg.next_backoff(b)
            seq.append(b)
        assert seq == [2.0, 4.0, 5.0, 5.0]

    @pytest.mark.parametrize("event", [
        {"rank": 1, "kind": "heartbeat_timeout", "detail": "silent 31s"},
        {"rank": 2, "kind": "slow_rank", "detail": "late"},
        {}])
    def test_failure_from_event_is_jax(self, event):
        from horovod_tpu.elastic import failure as jfailure
        got, want = failure_from_event(event), \
            jfailure.failure_from_event(event)
        assert type(got).__name__ == type(want).__name__
        assert (got.rank, got.host, got.kind, got.detail, str(got)) == \
            (want.rank, want.host, want.kind, want.detail, str(want))
        assert isinstance(failure_from_event({"kind": "slow_rank"}),
                          SlowRankFailure)


class TestFailureDetector:
    def test_detects_signal_death_as_killed(self):
        job = _FakeJob([None, -9])
        det = FailureDetector(job, ["hostA", "hostB"])
        with pytest.raises(WorkerFailure) as ei:
            det.check()
        assert ei.value.rank == 1
        assert ei.value.host == "hostB"
        assert ei.value.kind == "killed"
        assert job.terminated

    def test_nonzero_exit_is_exit_kind(self):
        det = FailureDetector(_FakeJob([2, None]), ["h0", "h1"])
        with pytest.raises(WorkerFailure) as ei:
            det.check()
        assert ei.value.kind == "exit"
        assert ei.value.rank == 0

    def test_healthy_job_passes(self):
        det = FailureDetector(_FakeJob([None, 0, None]), ["a", "b", "c"])
        det.check()
        assert det.failures == []
        done = iter([False, True])
        FailureDetector(_FakeJob([None]), ["a"],
                        FailureConfig(poll_interval_s=0.0)).wait(
            lambda: next(done), timeout=5)


class TestElasticState:
    def test_commit_rollback_in_memory(self):
        st = ElasticState(params={"w": torch.ones(3)})
        st.commit(5)
        st.params["w"].mul_(9)      # in place: the commit holds a copy
        st.params = {"w": torch.full((3,), 9.0)}
        assert st.step == 5
        st.rollback()
        assert torch.equal(st.params["w"], torch.ones(3))
        st.params["w"].add_(1)      # the rollback copy is not aliased
        st.rollback()
        assert torch.equal(st.params["w"], torch.ones(3))
        assert st.step == 5

    def test_commit_restore_roundtrip(self, tmp_path):
        d = str(tmp_path / "elastic")
        st = ElasticState(directory=d, params={"w": torch.arange(4.0)},
                          opt={"m": np.zeros(4)})
        st.commit(5)
        st.params = {"w": torch.arange(4.0) * 10}
        st.commit(10)

        fresh = ElasticState(directory=d, params={"w": torch.zeros(4)},
                             opt={"m": np.ones(4)})
        fresh.restore()
        assert fresh.step == 10
        assert torch.equal(fresh.params["w"], torch.arange(4.0) * 10)

        older = ElasticState(directory=d, params={"w": torch.zeros(4)},
                             opt={"m": np.ones(4)})
        older.restore(step=5)
        assert older.step == 5
        assert torch.equal(older.params["w"], torch.arange(4.0))
        np.testing.assert_array_equal(older.opt["m"], np.zeros(4))

    def test_restore_without_commit_keeps_initial(self, tmp_path):
        st = ElasticState(directory=str(tmp_path / "none"),
                          params={"w": torch.full((2,), 7.0)})
        st.restore()
        assert st.step == 0
        assert torch.equal(st.params["w"], torch.full((2,), 7.0))

    def test_latest_repointed_atomically(self, tmp_path):
        d = str(tmp_path / "e2")
        st = ElasticState(directory=d, params={"w": torch.zeros(1)})
        st.commit(3)
        with open(os.path.join(d, "LATEST")) as f:
            assert f.read().strip() == "3"
        assert os.path.exists(os.path.join(d, "3.pkl"))

    def test_requires_trees(self):
        with pytest.raises(ValueError, match="named tree"):
            ElasticState()

    def test_pickle_commits_are_garbage_collected(self, tmp_path):
        d = str(tmp_path / "gc")
        st = ElasticState(directory=d, keep_last=3,
                          params={"w": torch.ones(2)})
        for step in range(1, 9):
            st.commit(step)
        pkls = sorted(int(f[:-4]) for f in os.listdir(d)
                      if f.endswith(".pkl"))
        assert pkls == [6, 7, 8]
        with open(os.path.join(d, "LATEST")) as f:
            assert int(f.read().strip()) == 8
        older = ElasticState(directory=d, params={"w": torch.zeros(2)})
        older.restore(step=6)
        assert older.step == 6

    def test_keep_env_knob(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HOROVOD_TPU_CHECKPOINT_KEEP", "2")
        d = str(tmp_path / "gcenv")
        st = ElasticState(directory=d, params={"w": torch.ones(2)})
        for step in range(1, 6):
            st.commit(step)
        pkls = sorted(int(f[:-4]) for f in os.listdir(d)
                      if f.endswith(".pkl"))
        assert pkls == [4, 5]

    def test_unknown_backend_rejected(self):
        with pytest.raises(ValueError, match="backend"):
            ElasticState(backend="orbax", params={"w": torch.ones(1)})
        with pytest.raises(ValueError, match="shared filesystem"):
            ElasticState(backend="sharded", params={"w": torch.ones(1)})

    def test_elastic_dir_env(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HOROVOD_TPU_ELASTIC_DIR", str(tmp_path / "env"))
        st = ElasticState(params={"w": torch.ones(2)})
        st.commit(4)
        assert os.path.exists(tmp_path / "env" / "4.pkl")


class TestElasticStateShardedBackend:
    """backend='sharded': elastic commit/restore riding the checkpoint
    engine — async commits, manifest LATEST, engine retention,
    restore from the shared directory."""

    def _state(self, d, scale=1.0, **kw):
        return ElasticState(directory=d, backend="sharded",
                            params={"w": torch.arange(4.0) * scale},
                            opt={"m": torch.arange(32.0) * scale}, **kw)

    def test_commit_restore_roundtrip(self, tmp_path):
        d = str(tmp_path / "sharded")
        st = self._state(d)
        st.commit(5)
        st.params = {"w": torch.arange(4.0) * 10}
        st.commit(10, block=True)
        assert os.path.exists(os.path.join(d, "step-10", "manifest.json"))

        fresh = self._state(d, scale=0.0)
        fresh.restore()
        assert fresh.step == 10
        assert torch.equal(fresh.params["w"], torch.arange(4.0) * 10)
        assert torch.equal(fresh.opt["m"], torch.arange(32.0))

        older = self._state(d, scale=0.0)
        older.restore(step=5)
        assert older.step == 5
        assert torch.equal(older.params["w"], torch.arange(4.0))

    def test_async_commit_joined_by_next(self, tmp_path):
        d = str(tmp_path / "sharded2")
        st = self._state(d)
        st.commit(1)
        st.commit(2)
        st.wait()
        from horovod_tpu_torch.checkpoint import read_latest
        assert read_latest(d) == 2

    def test_rollback_and_restore_without_commit(self, tmp_path):
        st = self._state(str(tmp_path / "sharded3"))
        st.commit(3, block=True)
        st.params = {"w": torch.full((4,), 99.0)}
        st.rollback()
        assert torch.equal(st.params["w"], torch.arange(4.0))
        assert st.step == 3

        st2 = self._state(str(tmp_path / "sharded4"))
        st2.restore()
        assert st2.step == 0
        assert torch.equal(st2.params["w"], torch.arange(4.0))

    def test_engine_retention_applies(self, tmp_path):
        d = str(tmp_path / "sharded5")
        st = self._state(d, keep_last=2)
        for step in range(1, 6):
            st.commit(step)
        st.wait()
        from horovod_tpu_torch.checkpoint import list_steps
        assert list_steps(d) == [4, 5]

    def test_corrupt_commit_falls_back_and_adopts_its_step(self, tmp_path):
        d = str(tmp_path / "sharded6")
        st = self._state(d)
        st.commit(1, block=True)
        st.params = {"w": torch.arange(4.0) * 5}
        st.commit(2, block=True)
        shard = sorted(f for f in os.listdir(os.path.join(d, "step-2"))
                       if f.endswith(".npy"))[0]
        with open(os.path.join(d, "step-2", shard), "r+b") as f:
            f.seek(90)
            f.write(b"\xff\xfe")
        fresh = self._state(d, scale=0.0)
        fresh.restore()
        assert fresh.step == 1
        assert torch.equal(fresh.params["w"], torch.arange(4.0))
        from horovod_tpu_torch.checkpoint import CorruptShardError
        with pytest.raises(CorruptShardError):
            fresh.engine.restore(strict=True)


def _lm_pair(seed):
    """(model, DistributedOptimizer(AdamW)) on the CPU."""
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 3))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=0.05, weight_decay=0.01),
        named_parameters=model.named_parameters())
    return model, opt


def _steps(model, opt, n, seed0):
    losses = []
    for i in range(n):
        g = torch.Generator().manual_seed(seed0 + i)
        x = torch.randn(5, 6, generator=g)
        opt.zero_grad()
        loss = model(x).square().mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


@pytest.mark.parametrize("backend", ["pickle", "sharded"])
def test_module_and_optimizer_restore_in_place(tmp_path, backend):
    model, opt = _lm_pair(0)
    _steps(model, opt, 2, 0)
    st = ElasticState(directory=str(tmp_path), backend=backend, model=model,
                      optimizer=opt, extra={"lr_scale": 0.5})
    st.commit(2)
    want = _steps(model, opt, 2, 2)
    st.wait()
    want_params = {k: v.clone() for k, v in model.state_dict().items()}
    want_moments = {k: v.clone() for p in opt.state.values()
                    for k, v in p.items()}

    fresh, fopt = _lm_pair(1)
    ids = [id(p) for p in fresh.parameters()]
    assert not fopt.state      # an optimizer that has not stepped
    st2 = ElasticState(directory=str(tmp_path), backend=backend,
                       model=fresh, optimizer=fopt,
                       extra={"lr_scale": 1.0})
    st2.restore()
    assert st2.step == 2 and st2.extra["lr_scale"] == 0.5
    assert [id(p) for p in fresh.parameters()] == ids
    assert st2.model is fresh and st2.optimizer is fopt
    got = _steps(fresh, fopt, 2, 2)
    assert got == want
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want_params[k]), k
    got_moments = {k: v for p in fopt.state.values() for k, v in p.items()}
    assert got_moments.keys() == want_moments.keys()
    for p_state, q_state in zip(fopt.state.values(), opt.state.values()):
        for k in q_state:
            assert torch.equal(p_state[k], q_state[k]), k


def test_module_rollback_in_place():
    model, opt = _lm_pair(0)
    _steps(model, opt, 1, 0)
    st = ElasticState(model=model, optimizer=opt)
    st.commit(1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _steps(model, opt, 2, 1)
    st.rollback()
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    again = _steps(model, opt, 2, 1)
    st.rollback()
    assert _steps(model, opt, 2, 1) == again


@pytest.fixture
def stall_engine():
    """The port's engine with a 10 ms stall warning; its knobs restored
    after."""
    from horovod_tpu_torch.ops import collective as coll
    eng = coll.engine()
    saved = eng.stall_warning_s, eng.failure_timeout_s
    eng.stall_warning_s = 0.01
    eng._last_stall_check = time.monotonic() - 100
    yield coll, eng
    eng.stall_warning_s, eng.failure_timeout_s = saved


def _request(coll, eng, name):
    """A request announced to this rank's tables that no plan will
    ever run (rank 0 never heard of it)."""
    from horovod_tpu_torch.ops.control_plane import (ALLREDUCE, Meta,
                                                     dtype_name)
    t = torch.ones(4)
    h = coll.Handle(name, eng._cv)
    meta = Meta(name, ALLREDUCE, dtype_name(t.dtype), (4,))
    req = coll._Request(meta, t, h, None)
    req.enqueued_at = time.monotonic() - 10
    with eng._lock:
        eng._announced[name] = req
        eng._names.add(name)
    return h


class TestEngineStallEscalation:
    def test_overdue_request_fails_with_worker_failure(self, stall_engine):
        coll, eng = stall_engine
        eng.failure_timeout_s = 0.05
        h = _request(coll, eng, "stall.t")
        eng._maybe_check_stalls()
        assert h.poll()
        with pytest.raises(WorkerFailure, match="failure timeout") as ei:
            h.wait()
        assert ei.value.kind == "stall"
        assert "stall.t" not in eng._announced
        assert "stall.t" not in eng._names

    def test_disabled_timeout_keeps_warn_only(self, stall_engine, caplog):
        coll, eng = stall_engine
        eng.failure_timeout_s = 0.0       # the default
        h = _request(coll, eng, "warn.t")
        try:
            with caplog.at_level("WARNING"):
                eng._maybe_check_stalls()
            assert not h.poll()           # still pending, only warned
            assert "warn.t" in caplog.text
        finally:
            with eng._lock:
                eng._announced.pop("warn.t", None)
                eng._names.discard("warn.t")

    def test_env_knob(self, monkeypatch):
        from horovod_tpu_torch.utils import env
        assert env.failure_timeout_secs() == 0.0
        monkeypatch.setenv("HOROVOD_FAILURE_TIMEOUT", "12")
        assert env.failure_timeout_secs() == 12.0
        monkeypatch.setenv("HOROVOD_TPU_FAILURE_TIMEOUT", "3.5")
        assert env.failure_timeout_secs() == 3.5


def test_generation_from_env(monkeypatch):
    assert hvd.generation() == 0
    hvd.shutdown()
    monkeypatch.setenv("HOROVOD_TPU_ELASTIC_GENERATION", "3")
    try:
        hvd.init(device="cpu")
        assert hvd.generation() == 3
        from horovod_tpu_torch.elastic import generation
        assert generation() == 3
    finally:
        hvd.shutdown()
        monkeypatch.delenv("HOROVOD_TPU_ELASTIC_GENERATION")
        hvd.init(device="cpu")


# --------------------------------------------------------------------------
# tests/test_data.py: the cursor's rides
# --------------------------------------------------------------------------

def _loader(seed=5):
    src = data.synthetic("image", n=40, image_size=4, seed=0)
    return data.build_loader(src, batch_size=4, rank=0, world_size=1,
                             seed=seed)


def test_cursor_rides_elastic_state(tmp_path):
    ld = _loader()
    next(ld), next(ld)
    state = ElasticState(directory=str(tmp_path),
                         params={"w": torch.zeros(2)},
                         data=ld.commit_cursor())
    state.commit(2)
    fresh = ElasticState(directory=str(tmp_path),
                         params={"w": torch.ones(2)},
                         data=_loader().cursor())
    fresh.restore()
    resumed = _loader().restore(fresh.data)
    assert resumed.offset == 2 and resumed.epoch == 0


def test_cursor_rides_sharded_checkpoint_engine(tmp_path):
    ld = _loader()
    for _ in range(3):
        next(ld)
    st = ElasticState(directory=str(tmp_path), backend="sharded",
                      params={"w": torch.arange(4.0)},
                      data=ld.commit_cursor())
    st.commit(3, block=True)
    fresh = ElasticState(directory=str(tmp_path), backend="sharded",
                         params={"w": torch.zeros(4)},
                         data=_loader().cursor())
    fresh.restore()
    resumed = _loader().restore(fresh.data)
    assert resumed.offset == 3 and resumed.epoch == 0
    assert torch.equal(fresh.params["w"], torch.arange(4.0))


def test_prefetcher_commits_the_consumed_cursor():
    """Behind the prefetcher the loader runs ahead; its commit_cursor is
    the loader's as of the last batch the consumer took."""
    ld = _loader()
    it = data.prefetch_to_device(ld, device="cpu", depth=3)
    assert int(it.commit_cursor()["offset"]) == 0
    first = [next(it).ids for _ in range(2)]
    deadline = time.monotonic() + 5
    while int(ld.offset) < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert int(ld.offset) >= 5   # 2 consumed, 3 staged, 1 in hand
    cur = it.commit_cursor()
    it.close()
    assert int(cur["offset"]) == 2
    resumed = _loader().restore(cur)
    want = _loader()
    for ids in first:
        np.testing.assert_array_equal(next(want).ids, ids)
    np.testing.assert_array_equal(next(resumed).ids, next(want).ids)
    with pytest.raises(TypeError, match="cursor"):
        data.prefetch_to_device(iter([(np.zeros(2),)]),
                                device="cpu").commit_cursor()
