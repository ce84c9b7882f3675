"""The engine's remainder against the JAX package: the stall inspector,
the Python timeline, ``pmean`` and ``mpi_threads_supported``.

- The stall report (the ports of ``tests/test_ops.py``'s
  ``TestStallWarning`` and ``tests/test_control_plane.py``'s stall
  cases): at one rank a request stuck 120 s is named with its op, its
  age and JAX's "no rank is missing" diagnosis; on a 2-rank gloo job a
  name only rank 1 submitted is reported on rank 1 with rank 0 named
  missing, from rank 0's coordinator; the coordinator's ``stalled``
  table.
- The timeline (the cases of ``tests/test_timeline.py`` not about the
  jit path): the engine's trace is valid catapult JSON with the same
  events and phases as the JAX engine's for the same ops (its ``XLA_``
  activities are the port's ``GLOO_`` ones here), cycle markers are
  global instants, the writer flushes at exit without ``close`` and a
  killed writer leaves a valid prefix, ``{rank}`` resolves per rank,
  and a per-rank trace carries its clock header, sidecar and group
  ids; on the 2-rank job each rank writes its own file, rank 1's clock
  synced to rank 0's.
- ``pmean`` over a gloo mesh, and ``mpi_threads_supported``.
"""

import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import horovod_tpu_torch as thvd
from horovod_tpu_torch.ops import collective as tcoll
from horovod_tpu_torch.ops import control_plane as tcp
from horovod_tpu_torch.ops.timeline_py import PyTimeline
from horovod_tpu_torch.utils import env as tenv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT_S = 120


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def text(self):
        return "\n".join(r.getMessage() for r in self.records)


# -------------------------------------------------------------------- stalls


@pytest.fixture
def world_one():
    thvd.shutdown()
    thvd.init(device="cpu")
    yield tcoll.engine()
    thvd.shutdown()


def test_stall_report_names_op_age_and_diagnosis(world_one):
    eng = world_one
    req = tcoll._Request(tcp.Meta("stall.probe", tcp.ALLREDUCE, "float32",
                                  (3,)),
                         torch.ones(3), tcoll.Handle("stall.probe", eng._cv),
                         None)
    req.enqueued_at = time.monotonic() - 120.0
    cap = _Capture()
    log = logging.getLogger("horovod_tpu_torch.ops.collective")
    log.addHandler(cap)
    old = eng.stall_warning_s
    try:
        with eng._lock:
            eng._announced["stall.probe"] = req
        eng.stall_warning_s = 0.01
        eng._last_stall_check = 0.0
        eng._maybe_check_stalls()
    finally:
        log.removeHandler(cap)
        with eng._lock:
            eng._announced.pop("stall.probe", None)
        eng.stall_warning_s = old
    text = cap.text()
    assert "stall.probe" in text
    assert "allreduce" in text
    assert "waiting 120s" in text
    assert "no rank is missing" in text


def test_stall_warning_env(monkeypatch):
    monkeypatch.delenv("HOROVOD_TPU_STALL_WARNING", raising=False)
    monkeypatch.delenv("HOROVOD_STALL_WARNING", raising=False)
    monkeypatch.delenv("HOROVOD_STALL_CHECK_DISABLE", raising=False)
    assert tenv.stall_warning_secs() == 60
    monkeypatch.setenv("HOROVOD_STALL_WARNING", "1.5")
    assert tenv.stall_warning_secs() == 1.5
    monkeypatch.setenv("HOROVOD_STALL_CHECK_DISABLE", "1")
    assert tenv.stall_warning_secs() == 0.0


def _round(coord, announcements, threshold):
    """One round: ``announcements[r]`` is rank r's new requests; returns
    the groups planned, in order."""
    for rank, metas in enumerate(announcements):
        coord.announce(rank, metas)
    return coord.plan(threshold)


def test_coordinator_names_the_ranks_not_heard_from():
    coord = tcp.Coordinator(3)
    meta = tcp.Meta("stuck", tcp.ALLREDUCE, "float32", (2,))
    assert _round(coord, [[meta], [], [meta]], 1 << 20) == []
    assert coord.stalled(3600.0) == {}
    assert coord.stalled(0.0) == {"stuck": [1]}
    groups = _round(coord, [[], [meta], []], 1 << 20)
    assert [g.names for g in groups] == [["stuck"]]
    assert coord.stalled(0.0) == {}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, port, outdir):
    os.environ["HOROVOD_TPU_STALL_WARNING"] = "0.3"
    os.environ["HOROVOD_TPU_TIMELINE"] = os.path.join(outdir,
                                                      "t.{rank}.json")
    from horovod_tpu_torch.parallel import create_mesh, pmean
    torch.set_num_threads(1)
    cap = _Capture()
    logging.getLogger("horovod_tpu_torch.ops.collective").addHandler(cap)
    thvd.init(device="cpu", init_method=f"tcp://localhost:{port}",
              rank=rank, world_size=2)
    out = {}
    mesh = create_mesh(dp=2)
    x = torch.from_numpy(np.random.RandomState(rank).standard_normal(
        9).astype(np.float32))
    out["pmean"] = pmean(x, mesh, "dp")
    out["pmean_int"] = pmean(torch.arange(5, dtype=torch.int32) * (rank + 1),
                             mesh, "dp")
    thvd.allreduce(torch.ones(4), name="tl.sum")
    if rank == 1:
        h = thvd.allreduce_async(torch.ones(3), name="stuck")
    time.sleep(1.0)
    if rank == 0:
        h = thvd.allreduce_async(torch.ones(3), name="stuck")
    out["stuck"] = h.wait()
    thvd.shutdown()
    out["log"] = cap.text()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("remainder")
    ctx = mp.spawn(_worker, args=(_free_port(), str(d)), nprocs=2,
                   join=False)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the 2-rank job did not finish within "
                        f"{JOB_TIMEOUT_S} s")
    return d, [torch.load(d / f"rank{r}.pt") for r in range(2)]


def test_stall_report_names_missing_ranks_on_gloo(two_ranks):
    _, (r0, r1) = two_ranks
    assert "stuck [missing ranks: 0] [allreduce, waiting" in r1["log"]
    assert "stuck" not in r0["log"]
    for out in (r0, r1):
        assert out["stuck"].tolist() == [1.0] * 3


def test_every_rank_writes_its_timeline_with_a_synced_clock(two_ranks):
    d, _ = two_ranks
    for r in range(2):
        events = json.loads((d / f"t.{r}.json").read_text())
        names = {e.get("name") for e in events}
        assert {"NEGOTIATE_ALLREDUCE", "GLOO_ALLREDUCE"} <= names
        meta = [e for e in events if e.get("name") == "horovod_tpu_trace_meta"]
        assert meta[-1]["args"]["rank"] == r
        assert meta[-1]["args"]["clock_synced"] is True
        side = json.loads((d / f"t.{r}.json.clock.json").read_text())
        assert side["rank"] == r and side["clock_synced"] is True
        assert side["world"] == 2


def test_pmean_matches_jax(two_ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    _, ranks = two_ranks
    xs = np.stack([np.random.RandomState(r).standard_normal(9).astype(
        np.float32) for r in range(2)])
    ints = np.stack([np.arange(5, dtype=np.int32) * (r + 1)
                     for r in range(2)])
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    fn = jax.jit(jax.shard_map(lambda x, i: (jax.lax.pmean(x, "dp"),
                                             jax.lax.pmean(i, "dp")),
                               mesh=mesh, in_specs=(P("dp"), P("dp")),
                               out_specs=(P(), P()), check_vma=False))
    want, want_int = fn(jnp.asarray(xs).reshape(-1),
                        jnp.asarray(ints).reshape(-1))
    for out in ranks:
        np.testing.assert_array_equal(out["pmean"].numpy(),
                                      np.asarray(want))
        assert out["pmean_int"].dtype == torch.float32
        np.testing.assert_array_equal(out["pmean_int"].numpy(),
                                      np.asarray(want_int))


def test_mpi_threads_supported():
    thvd.shutdown()
    with pytest.raises(thvd.NotInitializedError):
        thvd.mpi_threads_supported()
    thvd.init(device="cpu")
    try:
        assert thvd.mpi_threads_supported() is True
    finally:
        thvd.shutdown()


# ------------------------------------------------------------------ timeline

OPS = ("hvd.allreduce({mod}((16, 16)), name='tl.allreduce')\n"
       "hvd.allgather({mod}((4, 4)), name='tl.allgather')\n"
       "hvd.broadcast({mod}((4,)), 0, name='tl.broadcast')\n")


def _run(script, env, timeout=240):
    full = dict(os.environ)
    full.update(env)
    full["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", script], env=full,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-2000:]


def _phases(path, prefix):
    """{(tensor, event name with the activity prefix mapped, phase)}."""
    events = json.loads(open(path).read())
    pids = {e["pid"]: e["args"]["name"] for e in events
            if e.get("name") == "process_name"}
    out = set()
    for e in events:
        name = e.get("name")
        if e.get("ph") == "M" or name is None:
            continue
        if name.startswith(prefix):
            name = "ACT_" + name[len(prefix):]
        out.add((pids.get(e["pid"]), name, e["ph"]))
    return out


def test_engine_timeline_has_jax_events_and_phases(tmp_path):
    mine, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    _run("import torch, horovod_tpu_torch as hvd\n"
         "hvd.init(device='cpu')\n" + OPS.format(mod="torch.ones")
         + "hvd.shutdown()\n",
         {"HOROVOD_TPU_TIMELINE": str(mine),
          "HOROVOD_TPU_TIMELINE_MARK_CYCLES": "1"})
    _run("import jax; jax.config.update('jax_platforms', 'cpu')\n"
         "import jax.numpy as jnp\n"
         "import horovod_tpu as hvd\n"
         "from horovod_tpu.ops import collective\n"
         "hvd.init()\n" + OPS.format(mod="jnp.ones")
         + "collective.engine().shutdown()\n",
         {"HOROVOD_TPU_TIMELINE": str(theirs), "JAX_PLATFORMS": "cpu",
          "HOROVOD_TPU_TIMELINE_MARK_CYCLES": "1",
          "HOROVOD_TPU_DISABLE_NATIVE": "1",
          "XLA_FLAGS": "--xla_force_host_platform_device_count=1"})
    got, want = _phases(mine, "GLOO_"), _phases(theirs, "XLA_")
    ops = {e for e in want if e[0] and e[0].startswith("tl.")}
    assert ops and ops == {e for e in got if e[0] and e[0].startswith("tl.")}
    assert ("_cycles", "CYCLE_START", "i") in got & want
    text = mine.read_text()
    assert "NEGOTIATE_ALLREDUCE" in text and "GLOO_ALLREDUCE" in text


def test_mark_cycle_emits_global_scope_instant(tmp_path):
    path = tmp_path / "cycles.json"
    tl = PyTimeline(str(path))
    tl.mark_cycle()
    tl.mark_cycle()
    tl.close()
    events = json.loads(path.read_text())
    cycles = [e for e in events
              if e.get("name") == "CYCLE_START" and e.get("ph") == "i"]
    assert len(cycles) == 2
    assert all(e.get("s") == "g" for e in cycles)
    assert any(e.get("ph") == "M"
               and e.get("args", {}).get("name") == "_cycles"
               for e in events)


def test_atexit_flushes_unclosed_writer(tmp_path):
    path = tmp_path / "atexit.json"
    _run("import sys\n"
         "from horovod_tpu_torch.ops.timeline_py import PyTimeline\n"
         f"tl = PyTimeline({str(path)!r})\n"
         "for i in range(200):\n"
         "    tl.negotiate_start(f'exit.t{i}', 'allreduce')\n"
         "    tl.negotiate_end(f'exit.t{i}', group=i)\n"
         "sys.exit(0)\n", {})
    events = json.loads(path.read_text())
    assert sum(e.get("ph") == "B" for e in events) == 200
    assert any(e.get("args", {}).get("group") == 199 for e in events)


def test_killed_writer_leaves_valid_prefix(tmp_path):
    from horovod_tpu.ops import timeline_jit
    path = tmp_path / "killed.json"
    script = ("import time\n"
              "from horovod_tpu_torch.ops.timeline_py import PyTimeline\n"
              f"tl = PyTimeline({str(path)!r})\n"
              "for i in range(500):\n"
              "    tl.negotiate_start(f'kill.t{i}', 'allreduce')\n"
              "    tl.negotiate_end(f'kill.t{i}', group=i)\n"
              "time.sleep(0.5)\n"
              "print('DRAINED', flush=True)\n"
              "time.sleep(60)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "DRAINED"
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    events = timeline_jit._load_timeline(str(path))
    assert len([e for e in events if e.get("ph") == "B"]) == 500


def test_placeholder_resolution(monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_TIMELINE", "/tmp/t.{rank}.json")
    assert tenv.resolved_timeline_path(0) == "/tmp/t.0.json"
    assert tenv.resolved_timeline_path(3) == "/tmp/t.3.json"
    monkeypatch.setenv("HOROVOD_TPU_TIMELINE", "/tmp/t.json")
    assert tenv.resolved_timeline_path(0) == "/tmp/t.json"
    assert tenv.resolved_timeline_path(1) is None


def test_single_process_placeholder_writes_rank0_with_meta(tmp_path):
    _run("import torch, horovod_tpu_torch as hvd\n"
         "hvd.init(device='cpu')\n"
         "hvd.allreduce(torch.ones(8), name='prk.allreduce')\n"
         "hvd.shutdown()\n",
         {"HOROVOD_TPU_TIMELINE": str(tmp_path / "t.{rank}.json")})
    events = json.loads((tmp_path / "t.0.json").read_text())
    meta = [e for e in events if e.get("name") == "horovod_tpu_trace_meta"]
    args = meta[-1]["args"]
    assert args["rank"] == 0 and args["clock_synced"] is True
    assert args["start_mono_us"] > 0
    sidecar = json.loads((tmp_path / "t.0.json.clock.json").read_text())
    assert sidecar["rank"] == 0
    assert any("group" in (e.get("args") or {}) for e in events
               if e.get("ph") in ("E", "X"))
