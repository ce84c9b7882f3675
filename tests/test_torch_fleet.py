"""The port's serving fleet as a whole, on the CPU: two ``--device
cpu`` replicas of ``python -m horovod_tpu_torch.serving`` on a tiny
fp32 checkpoint (committed by JAX's checkpoint engine) behind the
port's ``Router``, replica 1 set to crash mid-load by
``rank=1:replica_crash_at=N:gen=0``. Every request answers 200 with the
greedy tokens of the port's in-process engine and of JAX's
``InferenceEngine`` on the same checkpoint; replica 1 comes back at
generation 1; its gen-0 blackbox names it for JAX's postmortem; JAX's
``load_history`` reads the supervisor's history of each replica and of
the fleet; a drained replica restarts. JAX's ``Router`` over a port
replica serves the same tokens (the replica meets JAX's HTTP and
metrics contract), ``python -m
horovod_tpu_torch.serving --fleet 2`` routes a request and exits 0 on
SIGTERM, and a replica asked for CUDA without a card fails.

Every wait polls with a deadline; every socket, join and subprocess
wait has a timeout."""

import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu.checkpoint import CheckpointEngine as JaxCheckpointEngine
from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel.mesh import create_mesh as jax_mesh
from horovod_tpu.serving import InferenceEngine as JaxEngine
from horovod_tpu.serving import ServingConfig as JaxConfig
from horovod_tpu.serving import load_params as jax_load_params
from horovod_tpu.serving import serving_config as jax_serving_config
from horovod_tpu.serving import transformer_extra as jax_extra
from horovod_tpu.serving.fleet import ReplicaEndpoint as JaxEndpoint
from horovod_tpu.serving.router import Router as JaxRouter
from horovod_tpu.observability import history as jax_history
from horovod_tpu.serving.router import StaticBackends as JaxBackends
from horovod_tpu.tools import postmortem
from horovod_tpu_torch import metrics_snapshot
from horovod_tpu_torch.checkpoint import CheckpointEngine
from horovod_tpu_torch.models.transformer import Transformer
from horovod_tpu_torch.serving import (Fleet, InferenceEngine, Router,
                                       ServingConfig, config_from_manifest,
                                       load_params, serving_config)

ROOT = Path(__file__).resolve().parent.parent
MAX_NEW = 16
N_REQUESTS = 12
CRASH_TICK = 6
ENGINE = dict(block_size=4, kv_blocks=64, max_batch_slots=4,
              max_new_tokens=MAX_NEW)
REPLICA_ARGS = ["--device", "cpu", "--block-size", "4", "--kv-blocks",
                "64", "--slots", "4", "--max-new-tokens", str(MAX_NEW)]
TIMEOUT_S = 120


def _wait(pred, what, timeout_s=TIMEOUT_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _routing_port(proc, lines):
    """The router's port from the supervisor's ``[fleet] routing on
    :PORT`` line on stderr; fails as soon as the supervisor exits."""
    deadline = time.monotonic() + TIMEOUT_S
    while time.monotonic() < deadline:
        if proc.poll() is not None and lines.empty():
            raise AssertionError(f"the supervisor exited {proc.returncode}")
        try:
            line = lines.get(timeout=0.5)
        except queue.Empty:
            continue
        if "[fleet] routing on :" in line:
            return int(line.split("routing on :")[1].split()[0])
    raise AssertionError("the supervisor printed no routing line")


def _reap(proc):
    """Stop a supervisor started in its own session and every replica
    left in its process group (a killed supervisor orphans them)."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait(timeout=TIMEOUT_S)


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.request("POST", "/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if body.get("stream"):
            lines = [json.loads(ln) for ln in resp.read().splitlines()
                     if ln.strip()]
            done = lines[-1]
            return (resp.status if done.get("done") else 599,
                    {"tokens": [ln["t"] for ln in lines[1:-1]],
                     "status": done.get("status"),
                     "retries": done.get("retries")})
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny fp32 flagship-shaped checkpoint committed by JAX's engine
    (``tests/test_fleet_e2e.py``'s idiom), and the prompts."""
    d = str(tmp_path_factory.mktemp("fleet") / "ckpt")
    cfg = jtfm.TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                                 d_ff=64, max_seq=128, dtype=jnp.float32,
                                 remat=False)
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    JaxCheckpointEngine(d, process_count=1, barrier=lambda n: None).save(
        params, 1, block=True, extra=jax_extra(cfg))
    rs = np.random.RandomState(11)
    prompts = [[int(t) for t in rs.randint(0, 64, int(n))]
               for n in rs.randint(4, 16, N_REQUESTS)]
    return d, prompts


@pytest.fixture(scope="module")
def expected(ckpt):
    """Greedy tokens of the port's in-process engine on the checkpoint."""
    d, prompts = ckpt
    cfg = serving_config(config_from_manifest(
        CheckpointEngine(d).restore_manifest()))
    model = Transformer(cfg, params=load_params(d, cfg, device="cpu"),
                        device="cpu")
    eng = InferenceEngine(model, ServingConfig(**ENGINE), device="cpu")
    return [eng.generate(p) for p in prompts]


def test_port_engine_equals_jax_engine(ckpt, expected):
    d, prompts = ckpt
    mesh = jax_mesh(devices=jax.devices()[:1], tp=1)
    man = JaxCheckpointEngine(d).restore_manifest()
    from horovod_tpu.serving import config_from_manifest as jax_cfm
    scfg = jax_serving_config(jax_cfm(man), mesh)
    eng = JaxEngine(jax_load_params(d, scfg, mesh), scfg, mesh,
                    JaxConfig(**ENGINE))
    assert [eng.generate(p) for p in prompts] == expected
    assert all(len(t) == MAX_NEW for t in expected)


@pytest.fixture(scope="module")
def fleet_run(ckpt, tmp_path_factory):
    """The fleet under load with replica 1 crashing at decode tick
    CRASH_TICK of its first incarnation: results, the restarted
    replica's state, the router's failover counts, the blackbox
    directory. Leaves the fleet serving for the tests that follow."""
    d, prompts = ckpt
    bb = str(tmp_path_factory.mktemp("bb"))
    # One thread a replica, and probes that tolerate a loaded CPU's late
    # /healthz (the suite runs several files at once): a replica killed
    # for a slow probe would be a second restart.
    env = dict(os.environ, HOROVOD_TPU_BLACKBOX=bb, OMP_NUM_THREADS="1",
               HOROVOD_TPU_FAULT_SPEC=f"rank=1:replica_crash_at="
                                      f"{CRASH_TICK}:gen=0")
    before = metrics_snapshot().get("hvdtpu_fleet_failovers_total",
                                    {"values": {}})["values"]
    fleet = Fleet(2, ["--checkpoint-dir", d] + REPLICA_ARGS, env=env,
                  probe_interval_s=0.1, probe_failures=50)
    router = Router(fleet, port=0, host="127.0.0.1", scrape_interval_s=0.1)
    # The supervisor's history plane: one sampler per replica (scraped)
    # and one over its own fleet families, armed by fleet.start().
    hist = str(tmp_path_factory.mktemp("history"))
    saved = {k: os.environ.get(k) for k in ("HOROVOD_TPU_HISTORY",
                                            "HOROVOD_TPU_HISTORY_INTERVAL")}
    os.environ.update(HOROVOD_TPU_HISTORY=hist,
                      HOROVOD_TPU_HISTORY_INTERVAL="0.2")
    try:
        fleet.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        fleet.wait_ready(TIMEOUT_S)
        router.start()
        _wait(lambda: sum(v.ready and v.ok
                          for v in list(router._views.values())) == 2,
              "both replicas in rotation")

        def one(i):
            body = {"tokens": prompts[i], "max_new_tokens": MAX_NEW}
            if i % 2:
                body["stream"] = True
            return _post(router.port, body)

        with ThreadPoolExecutor(max_workers=8) as pool:
            results = list(pool.map(one, range(N_REQUESTS),
                                    timeout=TIMEOUT_S))
        rep1 = fleet.replicas[1]
        _wait(lambda: rep1.restarts >= 1 and rep1.up and rep1.ready.is_set(),
              "replica 1's restart")
        _wait(lambda: sum(v.ready and v.ok
                          for v in list(router._views.values())) == 2,
              "replica 1 back in rotation")
        after = metrics_snapshot()["hvdtpu_fleet_failovers_total"]["values"]
        failovers = {k: v - before.get(k, 0) for k, v in after.items()}
        yield dict(fleet=fleet, router=router, results=results, bb=bb,
                   failovers=failovers, generation=rep1.generation,
                   restarts=rep1.restarts, history=hist)
    finally:
        router.shutdown()
        fleet.stop(timeout_s=60)


def test_every_request_answers_with_the_engines_tokens(fleet_run, expected):
    for i, (status, body) in enumerate(fleet_run["results"]):
        assert status == 200, (i, status, body)
        assert body["tokens"] == expected[i], i


def test_the_crash_was_failed_over(fleet_run):
    assert sum(fleet_run["failovers"].values()) >= 1
    assert set(fleet_run["failovers"]) <= {'phase="prefill"',
                                          'phase="midstream"'}


def test_replica_1_restarts_at_generation_1(fleet_run, expected, ckpt):
    assert fleet_run["restarts"] == 1 and fleet_run["generation"] == 1
    # the restarted incarnation runs clean (gen=0 clause) and serves
    status, body = _post(fleet_run["router"].port,
                         {"tokens": ckpt[1][0], "max_new_tokens": MAX_NEW})
    assert status == 200 and body["tokens"] == expected[0]
    restarts = metrics_snapshot()["hvdtpu_fleet_replica_restarts_total"][
        "values"]
    assert restarts['replica="1",why="crash"'] >= 1


def test_gen0_blackbox_names_the_crashed_replica(fleet_run):
    gen0 = Path(fleet_run["bb"]) / "gen0"
    path = gen0 / "blackbox-rank1.jsonl"
    lines = [json.loads(x) for x in path.read_text().splitlines() if x]
    header, last = lines[0], lines[-1]
    assert header["reason"] == "fault_crash" and header["rank"] == 1
    assert header["generation"] == 0 and header["world"] == 0
    assert last["kind"] == "fault" and last["fault"] == "replica_crash"
    assert last["tick"] == CRASH_TICK
    report = postmortem.analyze([postmortem.load_dump(str(path))])
    assert report["died_first"]["rank"] == 1
    assert "serving replica crash" in report["died_first"]["phase"]
    assert report["per_rank"]["1"]["inflight_requests"]


def test_jax_router_over_a_port_replica(fleet_run, ckpt, expected):
    rep = fleet_run["fleet"].replicas[0]
    assert rep.metrics_port is not None
    router = JaxRouter(JaxBackends([JaxEndpoint(
        index=0, host="127.0.0.1", port=rep.port,
        metrics_port=rep.metrics_port)]), port=0, host="127.0.0.1",
        scrape_interval_s=0.1)
    router.start()
    try:
        view = router._views[0]
        assert view.ready and view.ok
        assert router._scrape_metrics(view)      # the serving gauges
        assert view.slots == 4 and view.block_size == 4
        status, body = _post(router.port, {"tokens": ckpt[1][3],
                                           "max_new_tokens": MAX_NEW})
        assert status == 200 and body["tokens"] == expected[3]
    finally:
        router.shutdown()


def test_fleet_history_read_by_jax(fleet_run):
    hist = Path(fleet_run["history"])

    def sampled():
        return all((hist / f"history-{label}.jsonl").exists() and len(
            (hist / f"history-{label}.jsonl").read_text().splitlines()) >= 3
            for label in ("replica0", "replica1", "fleet"))

    _wait(sampled, "two samples in every history file")
    files = {f.label: f for f in jax_history.load_history([str(hist)])}
    assert files["replica0"].meta["role"] == "serving_replica"
    assert files["fleet"].meta["role"] == "fleet_supervisor"
    keys = {k for smp in files["replica0"].samples for k in smp["s"]}
    assert "hvdtpu_serving_queue_depth" in keys
    assert any(k.startswith("hvdtpu_fleet_") for smp in files["fleet"].samples
               for k in smp["s"])


def test_drain_restarts_and_load_views(fleet_run):
    fleet = fleet_run["fleet"]
    views = fleet.load_views()
    assert len(views) == 2 and all(v["slots"] == 4 for v in views)
    rep0 = fleet.replicas[0]
    fleet.drain_replica(0)                 # SIGTERM: drains, exits 0
    _wait(lambda: rep0.restarts == 1 and rep0.up and rep0.ready.is_set(),
          "replica 0's restart after its drain")
    restarts = metrics_snapshot()["hvdtpu_fleet_replica_restarts_total"][
        "values"]
    assert restarts['replica="0",why="exit"'] >= 1
    assert rep0.generation == 1 and fleet.live_count() == 2


def test_fleet_cli_routes_and_drains(ckpt, expected):
    d, prompts = ckpt
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serving", "--fleet", "2",
         "--checkpoint-dir", d, "--port", "0", "--host", "127.0.0.1"]
        + REPLICA_ARGS, cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
        start_new_session=True)
    lines = queue.Queue()

    def pump():
        for line in proc.stderr:
            lines.put(line)

    threading.Thread(target=pump, daemon=True).start()
    try:
        port = _routing_port(proc, lines)
        status, body = _post(port, {"tokens": prompts[2],
                                    "max_new_tokens": MAX_NEW})
        assert status == 200 and body["tokens"] == expected[2]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=TIMEOUT_S) == 0
    finally:
        _reap(proc)


def test_replica_asked_for_cuda_without_a_card_fails(ckpt):
    """No quiet fallback: ``--device cuda`` (the default) on a machine
    without a card exits non-zero and never announces ready."""
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.serving",
         "--checkpoint-dir", ckpt[0], "--port", "0", "--host", "127.0.0.1"],
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_S,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and "ready on" not in proc.stdout
    assert "CUDA is not available" in proc.stderr
