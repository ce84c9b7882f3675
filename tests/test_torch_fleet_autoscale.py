"""The fleet's size on the CPU: ``Fleet.scale_to`` grows a port fleet by
a replica at a new index and shrinks it by draining the highest one,
which retires instead of restarting, and ``python -m
horovod_tpu_torch.serving --fleet 1 --autoscale-max 2`` grows to two
replicas under load through the QoS autoscaler and its
``HOROVOD_TPU_QOS_SCALE_*`` knobs, then drains and exits 0 on SIGTERM.

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
import types
from pathlib import Path

import pytest
import torch

from horovod_tpu_torch.checkpoint import checkpoint_hook
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.observability import flight_recorder as tfr
from horovod_tpu_torch.serving import Fleet, transformer_extra

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=128, dtype=torch.float32, remat=False)
REPLICA_ARGS = ["--framework", "torch", "--device", "cpu", "--block-size",
                "4", "--kv-blocks", "64", "--slots", "4",
                "--max-new-tokens", "16"]
TIMEOUT_S = 120
# One thread a replica, and a supervisor that tolerates a loaded CPU's
# late /healthz (the suite runs several files at once).
QUIET_CPU = dict(OMP_NUM_THREADS="1", HOROVOD_TPU_FLEET_PROBE_FAILURES="40")


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


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.request(method, path, json.dumps(body) if body else None,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("autoscale")
    cfg = tfm.TransformerConfig(**SMALL)
    model = tfm.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    checkpoint_hook(str(d), model=types.SimpleNamespace(
        state_dict=model.params_tree), every=1,
        extra=transformer_extra(cfg))(0, block=True)
    return str(d)


def test_scale_to_grows_and_retires(ckpt):
    fleet = Fleet(1, ["--checkpoint-dir", ckpt] + REPLICA_ARGS,
                  env=dict(os.environ, **QUIET_CPU), probe_interval_s=0.1,
                  probe_failures=40)
    fleet.start()
    try:
        fleet.wait_ready(TIMEOUT_S)
        fleet.scale_to(2)
        assert [r.index for r in fleet.replicas] == [0, 1]
        _wait(lambda: len(fleet.endpoints()) == 2, "the scaled-up replica")
        new = fleet.replicas[1]
        status, body = _request(new.port, "POST", "/generate",
                                {"tokens": [1, 2, 3], "max_new_tokens": 4})
        assert status == 200 and len(body["tokens"]) == 4
        fleet.scale_to(1)
        assert new.retiring and fleet.live_count() == 1
        _wait(lambda: new not in fleet.replicas, "the retired replica")
        assert new.restarts == 0 and fleet.live_count() == 1
        events = [(p[0], p[1]) for _, kind, p in tfr.recorder()._ring
                  if kind == "serving_replica"]
        for want in (("scale_up", 1), ("scale_down", 1), ("retired", 1)):
            assert want in events, events
    finally:
        fleet.stop(timeout_s=60)


def test_cli_autoscaler_grows_the_fleet(ckpt):
    env = dict(os.environ, **QUIET_CPU, HOROVOD_TPU_QOS_SCALE_HIGH="0.05",
               HOROVOD_TPU_QOS_SCALE_SUSTAIN_S="0.3",
               HOROVOD_TPU_QOS_SCALE_COOLDOWN_S="600",
               HOROVOD_TPU_QOS_SCALE_INTERVAL_S="0.1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serving", "--fleet", "1",
         "--autoscale-max", "2", "--checkpoint-dir", ckpt, "--port", "0",
         "--host", "127.0.0.1"] + REPLICA_ARGS, cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    lines = queue.Queue()

    def pump():
        for line in proc.stderr:
            lines.put(line)

    threading.Thread(target=pump, daemon=True).start()
    stop = threading.Event()
    codes = []

    def client(port):
        while not stop.is_set():
            codes.append(_request(port, "POST", "/generate",
                                  {"tokens": [5, 6, 7, 8],
                                   "max_new_tokens": 16})[0])

    clients = []
    try:
        port = _routing_port(proc, lines)
        clients = [threading.Thread(target=client, args=(port,), daemon=True)
                   for _ in range(6)]
        for c in clients:
            c.start()

        def two_ready():
            replicas = _request(port, "GET", "/healthz")[1]["replicas"]
            return sum(r["ready"] for r in replicas) == 2

        _wait(two_ready, "the autoscaler's second replica")
        stop.set()
        for c in clients:
            c.join(timeout=TIMEOUT_S)
        assert not any(c.is_alive() for c in clients)
        assert codes and set(codes) == {200}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=TIMEOUT_S) == 0
    finally:
        stop.set()
        _reap(proc)
