"""The port's HTTP front end (``serving/server.py``) and CLI
(``python -m horovod_tpu_torch.serving``), the cases of
``tests/test_serving.py``'s server classes: JAX's routes, bodies,
status codes and headers (400, 404, 429 with ``Retry-After``, 503 with
``Connection: close`` while draining, 504 past a deadline), streaming,
the session-id header, SIGTERM -> drain -> exit 0 of the one-replica
CLI on a committed checkpoint, and its refusal of ``--tp`` > 1. The served tokens are JAX's engine's on
the same parameters.

Every socket has a timeout, every thread join and subprocess wait too.
"""

import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import types
from pathlib import Path

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
from horovod_tpu_torch.checkpoint import checkpoint_hook
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.serving import (InferenceEngine, ServingConfig,
                                       transformer_extra)
from horovod_tpu_torch.serving.server import ServingServer

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, remat=False)
ENGINE = dict(block_size=4, kv_blocks=40, max_batch_slots=4, max_queue=8,
              max_new_tokens=8, min_prefill_bucket=8)
SOCKET_TIMEOUT_S = 60
CLI_TIMEOUT_S = 120


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


def _jax_tokens(models, prompt, max_new_tokens, **over):
    jcfg, params, _ = models
    eng = JaxEngine(params, jcfg, jax_mesh(devices=jax.devices()[:1], tp=1),
                    JaxConfig(**dict(ENGINE, **over)))
    return eng.generate(prompt, max_new_tokens=max_new_tokens)


@pytest.fixture
def served(models):
    eng = _engine(models, max_batch_slots=2, max_new_tokens=4)
    srv = ServingServer(eng, port=0, host="127.0.0.1")
    srv.start()
    yield eng, srv
    srv.shutdown()


@pytest.fixture
def http_only(models):
    """A server whose scheduler loop never runs: the HTTP thread only."""
    made = []

    def make(**over):
        eng = _engine(models, **over)
        srv = ServingServer(eng, port=0, host="127.0.0.1")
        srv._http_thread.start()
        made.append(srv)
        return eng, srv

    yield make
    for srv in made:
        srv._httpd.shutdown()
        srv._httpd.server_close()
        srv._http_thread.join(timeout=SOCKET_TIMEOUT_S)


def _conn(port):
    return http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=SOCKET_TIMEOUT_S)


def _post(port, body, headers=None):
    conn = _conn(port)
    conn.request("POST", "/generate", json.dumps(body),
                 dict({"Content-Type": "application/json"},
                      **(headers or {})))
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read()), resp


def _get(port, path):
    conn = _conn(port)
    conn.request("GET", path)
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read()), resp


def test_generate_and_healthz(served, models):
    _, srv = served
    status, health, _ = _get(srv.port, "/healthz")
    assert status == 200 and health["status"] == "serving"
    assert health["kv_blocks_total"] == 39 and health["block_size"] == 4
    assert health["prefix_cache"] is False
    assert health["batch_slots"] == 2 and health["reserved_slots"] == 0
    status, body, _ = _post(srv.port, {"tokens": [1, 2, 3]})
    assert status == 200
    assert body["tokens"] == _jax_tokens(models, [1, 2, 3], 4)
    assert body["ttft_ms"] > 0 and body["latency_ms"] >= body["ttft_ms"]
    assert body["trace_id"]


@pytest.mark.parametrize("body,code", [
    ({"tokens": "nope"}, 400), ({"tokens": [1], "max_new_tokens": 10 ** 6},
                                400),
    ({}, 400), ({"tokens": [1], "slo": {"ttft_ms": -1}}, 400),
    ({"tokens": [1, 2], "deadline_ms": 0}, 504)])
def test_bad_requests(served, body, code):
    _, srv = served
    status, reply, _ = _post(srv.port, body)
    assert status == code and reply["error"]


def test_not_found_404(served):
    _, srv = served
    assert _get(srv.port, "/nothing")[0] == 404
    conn = _conn(srv.port)
    conn.request("POST", "/elsewhere", "{}")
    resp = conn.getresponse()
    resp.read()
    assert resp.status == 404


def test_queue_full_is_429_with_retry_after(http_only):
    eng, srv = http_only(max_queue=1)
    eng.submit([1, 2, 3])
    status, body, resp = _post(srv.port, {"tokens": [4, 5, 6]})
    assert status == 429 and "queue full" in body["error"]
    assert int(resp.getheader("Retry-After")) >= 1
    assert hvd.metrics_snapshot()["hvdtpu_serving_http_requests_total"][
        "values"]['code="429",route="generate"'] >= 1
    eng.run_until_idle()


def test_streaming_generate_matches_unary(served):
    _, srv = served
    conn = _conn(srv.port)
    conn.request("POST", "/generate",
                 json.dumps({"tokens": [2, 7, 1], "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "application/x-ndjson"
    lines = [json.loads(ln) for ln in resp.read().splitlines() if ln.strip()]
    assert "id" in lines[0]
    done = lines[-1]
    assert done["done"] and done["status"] == "completed"
    toks = [ln["t"] for ln in lines[1:-1]]
    assert done["n"] == len(toks) == 4
    status, unary, _ = _post(srv.port, {"tokens": [2, 7, 1]})
    assert status == 200 and unary["tokens"] == toks


def test_readyz_flips_on_drain_healthz_stays_live(http_only):
    _, srv = http_only()
    status, body, _ = _get(srv.port, "/readyz")
    assert status == 200 and body["status"] == "ready"
    srv._stop.set()
    status, body, resp = _get(srv.port, "/readyz")
    assert status == 503 and body["status"] == "draining"
    assert resp.getheader("Connection") == "close"
    status, body, _ = _get(srv.port, "/healthz")
    assert status == 200 and body["status"] == "draining"


def test_draining_503_carries_connection_close(http_only):
    eng, srv = http_only()
    eng._draining = True
    status, _, resp = _post(srv.port, {"tokens": [1, 2]})
    assert status == 503 and resp.getheader("Connection") == "close"


def test_quota_429_carries_tenant_retry_after(http_only, tmp_path,
                                              monkeypatch):
    from horovod_tpu_torch.serving import qos
    path = tmp_path / "qos.json"
    path.write_text(json.dumps({"tenants": {"t": {
        "quota_tokens_per_s": 10}}}))
    monkeypatch.setenv("HOROVOD_TPU_SLO_CONFIG", str(path))
    qos._reset_policy()
    try:
        eng, srv = http_only()
        eng.submit([1, 2, 3], tenant="t", max_new_tokens=8)
        status, body, resp = _post(srv.port, {"tokens": [1, 2, 3]},
                                   {"X-Tenant": "t"})
        assert status == 429 and int(resp.getheader("Retry-After")) >= 1
        eng.run_until_idle()
    finally:
        monkeypatch.delenv("HOROVOD_TPU_SLO_CONFIG")
        qos._reset_policy()


def test_session_and_request_ids_flow(models):
    eng = _engine(models, max_new_tokens=4)
    srv = ServingServer(eng, port=0, host="127.0.0.1")
    srv.start()
    try:
        status, body, _ = _post(srv.port, {"tokens": [4] * 9,
                                           "session_id": "conv-1"},
                                {"X-Request-Id": "trace-xyz"})
        assert status == 200 and body["trace_id"] == "trace-xyz"
        health = _get(srv.port, "/healthz")[1]
        assert health["sessions"] == ["conv-1"]
        assert health["session_leases"] == 8
        assert _post(srv.port, {"tokens": [4] * 9},
                     {"X-Session-Id": "conv-2"})[0] == 200
        assert set(_get(srv.port, "/healthz")[1]["sessions"]) == {
            "conv-1", "conv-2"}
    finally:
        srv.shutdown()


def test_concurrent_clients_get_their_tokens(served, models):
    _, srv = served
    prompts = [[1 + i, 2, 3] for i in range(6)]
    out = [None] * len(prompts)

    def client(i):
        out[i] = _post(srv.port, {"tokens": prompts[i]})[1]["tokens"]

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SOCKET_TIMEOUT_S)
    assert out == [_engine(models).generate(p, max_new_tokens=4)
                   for p in prompts]


# ----------------------------------------------------------------- CLI

def _cli(args, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serving"] + args,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, **(env or {})))


def test_cli_serves_a_commit_and_drains_on_sigterm(tmp_path, models):
    model = models[2]
    save = checkpoint_hook(str(tmp_path),
                           model=types.SimpleNamespace(
                               state_dict=model.params_tree),
                           every=1, extra=transformer_extra(model.cfg))
    save(1, block=True)
    proc = _cli(["--checkpoint-dir", str(tmp_path), "--framework", "torch",
                 "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
                 "--block-size", "4", "--kv-blocks", "40", "--slots", "4",
                 "--max-new-tokens", "5"])
    try:
        lines = queue.Queue()
        threading.Thread(target=lambda: lines.put(proc.stdout.readline()),
                         daemon=True).start()
        line = lines.get(timeout=CLI_TIMEOUT_S)
        assert "[serving] ready on :" in line, line
        port = int(line.split("ready on :")[1].split()[0])
        status, body, _ = _post(port, {"tokens": [1, 2, 3]})
        assert status == 200
        assert body["tokens"] == _jax_tokens(models, [1, 2, 3], 5,
                                             min_prefill_bucket=16)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=CLI_TIMEOUT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=CLI_TIMEOUT_S)


@pytest.mark.parametrize("args,match", [
    (["--tp", "0"], "must be >= 1"),
    (["--fleet", "1", "--tp", "0"], "must be >= 1"),
    (["--tp", "2", "--device", "cuda:1"], "LOCAL_RANK")])
def test_cli_refuses_the_fleet_and_tp(tmp_path, args, match):
    """``--tp 2`` serves (tests/test_torch_serving_tp.py); a width
    below 1, under ``--fleet`` too, and a card index at tp > 1 (each
    rank takes ``cuda:LOCAL_RANK``) are refused before any process
    starts."""
    proc = _cli(["--checkpoint-dir", str(tmp_path), "--device", "cpu"]
                + args)
    _, err = proc.communicate(timeout=CLI_TIMEOUT_S)
    assert proc.returncode != 0 and match in err
