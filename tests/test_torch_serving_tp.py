"""The port's serving at tp > 1: the ``InferenceEngine`` over two gloo
ranks (rank 0 scheduling and broadcasting each forward's step message,
rank 1 following) against JAX's engine on a 2-device CPU mesh, and the
CLI's ``--tp 2``: through the runner's ``--serve``, behind ``--fleet 1``,
and the deaths of its processes.

Tokens are compared exactly. The parity run is fp32, 2 layers of
d_model 64, 8 greedy requests on chunked prefill, the int8 pool and the
prefix cache. A replica at tp = 2 is three processes here (a parent and
two ranks); only rank 0 binds HTTP. Every process tree is started with
its own session and reaped, and every wait has its own timeout.
"""

import http.client
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_launch_workers as workers
from horovod_tpu.checkpoint import CheckpointEngine as JaxCheckpointEngine
from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel.mesh import create_mesh as jax_mesh
from horovod_tpu.serving import InferenceEngine as JaxEngine
from horovod_tpu.serving import ServingConfig as JaxConfig
from horovod_tpu.serving import loader as jloader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 120
MODEL = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64, remat=False)
# The parity run: chunked prefill, the int8 pool, the prefix cache.
LEVERS = dict(block_size=4, kv_blocks=64, max_batch_slots=4, max_queue=8,
              max_new_tokens=8, min_prefill_bucket=8, prefill_chunk=8,
              kv_quant="int8", prefix_cache=True)
# The CLI's engine: its flags below and its defaults.
CLI_ENGINE = dict(block_size=4, kv_blocks=40, max_batch_slots=4,
                  max_new_tokens=5)
CLI_ARGS = ["--device", "cpu", "--tp", "2", "--port", "0", "--host",
            "127.0.0.1", "--block-size", "4", "--kv-blocks", "40",
            "--slots", "4", "--max-new-tokens", "5"]
CLI_PROMPTS = [[1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 11]]


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 64, n)] for n in lengths]


SYSTEM = _prompts(33, [9])[0]
PROMPTS = [SYSTEM + p for p in _prompts(34, [3, 3, 3])] + _prompts(
    7, [33, 3, 17, 9, 41])


@pytest.fixture(scope="module")
def model():
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **MODEL)
    params = jax.device_get(jtfm.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, params


def _jax_tokens(model, prompts, max_new, **engine):
    jcfg, params = model
    cfg = jtfm.TransformerConfig(dtype=jnp.float32, tp_axis="tp", **MODEL)
    mesh = jax_mesh(devices=jax.devices()[:2], tp=2)
    eng = JaxEngine(params, cfg, mesh, JaxConfig(**engine))
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_idle()
    return [r.result(timeout=TIMEOUT_S) for r in reqs]


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree, np.float32)


def test_tp2_engine_on_gloo_ranks_gives_jax_tokens(model):
    """Two gloo ranks, launched by the runner: rank 0 schedules and
    samples, rank 1 follows its step messages; the tokens are JAX's
    tp = 2 engine's, exactly."""
    from horovod_tpu_torch.runner import run
    got = {}

    def port():
        got["out"] = run(workers.serve_tp, args=(
            _numpy_tree(model[1]), MODEL, LEVERS, PROMPTS, 8), np=2,
            extra_env={"PYTHONPATH": TESTS, "OMP_NUM_THREADS": "1"},
            start_timeout=TIMEOUT_S, run_timeout=TIMEOUT_S)

    t = threading.Thread(target=port)
    t.start()   # the ranks start while JAX compiles
    want = _jax_tokens(model, PROMPTS, 8, **LEVERS)
    t.join(TIMEOUT_S)
    lead, follower = got["out"]
    assert follower is None
    assert lead["tokens"] == want
    assert all(len(t) == 8 for t in want)
    # One message a forward and the stop: at least a prefill per request.
    assert lead["messages"] > len(PROMPTS)


# ------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, model):
    """JAX's commit of the parameters, and JAX's tp = 2 tokens of the
    CLI's engine for ``CLI_PROMPTS``."""
    jcfg, params = model
    d = str(tmp_path_factory.mktemp("tp_ckpt"))
    eng = JaxCheckpointEngine(d, process_count=1, barrier=lambda n: None)
    eng.save(params, 1, extra=jloader.transformer_extra(jcfg))
    eng.wait()
    return d, [_jax_tokens(model, [p], 5, **CLI_ENGINE)[0]
               for p in CLI_PROMPTS]


class _Proc:
    """A process tree started in its own session, its output read by
    threads: stdout lines queued, stderr kept."""

    def __init__(self, args):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   HOROVOD_TPU_FLEET_PROBE_FAILURES="50",
                   HOROVOD_TPU_FLEET_PROBE_INTERVAL="0.1")
        self.p = subprocess.Popen(
            [sys.executable, "-m", *args], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=REPO,
            start_new_session=True)
        self.out, self.err = queue.Queue(), []
        self.stdout = []
        threading.Thread(target=self._pump, daemon=True).start()
        threading.Thread(target=lambda: self.err.extend(self.p.stderr),
                         daemon=True).start()

    def _pump(self):
        for line in self.p.stdout:
            self.stdout.append(line)
            self.out.put(line)

    def line(self, pattern, source="out"):
        """The first match of ``pattern`` in stdout (or stderr)."""
        deadline = time.monotonic() + TIMEOUT_S
        while time.monotonic() < deadline:
            if source == "err":
                for ln in list(self.err):
                    m = re.search(pattern, ln)
                    if m:
                        return m
                time.sleep(0.1)
                continue
            try:
                m = re.search(pattern, self.out.get(timeout=0.5))
            except queue.Empty:
                continue
            if m:
                return m
        raise AssertionError(f"no {pattern!r} in {self.stdout} "
                             f"{''.join(self.err)[-3000:]}")

    def rank_pids(self, n=2):
        pids = {}
        deadline = time.monotonic() + TIMEOUT_S
        while len(pids) < n and time.monotonic() < deadline:
            for ln in list(self.err):
                m = re.search(r"\[serving\] rank (\d+) of \d+ pid (\d+)", ln)
                if m:
                    pids[int(m.group(1))] = int(m.group(2))
            time.sleep(0.1)
        assert len(pids) == n, "".join(self.err)[-3000:]
        return pids

    def reap(self):
        if self.p.poll() is None:
            try:
                os.killpg(self.p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        self.p.wait(timeout=TIMEOUT_S)


def _gone(pid):
    """The process has exited (a zombie awaiting its reaper counts)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except (FileNotFoundError, ProcessLookupError):
        return True


def _all_gone(pids, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(_gone(p) for p in pids):
            return True
        time.sleep(0.1)
    return False


def _post(port, tokens):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.request("POST", "/generate", json.dumps(
            {"tokens": tokens, "max_new_tokens": 5}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        return json.loads(resp.read())["tokens"]
    finally:
        conn.close()


@pytest.fixture(scope="module")
def served(ckpt):
    """``--serve`` and ``--serve --fleet 1`` through the runner, started
    at once."""
    procs = {name: _Proc(["horovod_tpu_torch.runner", "--serve", *fleet,
                          "--", "--checkpoint-dir", ckpt[0], *CLI_ARGS])
             for name, fleet in (("serve", []),
                                 ("fleet", ["--fleet", "1"]))}
    yield procs
    for p in procs.values():
        p.reap()


@pytest.mark.parametrize("how", ["serve", "fleet"])
def test_runner_serves_tp2(ckpt, served, how):
    """``python -m horovod_tpu_torch.runner --serve [--fleet 1] --
    --tp 2 --device cpu``: JAX's tokens over HTTP (through the router
    behind ``--fleet``), one ``ready on`` line (rank 0's; rank 1 binds
    nothing), and SIGTERM drains every process to exit 0."""
    want = ckpt[1]
    proc = served[how]
    if how == "fleet":
        port = int(proc.line(r"\[fleet\] routing on :(\d+)", "err").group(1))
    else:
        port = int(proc.line(r"\[serving\] ready on :(\d+)").group(1))
    pids = proc.rank_pids()
    assert [_post(port, p) for p in CLI_PROMPTS] == want
    if how == "serve":   # (the supervisor reads its replica's stdout)
        ready = [ln for ln in proc.stdout + proc.err if "ready on :" in ln]
        assert len(ready) == 1 and "[0]<stdout>:" in ready[0], ready
    proc.p.send_signal(signal.SIGTERM)
    assert proc.p.wait(timeout=TIMEOUT_S) == 0, "".join(proc.err)[-3000:]
    assert _all_gone(pids.values())


@pytest.fixture(scope="module")
def victims(ckpt):
    """Three replicas at tp = 2 started at once, one for each death."""
    procs = {v: _Proc(["horovod_tpu_torch.serving", "--checkpoint-dir",
                       ckpt[0], *CLI_ARGS])
             for v in ("follower", "rank0", "parent")}
    yield procs
    for p in procs.values():
        p.reap()


@pytest.mark.parametrize("victim", ["follower", "rank0", "parent"])
def test_a_death_takes_every_rank(victims, victim):
    """SIGKILL of a follower or of rank 0 ends the replica with a
    non-zero exit and no rank left; SIGKILL of the ranks' parent (a
    fleet's kill) leaves none either (their parent watchdog)."""
    proc = victims[victim]
    port = int(proc.line(r"\[serving\] ready on :(\d+)").group(1))
    pids = proc.rank_pids()
    assert _post(port, CLI_PROMPTS[0])
    target = {"follower": pids[1], "rank0": pids[0],
              "parent": proc.p.pid}[victim]
    os.kill(target, signal.SIGKILL)
    rc = proc.p.wait(timeout=TIMEOUT_S)
    assert rc != 0
    assert _all_gone(pids.values()), "".join(proc.err)[-3000:]
