"""The port's launcher (``horovod_tpu_torch.runner``): the cases of
``tests/test_runner.py`` on the port — the RPC wire and its auth, host
parsing, function-mode launches and the CLI — with the launcher's env
being torch's rendezvous (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``...)
where JAX's is its coordinator's. JAX's ``Wire`` reads the port's
frames and the other way round: the wire format is one.

Spawned workers import torch alone: their functions live in
``tests/_torch_launch_workers.py``, on the workers' ``PYTHONPATH``, and
every launch has a timeout of its own.
"""

import os
import signal
import socket
import subprocess
import sys
import threading

import pytest

import _torch_launch_workers as workers
from horovod_tpu.runner.network import Wire as JaxWire
from horovod_tpu_torch.runner import network, parse_hosts
from horovod_tpu_torch.runner.host_hash import host_hash
from horovod_tpu_torch.runner.launcher import expand_slots
from horovod_tpu_torch.runner.network import (AuthenticationError,
                                              BasicClient, BasicService,
                                              Wire)
from horovod_tpu_torch.runner.secret import (decode_key, encode_key,
                                             make_secret_key)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
RUN_TIMEOUT_S = 120
# Workers: this directory importable, one thread each.
WORKER_ENV = {"PYTHONPATH": TESTS, "OMP_NUM_THREADS": "1"}


# ---------------------------------------------------------------------------
# Wire / auth
# ---------------------------------------------------------------------------

class TestWire:
    def _pair(self):
        a, b = socket.socketpair()
        return a, b

    def test_roundtrip(self):
        key = make_secret_key()
        wire = Wire(key)
        a, b = self._pair()
        obj = {"hello": [1, 2, 3], "x": "y"}
        wire.write(a, obj)
        assert wire.read(b) == obj
        # One frame format: JAX's wire reads the port's and back.
        wire.write(a, obj)
        assert JaxWire(key).read(b) == obj
        JaxWire(key).write(a, obj)
        assert wire.read(b) == obj
        a.close(); b.close()

    def test_tampered_payload_rejected(self):
        key = make_secret_key()
        wire = Wire(key)
        a, b = self._pair()
        wire.write(a, ["payload"])
        raw = bytearray(b.recv(65536))
        raw[-1] ^= 0xFF  # flip a bit in the pickle
        c, d = self._pair()
        c.sendall(bytes(raw))
        with pytest.raises(AuthenticationError):
            wire.read(d)
        for s in (a, b, c, d):
            s.close()

    def test_wrong_key_rejected(self):
        a, b = self._pair()
        Wire(make_secret_key()).write(a, "secret message")
        with pytest.raises(AuthenticationError):
            Wire(make_secret_key()).read(b)
        a.close(); b.close()

    def test_key_codec(self):
        key = make_secret_key()
        assert decode_key(encode_key(key)) == key


# ---------------------------------------------------------------------------
# Service / client
# ---------------------------------------------------------------------------

class _EchoRequest:
    def __init__(self, value):
        self.value = value


class _EchoService(BasicService):
    def _handle(self, req, client_address):
        return ("echo", req.value)


class TestService:
    def test_request_response(self):
        key = make_secret_key()
        svc = _EchoService("echo", key)
        try:
            client = BasicClient([("127.0.0.1", svc.port)], key)
            assert client.ping()
            assert client.request(_EchoRequest(42)) == ("echo", 42)
        finally:
            svc.shutdown()

    def test_wrong_key_client_rejected(self):
        key = make_secret_key()
        svc = _EchoService("echo", key)
        try:
            bad = BasicClient([("127.0.0.1", svc.port)],
                              make_secret_key(), attempts=1, timeout=2.0)
            with pytest.raises(ConnectionError):
                bad.request(_EchoRequest(1))
        finally:
            svc.shutdown()

    def test_concurrent_clients(self):
        key = make_secret_key()
        svc = _EchoService("echo", key)
        results = []
        try:
            def call(i):
                c = BasicClient([("127.0.0.1", svc.port)], key)
                results.append(c.request(_EchoRequest(i)))
            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert sorted(v for _, v in results) == list(range(8))
        finally:
            svc.shutdown()


# ---------------------------------------------------------------------------
# Host parsing / hashing
# ---------------------------------------------------------------------------

class TestHosts:
    def test_parse_hosts(self):
        assert parse_hosts("a:2,b:3") == [("a", 2), ("b", 3)]
        assert parse_hosts("localhost") == [("localhost", 1)]
        assert parse_hosts("a:1, b:2") == [("a", 1), ("b", 2)]

    def test_expand_slots_contiguous(self):
        ranks = expand_slots([("a", 2), ("b", 2)], 4)
        assert ranks == ["a", "a", "b", "b"]

    def test_expand_slots_insufficient(self):
        with pytest.raises(ValueError):
            expand_slots([("a", 1)], 2)

    def test_host_hash_stable(self):
        assert host_hash() == host_hash()
        assert host_hash("x") != host_hash("y")


class TestPortProbe:
    def test_probe_reports_busy_and_free(self):
        """remote_bootstrap --probe distinguishes a port with a live
        listener from a free one."""
        from horovod_tpu_torch.runner.remote_bootstrap import probe_ports
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.bind(("", 0))
        srv.listen(1)
        busy_port = srv.getsockname()[1]
        free_port = network.find_free_port()
        try:
            res = probe_ports([busy_port, free_port])
            assert busy_port in res["busy"]
            assert free_port in res["free"]
        finally:
            srv.close()


# ---------------------------------------------------------------------------
# End-to-end function mode (horovod.spark.run parity)
# ---------------------------------------------------------------------------

class TestRun:
    def test_run_collects_results_in_rank_order(self):
        from horovod_tpu_torch.runner import run
        results = run(workers.rank_env, np=2, extra_env=WORKER_ENV,
                      start_timeout=RUN_TIMEOUT_S,
                      run_timeout=RUN_TIMEOUT_S)
        assert results == [(0, 2), (1, 2)]

    def test_run_propagates_worker_error(self):
        from horovod_tpu_torch.runner import run
        with pytest.raises(RuntimeError, match="rank 1"):
            run(workers.fail_on_rank1, np=2, extra_env=WORKER_ENV,
                start_timeout=RUN_TIMEOUT_S, run_timeout=RUN_TIMEOUT_S)

    def test_run_initializes_gloo_world(self):
        """``init`` builds the gloo world from the launcher's env alone:
        rank, size, local rank and local size on one host."""
        from horovod_tpu_torch.runner import run
        results = run(workers.gloo_world, np=2, extra_env=WORKER_ENV,
                      start_timeout=RUN_TIMEOUT_S,
                      run_timeout=RUN_TIMEOUT_S)
        assert results == [(0, 2, 0, 2, "gloo"), (1, 2, 1, 2, "gloo")]


def _cli(args, **kw):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", *args],
        capture_output=True, text=True, timeout=RUN_TIMEOUT_S, env=env,
        cwd=REPO, **kw)


class TestCLI:
    def test_cli_tags_output_per_rank(self):
        proc = _cli(["-np", "2", sys.executable, "-c",
                     "import os; print('rank', os.environ['RANK'], "
                     "os.environ['LOCAL_RANK'], "
                     "os.environ['LOCAL_WORLD_SIZE'], "
                     "os.environ['MASTER_ADDR'])"])
        assert proc.returncode == 0, proc.stderr
        assert "[0]<stdout>:rank 0 0 2 127.0.0.1" in proc.stdout
        assert "[1]<stdout>:rank 1 1 2 127.0.0.1" in proc.stdout

    def test_cli_failfast_nonzero_exit(self):
        proc = _cli(["-np", "2", sys.executable, "-c",
                     "import os, sys, time\n"
                     "sys.exit(3) if os.environ['RANK'] == '1' "
                     "else time.sleep(60)"])
        assert proc.returncode == 3


def test_cli_exports_autotune():
    """--autotune reaches every worker as JAX's runner exports it."""
    from horovod_tpu_torch.runner.__main__ import main
    assert main(["--autotune", "-np", "1", "--no-tag-output", "--",
                 sys.executable, "-c",
                 "import os; assert os.environ['HOROVOD_TPU_AUTOTUNE']"
                 " == '1'"]) == 0


def test_cli_autotune_arms_the_engine_tuner_on_rank_0():
    """--autotune's export arms the engine's Bayesian tuner in rank 0's
    coordinator, as JAX's core reads HOROVOD_TPU_AUTOTUNE; no other
    rank holds one."""
    script = (
        "import horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch.ops import collective as c\n"
        "hvd.init(device='cpu')\n"
        "pm = c.engine()._coord._pm\n"
        "print('armed', hvd.rank(), pm is not None, flush=True)\n"
        "hvd.shutdown()\n")
    env = {k: v for k, v in os.environ.items()
           if "AUTOTUNE" not in k}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "--autotune",
         "-np", "2", sys.executable, "-c", script],
        capture_output=True, text=True, timeout=RUN_TIMEOUT_S, env=env,
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "[0]<stdout>:armed 0 True" in proc.stdout, proc.stdout
    assert "[1]<stdout>:armed 1 False" in proc.stdout, proc.stdout


def test_cli_exports_adaptation():
    """--adaptation (item 5c) reaches every worker as JAX's runner
    exports it."""
    from horovod_tpu_torch.runner.__main__ import main
    assert main(["--adaptation", "-np", "1", "--no-tag-output", "--",
                 sys.executable, "-c",
                 "import os; assert os.environ['HOROVOD_TPU_ADAPTATION']"
                 " == '1'"]) == 0


def test_cli_forwards_sigterm_to_the_workers():
    """SIGTERM to the runner reaches every worker, which exits on its
    own (a server's drain); the runner returns their code."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         sys.executable, "-c",
         "import signal, sys, time\n"
         "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
         "print('up', flush=True)\n"
         "time.sleep(60)"],
        stdout=subprocess.PIPE, text=True, env=env, cwd=REPO,
        start_new_session=True)
    try:
        ups = [proc.stdout.readline(), proc.stdout.readline()]
        assert all("<stdout>:up" in u for u in ups), ups
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=RUN_TIMEOUT_S) == 0
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
