"""Host discovery and the elastic driver of the port
(``horovod_tpu_torch.elastic.discovery``, ``.driver``): the local cases
of ``tests/test_elastic.py`` — the providers (the TPU-pod one against a
fake metadata server), the runner's discovery CLI and the SIGKILL
shrink-resume — on the port's launcher and gloo ranks.

The shrink-resume must equal the port's clean replay from the same
commit bit for bit, and JAX's arithmetic of the same schedule (the
world of 2 to the commit at step 10, a world of 1 after it) within
1e-5. The driver's ``hvdtpu_elastic_*`` families are JAX's, by name,
kind, labels and counts, for the same loop of failures.
"""

import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

import _torch_launch_workers as workers
from horovod_tpu.elastic import discovery as jax_discovery
from horovod_tpu_torch.elastic import (FailureConfig, HostfileProvider,
                                       SSHProbeProvider, StaticProvider,
                                       TPUPodProvider, WorkerFailure,
                                       get_provider)
from horovod_tpu_torch.elastic.discovery import (WORKER_ENDPOINTS_PATH,
                                                 _parse_worker_endpoints)

TESTS = os.path.dirname(os.path.abspath(__file__))
RUN_TIMEOUT_S = 120
WORKER_ENV = {"PYTHONPATH": TESTS, "OMP_NUM_THREADS": "1"}


# ---------------------------------------------------------------------------
# Discovery
# ---------------------------------------------------------------------------

class TestHostfileProvider:
    def test_parses_all_line_forms(self, tmp_path):
        hf = tmp_path / "hosts"
        hf.write_text(
            "# cluster A\n"
            "alpha slots=4\n"
            "beta:2\n"
            "gamma\n"
            "\n"
            "delta slots=1  # trailing comment\n")
        got = HostfileProvider(str(hf)).discover()
        assert got == [("alpha", 4), ("beta", 2), ("gamma", 1),
                       ("delta", 1)]
        assert got == jax_discovery.HostfileProvider(str(hf)).discover()

    def test_reread_per_discover(self, tmp_path):
        """Elastic growth: an operator editing the hostfile changes the
        next discovery, not just the first."""
        hf = tmp_path / "hosts"
        hf.write_text("a:1\n")
        p = HostfileProvider(str(hf))
        assert p.discover() == [("a", 1)]
        hf.write_text("a:1\nb:2\n")
        assert p.discover() == [("a", 1), ("b", 2)]


class TestSSHProbeProvider:
    def test_filters_unreachable(self):
        p = SSHProbeProvider([("up1", 2), ("down", 2), ("up2", 1)],
                             probe=lambda h: h.startswith("up"))
        assert p.discover() == [("up1", 2), ("up2", 1)]

    def test_local_hosts_skip_probe(self):
        p = SSHProbeProvider([("localhost", 2)],
                             probe=lambda h: pytest.fail(
                                 "probed a local host"))
        assert p.discover() == [("localhost", 2)]


class TestWorkerEndpointParsing:
    def test_uid_ip_port_triples(self):
        assert _parse_worker_endpoints(
            "uid0:10.0.0.2:8470,uid1:10.0.0.3:8470") == [
                "10.0.0.2", "10.0.0.3"]

    @pytest.mark.parametrize("text", [
        "10.0.0.2, host-b:8470, uid:10.0.0.4:8470,,", "", "a,a:1,x:a:2"])
    def test_bare_and_mixed(self, text):
        got = _parse_worker_endpoints(text)
        assert got == jax_discovery._parse_worker_endpoints(text)
        if text.startswith("10."):
            assert got == ["10.0.0.2", "host-b", "10.0.0.4"]


class _FakeMetadata(BaseHTTPRequestHandler):
    body = b"uid0:10.128.0.2:8470,uid1:10.128.0.3:8470"

    def do_GET(self):
        if self.headers.get("Metadata-Flavor") != "Google":
            self.send_response(403)
            self.end_headers()
            return
        if self.path == WORKER_ENDPOINTS_PATH:
            self.send_response(200)
            self.end_headers()
            self.wfile.write(self.body)
        else:
            self.send_response(404)
            self.end_headers()

    def log_message(self, *a):  # keep pytest output clean
        pass


@pytest.fixture
def fake_metadata_server():
    srv = HTTPServer(("127.0.0.1", 0), _FakeMetadata)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


class TestTPUPodProvider:
    def test_discovers_through_fake_metadata_server(
            self, fake_metadata_server):
        p = TPUPodProvider(metadata_addr=fake_metadata_server,
                           slots_per_host=1)
        assert p.discover() == [("10.128.0.2", 1), ("10.128.0.3", 1)]

    def test_slots_per_host(self, fake_metadata_server):
        p = TPUPodProvider(metadata_addr=fake_metadata_server,
                           slots_per_host=4)
        assert p.discover() == [("10.128.0.2", 4), ("10.128.0.3", 4)]

    def test_metadata_addr_env(self, fake_metadata_server, monkeypatch):
        monkeypatch.setenv("HOROVOD_TPU_METADATA_ADDR",
                           fake_metadata_server)
        assert TPUPodProvider().discover() == [
            ("10.128.0.2", 1), ("10.128.0.3", 1)]

    def test_unreachable_metadata_raises_actionable_error(self):
        p = TPUPodProvider(metadata_addr="http://127.0.0.1:1",
                           timeout=0.5)
        with pytest.raises(RuntimeError,
                           match="HOROVOD_TPU_METADATA_ADDR"):
            p.discover()


class TestGetProvider:
    def test_factory_shapes(self, tmp_path):
        hf = tmp_path / "hosts"
        hf.write_text("a:2\n")
        assert isinstance(get_provider(None, hosts="a:2"), StaticProvider)
        assert isinstance(get_provider("hostfile", hostfile=str(hf)),
                          HostfileProvider)
        assert isinstance(get_provider("ssh", hosts="a:2"),
                          SSHProbeProvider)
        assert isinstance(get_provider("tpu-pod", metadata_addr="http://x"),
                          TPUPodProvider)
        with pytest.raises(ValueError, match="hostfile"):
            get_provider("hostfile")
        with pytest.raises(ValueError, match="unknown discovery"):
            get_provider("k8s")


# ---------------------------------------------------------------------------
# The driver's loop and its metrics, against JAX's
# ---------------------------------------------------------------------------

def _loop_families(driver, registry, failure, config):
    """Run ``driver._elastic_loop`` over a static ``localhost:3`` (capped
    at 2 ranks) with an attempt that loses rank 1 twice, then succeeds:
    its result, the worlds it launched, and what the loop added to each
    ``hvdtpu_elastic_*`` family (counter and histogram counts by label,
    gauges' values; the timings left out)."""
    seen = []

    def attempt(np_now, hosts, rank_hosts, generation):
        seen.append((np_now, hosts, generation))
        if generation < 2:
            raise failure(rank=1, host="localhost", kind="killed")
        return ["done"]

    def counts(snap):
        out = {}
        for name, fam in snap.items():
            vals = fam["values"]
            if fam["type"] == "histogram":
                vals = {k: v["count"] for k, v in vals.items()}
            out[name] = (fam["type"], fam["help"], vals)
        return out

    before = counts(registry.snapshot("hvdtpu_elastic_"))
    out = driver._elastic_loop(
        driver.get_provider(None, hosts="localhost:3"), 1, 2,
        config(max_restarts=3, backoff_s=0.0, blacklist_s=600.0), attempt)
    fams = {}
    for name, (kind, help_text, vals) in counts(
            registry.snapshot("hvdtpu_elastic_")).items():
        if kind != "gauge":
            # Children an earlier test in this process left unchanged
            # are not the loop's.
            old = before.get(name, (kind, help_text, {}))[2]
            vals = {k: v - old.get(k, 0) for k, v in vals.items()
                    if v != old.get(k)}
        elif name == "hvdtpu_elastic_last_rendezvous_ms":
            vals = sorted(vals)
        fams[name] = (kind, help_text, vals)
    return out, seen, fams


def test_elastic_loop_metrics_match_jax():
    from horovod_tpu.elastic import driver as jdriver
    from horovod_tpu.elastic.failure import FailureConfig as JaxConfig
    from horovod_tpu.elastic.failure import WorkerFailure as JaxFailure
    from horovod_tpu.observability import registry as jreg
    from horovod_tpu_torch.elastic import driver as tdriver
    from horovod_tpu_torch.observability import registry as treg
    jout, jseen, jfams = _loop_families(jdriver, jreg, JaxFailure,
                                        JaxConfig)
    tout, tseen, tfams = _loop_families(tdriver, treg, WorkerFailure,
                                        FailureConfig)
    assert tout == jout == ["done"]
    # Two penalized slots of three: 2, then 1 after the second loss.
    assert tseen == jseen == [(2, "localhost:2", 0), (2, "localhost:2", 1),
                              (1, "localhost:1", 2)]
    assert set(tfams) == set(jfams) and len(tfams) == 5
    assert tfams == jfams


# ---------------------------------------------------------------------------
# CLI discovery
# ---------------------------------------------------------------------------

class TestRunnerDiscoveryCLI:
    def test_hostfile_discovery_sizes_and_runs(self, tmp_path, capsys):
        from horovod_tpu_torch.runner.__main__ import main

        hf = tmp_path / "hosts"
        hf.write_text("localhost slots=2\n")
        rc = main(["--discovery", "hostfile", "--hostfile", str(hf),
                   "--no-tag-output", "--timeout", str(RUN_TIMEOUT_S), "--",
                   sys.executable, "-c", "print('cli-ok')"])
        assert rc == 0
        err = capsys.readouterr().err
        assert "[discovery:hostfile] 1 host(s), 2 slot(s)" in err

    def test_tpu_pod_discovery_through_fake_metadata(self, capsys):
        from horovod_tpu_torch.runner.__main__ import main

        srv = HTTPServer(("127.0.0.1", 0), _FakeMetadata)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        body = _FakeMetadata.body
        try:
            _FakeMetadata.body = b"uid0:127.0.0.1:8470"
            rc = main(["--discovery", "tpu-pod",
                       "--metadata-addr",
                       f"http://127.0.0.1:{srv.server_address[1]}",
                       "--no-tag-output", "--timeout", str(RUN_TIMEOUT_S),
                       "--", sys.executable, "-c", "print('pod-ok')"])
            assert rc == 0
            err = capsys.readouterr().err
            assert "[discovery:tpu-pod]" in err
            assert "127.0.0.1:1" in err
        finally:
            _FakeMetadata.body = body
            srv.shutdown()
            srv.server_close()

    def test_missing_np_without_discovery_errors(self):
        from horovod_tpu_torch.runner.__main__ import main

        with pytest.raises(SystemExit):
            main(["--", sys.executable, "-c", "pass"])


# ---------------------------------------------------------------------------
# Acceptance: survive SIGKILL, shrink, resume from commit
# ---------------------------------------------------------------------------

def _jax_schedule(total, world_until, commit):
    """JAX's arithmetic of the quadratic worker (``tests/test_elastic.py``
    ``_elastic_worker``): ``world_until`` ranks up to step ``commit``,
    one rank after it, the gradients averaged over the world."""
    import jax.numpy as jnp
    w = jnp.zeros((4,))
    target = jnp.asarray([1.0, -2.0, 3.0, 0.5])
    for step in range(total):
        n = world_until if step < commit else 1
        grads = [(1.0 + 0.1 * ((step * 7 + r * 3) % 5)) * (w - target)
                 for r in range(n)]
        w = w - 0.1 * (sum(grads) / n)
    return np.asarray(w)


class TestElasticRecovery:
    def test_sigkill_shrink_resume_matches_replay(self, tmp_path):
        from horovod_tpu_torch.elastic import run_elastic
        from horovod_tpu_torch.runner import run

        state_dir = str(tmp_path / "estate")
        total, commit_every, kill_at = 20, 5, 12
        cfg = FailureConfig(failure_timeout_s=60.0, max_restarts=2,
                            backoff_s=0.2, backoff_factor=1.5,
                            blacklist_s=600.0)
        results = run_elastic(
            workers.quadratic, args=(total, commit_every, kill_at),
            min_np=1, max_np=2, hosts="localhost:2",
            state_dir=state_dir, config=cfg, extra_env=WORKER_ENV,
            start_timeout=RUN_TIMEOUT_S, run_timeout=RUN_TIMEOUT_S)

        # The world shrank to 1 and resumed in generation 1 from the
        # last commit before the kill (step 10, not 12 or 0).
        assert len(results) == 1
        final = results[0]
        assert (final["gen"], final["size"], final["start"]) == (1, 1, 10)

        # Clean control: a fresh np=1 job replaying from the same
        # commit, never failing: the same bits.
        replay = run(workers.quadratic, args=(total, commit_every, kill_at),
                     kwargs={"replay_from": 10}, np=1,
                     extra_env=dict(WORKER_ENV, HOROVOD_TPU_ELASTIC_DIR=(
                         state_dir)),
                     start_timeout=RUN_TIMEOUT_S, run_timeout=RUN_TIMEOUT_S)
        assert replay[0]["start"] == 10
        assert final["w"] == replay[0]["w"]
        np.testing.assert_allclose(final["w"], _jax_schedule(total, 2, 10),
                                   rtol=1e-5)

    def test_no_failure_single_generation(self, tmp_path):
        """Control: without a kill the elastic driver is one generation
        of the full world."""
        from horovod_tpu_torch.elastic import run_elastic

        results = run_elastic(
            workers.quadratic, args=(6, 3, 10 ** 9),
            min_np=1, max_np=2, hosts="localhost:2",
            state_dir=str(tmp_path / "estate2"),
            config=FailureConfig(max_restarts=1, backoff_s=0.2),
            extra_env=WORKER_ENV, start_timeout=RUN_TIMEOUT_S,
            run_timeout=RUN_TIMEOUT_S)
        assert len(results) == 2
        assert all(r["gen"] == 0 and r["size"] == 2 for r in results)
        assert results[0]["w"] == results[1]["w"]
        np.testing.assert_allclose(results[0]["w"], _jax_schedule(6, 2, 6),
                                   rtol=1e-5)
