"""The port's fleet router (``serving/router.py``) over stub replicas:
the cases of ``tests/test_fleet_router.py`` run against
``horovod_tpu_torch.serving.Router`` — the policy, warmth tracking,
draining replicas, the deadline 504, failover before the first token,
the mid-stream resume with a stable request id, fleet-wide queue-full
with Retry-After, the router's own health endpoints and session
affinity — all over real HTTP with no model. And ``pick_replica``
picks the replica JAX's picks over random views."""

import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest

from horovod_tpu.serving import fleet as jfleet
from horovod_tpu.serving import router as jrouter
from horovod_tpu_torch import metrics_snapshot
from horovod_tpu_torch.serving import fleet as tfleet
from horovod_tpu_torch.serving import router as trouter
from horovod_tpu_torch.serving.fleet import ReplicaEndpoint
from horovod_tpu_torch.serving.router import (ReplicaView, Router,
                                              StaticBackends, pick_replica)

# Deterministic stub "generation": token i of a reply to a prompt of
# length L is (L + i) % 97. Suffix-consistent: re-prefilling
# prompt+emitted continues the exact sequence, the contract greedy
# decode gives the real router.


def stub_tokens(prompt_len: int, n: int):
    return [(prompt_len + i) % 97 for i in range(n)]


class StubReplica:
    """A fake serving replica: /readyz, /healthz (scrape fallback),
    /generate streaming the deterministic stub sequence. Behavior
    knobs are plain attributes, mutable mid-test."""

    def __init__(self, queue_depth=0, active=0, slots=8, ready=True,
                 die_after=None, reject=None, token_delay_s=0.0):
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)
        self.queue_depth = queue_depth
        self.active = active
        self.slots = slots
        self.ready = ready
        self.die_after = die_after      # close stream after N tokens
        self.reject = reject            # HTTP code to refuse with
        self.token_delay_s = token_delay_s
        self.requests = []              # bodies of /generate calls
        self.request_ids = []           # X-Request-Id header per call
        self.sessions = []              # leases, like a real replica
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _json(self, code, payload, headers=None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                path = self.path.split("?")[0]
                if path == "/readyz":
                    if outer.ready:
                        self._json(200, {"status": "ready"})
                    else:
                        self._json(503, {"status": "draining"})
                elif path == "/healthz":
                    self._json(200, {
                        "status": "serving",
                        "queue_depth": outer.queue_depth,
                        "active_requests": outer.active,
                        "batch_slots": outer.slots,
                        "sessions": list(outer.sessions),
                    })
                else:
                    self._json(404, {})

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
                outer.requests.append(body)
                outer.request_ids.append(
                    self.headers.get("X-Request-Id"))
                if outer.reject:
                    self._json(outer.reject,
                               {"error": f"stub {outer.reject}"},
                               headers={"Retry-After": 1}
                               if outer.reject == 429 else None)
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/x-ndjson")
                self.end_headers()
                self.wfile.write(b'{"id": 0}\n')
                toks = stub_tokens(len(body["tokens"]),
                                   int(body["max_new_tokens"]))
                for i, t in enumerate(toks):
                    if outer.die_after is not None \
                            and i >= outer.die_after:
                        # Mid-stream death: hang up with no done line.
                        self.wfile.flush()
                        self.connection.close()
                        return
                    if outer.token_delay_s:
                        time.sleep(outer.token_delay_s)
                    self.wfile.write(
                        json.dumps({"t": t}).encode() + b"\n")
                    self.wfile.flush()
                self.wfile.write(json.dumps(
                    {"done": True, "status": "completed",
                     "n": len(toks), "ttft_ms": 1.0,
                     "latency_ms": 2.0}).encode() + b"\n")
                sid = body.get("session_id")
                if sid and sid not in outer.sessions:
                    outer.sessions.append(sid)   # lease formed

            def log_message(self, *args):
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def _router(stubs, **kw):
    backends = StaticBackends([
        ReplicaEndpoint(index=i, host="127.0.0.1", port=s.port)
        for i, s in enumerate(stubs)])
    kw.setdefault("scrape_interval_s", 0.05)
    r = Router(backends, port=0, host="127.0.0.1", **kw)
    r.start()
    return r


def _post(port, body, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=timeout)
    conn.request("POST", "/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _counter(name, labels):
    fam = metrics_snapshot().get(name, {"values": {}})["values"]
    return fam.get(labels, 0)


class TestRoutingPolicy:
    """pick_replica in isolation — the pure scoring function."""

    def _views(self, *specs):
        out = []
        for i, (ready, q, a, s) in enumerate(specs):
            out.append(ReplicaView(
                endpoint=ReplicaEndpoint(index=i, host="h", port=i),
                ready=ready, ok=True, queue_depth=q, active=a,
                slots=s))
        return out

    def test_lowest_outstanding_work_per_slot_wins(self):
        views = self._views((True, 4, 8, 8),    # score 1.5
                            (True, 0, 2, 8),    # score 0.25  ← winner
                            (True, 0, 6, 8))    # score 0.75
        assert pick_replica(views).endpoint.index == 1

    def test_queue_depth_dominates_when_slots_full(self):
        views = self._views((True, 9, 8, 8),
                            (True, 1, 8, 8))    # same active, shorter q
        assert pick_replica(views).endpoint.index == 1

    def test_draining_replica_excluded(self):
        views = self._views((False, 0, 0, 8),   # idle but draining
                            (True, 5, 8, 8))
        assert pick_replica(views).endpoint.index == 1

    def test_unscraped_replica_not_routed_blind(self):
        views = self._views((True, 0, 0, 8), (True, 5, 8, 8))
        views[0].ok = False                      # no successful scrape
        assert pick_replica(views).endpoint.index == 1

    def test_exclusion_and_nobody_left(self):
        views = self._views((True, 0, 0, 8), (True, 0, 0, 8))
        assert pick_replica(views, exclude={0}).endpoint.index == 1
        assert pick_replica(views, exclude={0, 1}) is None

    def test_tie_breaks_round_robin(self):
        views = self._views((True, 0, 0, 8), (True, 0, 0, 8))
        picked = {pick_replica(views, rr=r).endpoint.index
                  for r in (0, 1)}
        assert picked == {0, 1}

    def test_warmth_breaks_equal_load_toward_warm_replica(self):
        """Prefix-aware admission: identical load, replica 1 has the
        prompt's prefix cached — it wins regardless of rr."""
        views = self._views((True, 2, 2, 8), (True, 2, 2, 8))
        for r in (0, 1, 2):
            assert pick_replica(views, rr=r,
                                warmth={1: 1.0}).endpoint.index == 1

    def test_warmth_cannot_override_heavy_load_gap(self):
        """Warmth is worth at most one slot's outstanding work — a
        fully-warm but backed-up replica still loses to an idle cold
        one (a cache hit never justifies queueing behind a deep
        backlog)."""
        views = self._views((True, 16, 8, 8),   # score 3.0, warm
                            (True, 0, 0, 8))    # score 0.0, cold
        assert pick_replica(views,
                            warmth={0: 1.0}).endpoint.index == 1

    def test_no_warmth_map_is_the_legacy_policy(self):
        views = self._views((True, 4, 8, 8), (True, 0, 2, 8))
        assert pick_replica(views).endpoint.index == \
            pick_replica(views, warmth={}).endpoint.index == 1


class TestReplicaWarmthTracking:
    def _view(self):
        return ReplicaView(
            endpoint=ReplicaEndpoint(index=0, host="h", port=1),
            ready=True, ok=True)

    def test_longest_prefix_fraction(self):
        from horovod_tpu_torch.serving import prefix_hashes
        v = self._view()
        h = prefix_hashes(list(range(33)), 8)    # 4 full blocks
        v.note_dispatch(h[:2])
        assert v.warmth(h) == 0.5                # blocks 0-1 warm
        assert v.warmth(prefix_hashes([9] * 33, 8)) == 0.0
        v.note_dispatch(h)
        assert v.warmth(h) == 1.0
        assert v.warmth([]) == 0.0               # unhashable prompt

    def test_warmth_is_prefix_not_membership(self):
        """A hash routed here only counts while every EARLIER block
        matches too — mirroring the replica-side longest-prefix
        lookup."""
        from horovod_tpu_torch.serving import prefix_hashes
        v = self._view()
        h = prefix_hashes(list(range(33)), 8)
        v.note_dispatch([h[1]])                  # block 1 without 0
        assert v.warmth(h) == 0.0

    def test_lru_bound(self):
        from horovod_tpu_torch.serving import router as router_mod
        v = self._view()
        v.note_dispatch([bytes([i % 256, i // 256]) for i in
                         range(router_mod._WARMTH_ENTRIES + 50)])
        assert len(v.warm) == router_mod._WARMTH_ENTRIES


class TestRouterHTTP:
    def test_repeat_prompt_sticks_to_warm_replica(self):
        """Prefix-aware routing over HTTP: with two equally-idle
        replicas, the second request for the same (multi-block) prompt
        lands on whichever replica served the first — its prefix cache
        is warm — and the dispatch-warmth counter says so."""
        stubs = [StubReplica(), StubReplica()]
        router = _router(stubs)
        try:
            warm0 = _counter("hvdtpu_fleet_dispatch_warmth_total",
                             'state="warm"')
            prompt = list(range(40))         # 2 full 16-token blocks
            for _ in range(3):
                status, _ = _post(router.port,
                                  {"tokens": prompt,
                                   "max_new_tokens": 2})
                assert status == 200
            served = [len(s.requests) for s in stubs]
            assert sorted(served) == [0, 3]  # all three stuck together
            assert _counter("hvdtpu_fleet_dispatch_warmth_total",
                            'state="warm"') - warm0 == 2
        finally:
            router.shutdown()
            for s in stubs:
                s.stop()

    def test_routes_to_least_loaded_and_completes(self):
        busy = StubReplica(queue_depth=6, active=8)
        idle = StubReplica(queue_depth=0, active=1)
        router = _router([busy, idle])
        try:
            status, body = _post(router.port,
                                 {"tokens": [1, 2, 3],
                                  "max_new_tokens": 5})
            assert status == 200
            assert body["tokens"] == stub_tokens(3, 5)
            assert body["replica"] == 1 and body["retries"] == 0
            assert len(idle.requests) == 1 and not busy.requests
            # the replica saw the router's streaming dialect
            assert idle.requests[0]["stream"] is True
        finally:
            router.shutdown()
            busy.stop()
            idle.stop()

    def test_draining_replica_gets_no_traffic(self):
        draining = StubReplica(ready=False)          # readyz 503
        ready = StubReplica(queue_depth=3, active=8)  # busy but ready
        router = _router([draining, ready])
        try:
            for _ in range(3):
                status, _ = _post(router.port,
                                  {"tokens": [5], "max_new_tokens": 2})
                assert status == 200
            assert not draining.requests
            assert len(ready.requests) == 3
        finally:
            router.shutdown()
            draining.stop()
            ready.stop()

    def test_deadline_expired_is_504_without_retry(self):
        stub = StubReplica()
        router = _router([stub])
        try:
            before = _counter("hvdtpu_fleet_requests_total",
                              'outcome="expired"')
            status, body = _post(router.port,
                                 {"tokens": [1], "max_new_tokens": 4,
                                  "deadline_ms": -1})
            assert status == 504
            assert "deadline" in body["error"]
            assert not stub.requests       # never dispatched, no retry
            assert _counter("hvdtpu_fleet_requests_total",
                            'outcome="expired"') == before + 1
        finally:
            router.shutdown()
            stub.stop()

    def test_failover_before_first_token(self):
        """A dead backend (connection refused) is transparently
        retried on the healthy one — the client sees one clean 200."""
        dead_port = socket.socket()
        dead_port.bind(("127.0.0.1", 0))
        port = dead_port.getsockname()[1]
        dead_port.close()                  # nothing listens here now
        alive = StubReplica(queue_depth=5, active=8)  # worse score
        backends = StaticBackends([
            ReplicaEndpoint(index=0, host="127.0.0.1", port=port),
            ReplicaEndpoint(index=1, host="127.0.0.1",
                            port=alive.port)])
        router = Router(backends, port=0, host="127.0.0.1",
                        scrape_interval_s=0.05)
        # Hand-plant a stale-but-ready view of the dead backend so the
        # router genuinely dispatches to it first (a real crash window:
        # the replica died after the last scrape).
        router._scrape_cycle()
        v = router._views[0]
        v.ready = v.ok = True
        v.queue_depth = v.active = 0.0
        router._http_thread.start()
        try:
            before = _counter("hvdtpu_fleet_failovers_total",
                              'phase="prefill"')
            status, body = _post(router.port,
                                 {"tokens": [7, 8], "max_new_tokens": 3})
            assert status == 200
            assert body["tokens"] == stub_tokens(2, 3)
            assert body["retries"] >= 1
            assert _counter("hvdtpu_fleet_failovers_total",
                            'phase="prefill"') >= before + 1
        finally:
            router._stop.set()
            router._httpd.shutdown()
            router._httpd.server_close()
            alive.stop()

    def test_midstream_death_resumes_seamlessly(self):
        """Replica 0 dies after 3 tokens (stream breaks, no done
        line); the router re-prefills prompt+emitted on replica 1 and
        the client's assembled output is identical to an uncontended
        run."""
        flaky = StubReplica(die_after=3)               # preferred: idle
        backup = StubReplica(queue_depth=2, active=4)
        router = _router([flaky, backup])
        try:
            before = _counter("hvdtpu_fleet_failovers_total",
                              'phase="midstream"')
            status, body = _post(router.port,
                                 {"tokens": [1, 2, 3, 4],
                                  "max_new_tokens": 8})
            assert status == 200
            assert body["tokens"] == stub_tokens(4, 8)   # seamless
            assert body["retries"] >= 1
            # the resume carried prompt+emitted and the REMAINING budget
            resume = backup.requests[-1]
            assert resume["tokens"] == [1, 2, 3, 4] + stub_tokens(4, 3)
            assert resume["max_new_tokens"] == 5
            assert _counter("hvdtpu_fleet_failovers_total",
                            'phase="midstream"') >= before + 1
        finally:
            router.shutdown()
            flaky.stop()
            backup.stop()

    def test_stable_request_id_across_midstream_failover(self):
        """ONE request identity end-to-end
        (docs/serving.md#request-tracing): the id the router ships in
        X-Request-Id on the first dispatch is REUSED — not re-minted —
        on the failover re-dispatch, and comes back to the client in
        the response body. A client-supplied X-Request-Id is honored
        verbatim."""
        flaky = StubReplica(die_after=3)               # preferred: idle
        backup = StubReplica(queue_depth=2, active=4)
        router = _router([flaky, backup])
        try:
            # Router-minted id: same on both hops, returned to client.
            status, body = _post(router.port,
                                 {"tokens": [1, 2, 3],
                                  "max_new_tokens": 8})
            assert status == 200
            assert body["trace_id"]
            assert flaky.request_ids[-1] == body["trace_id"]
            assert backup.request_ids[-1] == body["trace_id"]

            # Client-supplied id: honored verbatim across the failover.
            flaky.die_after = 2
            conn = http.client.HTTPConnection("127.0.0.1", router.port,
                                              timeout=30)
            conn.request("POST", "/generate",
                         json.dumps({"tokens": [5, 6],
                                     "max_new_tokens": 6,
                                     "stream": True}),
                         {"Content-Type": "application/json",
                          "X-Request-Id": "client-chose-this"})
            resp = conn.getresponse()
            lines = [json.loads(ln) for ln in resp.read().splitlines()
                     if ln.strip()]
            assert lines[0]["trace_id"] == "client-chose-this"
            assert lines[-1]["done"] and \
                lines[-1]["trace_id"] == "client-chose-this"
            assert [ln["t"] for ln in lines[1:-1]] == stub_tokens(2, 6)
            # Whichever replicas this hop touched (flaky may still sit
            # in the first failover's exclusion window) saw the
            # client's id, never a re-minted one.
            assert backup.request_ids[-1] == "client-chose-this"
        finally:
            router.shutdown()
            flaky.stop()
            backup.stop()

    def test_midstream_resume_streams_to_client(self):
        """Same failover, but the CLIENT is streaming: the token lines
        it reads across the replica death form the uninterrupted
        sequence, ending in one done line."""
        flaky = StubReplica(die_after=2)
        backup = StubReplica(queue_depth=2, active=4)
        router = _router([flaky, backup])
        try:
            conn = http.client.HTTPConnection("127.0.0.1", router.port,
                                              timeout=30)
            conn.request("POST", "/generate",
                         json.dumps({"tokens": [9, 9, 9],
                                     "max_new_tokens": 6,
                                     "stream": True}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            lines = [json.loads(ln) for ln in resp.read().splitlines()
                     if ln.strip()]
            assert "id" in lines[0]
            toks = [ln["t"] for ln in lines[1:-1]]
            assert toks == stub_tokens(3, 6)
            assert lines[-1]["done"] and \
                lines[-1]["status"] == "completed"
            assert lines[-1]["retries"] >= 1
        finally:
            router.shutdown()
            flaky.stop()
            backup.stop()

    def test_fleet_wide_queue_full_gives_up_with_retry_after(self):
        stubs = [StubReplica(reject=429), StubReplica(reject=429)]
        router = _router([s for s in stubs], max_attempts=3)
        try:
            before = _counter("hvdtpu_fleet_retries_total",
                              'reason="queue_full"')
            status, body = _post(router.port,
                                 {"tokens": [1], "max_new_tokens": 2})
            assert status == 503
            assert _counter("hvdtpu_fleet_retries_total",
                            'reason="queue_full"') > before
        finally:
            router.shutdown()
            for s in stubs:
                s.stop()

    def test_router_health_and_ready_endpoints(self):
        stub = StubReplica(queue_depth=2, active=3)
        router = _router([stub])
        try:
            conn = http.client.HTTPConnection("127.0.0.1", router.port,
                                              timeout=10)
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            h = json.loads(resp.read())
            assert resp.status == 200 and h["ready_replicas"] == 1
            assert h["replicas"][0]["queue_depth"] == 2
            conn.request("GET", "/readyz")
            assert conn.getresponse().status == 200
            stub.ready = False
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                conn.request("GET", "/readyz")
                r = conn.getresponse()
                r.read()
                if r.status == 503:
                    break
                time.sleep(0.05)
            assert r.status == 503
        finally:
            router.shutdown()
            stub.stop()


class TestSessionAffinityRouting:
    """Session pinning (docs/serving.md#session-affinity): the router
    learns which replica holds a session's KV lease — from /healthz
    and from its own completed dispatches — and pins that session's
    next turn there; failover falls back to normal dispatch and the
    lease re-forms on the surviving replica."""

    def _wait_scraped(self, router, pred, timeout=5.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with router._views_lock:
                if pred(router._views):
                    return
            time.sleep(0.02)
        raise AssertionError("scrape never observed the condition")

    def test_session_pins_to_lease_holder_despite_load(self):
        """The advertised lease outweighs a load gap the plain policy
        would never cross: the session's turn lands on the busier
        replica that holds its KV."""
        busy = StubReplica(queue_depth=5, active=8)   # score 1.625
        idle = StubReplica(queue_depth=0, active=1)   # score 0.125
        busy.sessions = ["conv"]
        router = _router([busy, idle])
        try:
            self._wait_scraped(
                router, lambda vs: "conv" in vs[0].sessions)
            status, body = _post(router.port,
                                 {"tokens": [1, 2, 3],
                                  "max_new_tokens": 2,
                                  "session_id": "conv"})
            assert status == 200 and body["replica"] == 0
            # a session-less request still takes the idle replica
            status, body = _post(router.port,
                                 {"tokens": [1, 2, 3],
                                  "max_new_tokens": 2})
            assert status == 200 and body["replica"] == 1
        finally:
            router.shutdown()
            busy.stop()
            idle.stop()

    def test_completed_dispatch_pins_before_next_scrape(self):
        """The router shadows the lease it just created: turn 2 of a
        session sticks to turn 1's replica even with equal load and a
        prompt too short for prefix warmth."""
        stubs = [StubReplica(), StubReplica()]
        router = _router(stubs, scrape_interval_s=60.0)
        try:
            for _ in range(4):
                status, _ = _post(router.port,
                                  {"tokens": [4, 5],
                                   "max_new_tokens": 2,
                                   "session_id": "chat-9"})
                assert status == 200
            served = [len(s.requests) for s in stubs]
            assert sorted(served) == [0, 4]   # all four stuck together
        finally:
            router.shutdown()
            for s in stubs:
                s.stop()

    def test_session_failover_reforms_lease_on_survivor(self):
        """The pinned replica dies mid-stream: the failover resume
        completes the reply token-identically on the survivor (the
        session_id rides the re-dispatch, so the lease re-forms
        there), and the next turn pins to the survivor."""
        flaky = StubReplica(die_after=3)              # preferred: idle
        backup = StubReplica(queue_depth=2, active=4)
        router = _router([flaky, backup])
        try:
            status, body = _post(router.port,
                                 {"tokens": [1, 2, 3, 4],
                                  "max_new_tokens": 8,
                                  "session_id": "conv"})
            assert status == 200
            assert body["tokens"] == stub_tokens(4, 8)   # seamless
            assert body["retries"] >= 1
            resume = backup.requests[-1]
            assert resume["session_id"] == "conv"
            assert backup.sessions == ["conv"]        # lease re-formed
            flaky.die_after = None
            status, body = _post(router.port,
                                 {"tokens": [9, 9],
                                  "max_new_tokens": 2,
                                  "session_id": "conv"})
            assert status == 200 and body["replica"] == 1
        finally:
            router.shutdown()
            flaky.stop()
            backup.stop()

    def test_header_spelling_reaches_replica(self):
        stub = StubReplica()
        router = _router([stub])
        try:
            conn = http.client.HTTPConnection("127.0.0.1", router.port,
                                              timeout=30)
            conn.request("POST", "/generate",
                         json.dumps({"tokens": [1],
                                     "max_new_tokens": 2}),
                         {"Content-Type": "application/json",
                          "X-Session-Id": "hdr-sess"})
            assert conn.getresponse().status == 200
            assert stub.requests[-1]["session_id"] == "hdr-sess"
        finally:
            router.shutdown()
            stub.stop()




def _random_views(router_mod, fleet_mod, seed):
    """Seeded views (readiness, scrape state, load, slots, interactive
    backlog), exclusions, a round-robin count, warmth and a QoS class."""
    rs = np.random.RandomState(seed)
    views = []
    for i in range(int(rs.randint(1, 7))):
        v = router_mod.ReplicaView(
            endpoint=fleet_mod.ReplicaEndpoint(index=i, host="h",
                                               port=1000 + i),
            ready=bool(rs.uniform() < 0.8), ok=bool(rs.uniform() < 0.9),
            queue_depth=float(rs.randint(0, 4)), active=float(rs.randint(0, 4)),
            slots=float(rs.choice([1, 2, 4, 8])))
        if rs.uniform() < 0.5:
            v.qos_classes = {"interactive": {
                "active": int(rs.randint(0, 3)),
                "queued": int(rs.randint(0, 3))}}
        views.append(v)
    exclude = {i for i in range(len(views)) if rs.uniform() < 0.2}
    warmth = {i: float(rs.choice([0.0, 0.5, 1.0, 2.0]))
              for i in range(len(views)) if rs.uniform() < 0.5}
    qos_class = [None, "interactive", "bulk"][int(rs.randint(0, 3))]
    return views, exclude, int(rs.randint(0, 10)), warmth, qos_class


@pytest.mark.parametrize("seed", range(24))
def test_pick_replica_picks_as_jax(seed):
    tv, ex, rr, warmth, cls = _random_views(trouter, tfleet, seed)
    jv, _, _, _, _ = _random_views(jrouter, jfleet, seed)
    got = pick_replica(tv, exclude=ex, rr=rr, warmth=warmth, qos_class=cls)
    want = jrouter.pick_replica(jv, exclude=ex, rr=rr, warmth=warmth,
                                qos_class=cls)
    assert (got and got.endpoint.index) == (want and want.endpoint.index)
