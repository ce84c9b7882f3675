"""HMAC-authenticated pickle RPC over TCP — the launcher's control wire.

Counterpart of ``horovod_tpu/runner/network.py``, copied.

Parity: horovod/spark/util/network.py (reference :44-142). The reference
wraps socket streams in an HMAC check before cloudpickle-deserializing
requests; a ``BasicService`` dispatches request objects to handlers and a
``BasicClient`` sends them with retries. This is the same design with an
explicit length-prefixed frame:

    [4-byte big-endian payload length][32-byte HMAC-SHA256(key, payload)][payload]

The digest is verified *before* unpickling — unauthenticated bytes are never
deserialized (the reference's ``check_digest`` wrapper, network.py:44-79).
"""

from __future__ import annotations

import hashlib
import hmac
import pickle
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

_LEN = struct.Struct(">I")
_DIGEST_BYTES = hashlib.sha256().digest_size
_MAX_FRAME = 1 << 30


class AuthenticationError(RuntimeError):
    """A frame failed HMAC verification (wrong or missing secret key)."""


class Wire:
    """Frame codec over a connected socket."""

    def __init__(self, key: bytes):
        self._key = key

    def write(self, sock: socket.socket, obj: Any) -> None:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        digest = hmac.new(self._key, payload, hashlib.sha256).digest()
        sock.sendall(_LEN.pack(len(payload)) + digest + payload)

    def read(self, sock: socket.socket) -> Any:
        header = self._read_exact(sock, _LEN.size + _DIGEST_BYTES)
        (n,) = _LEN.unpack(header[:_LEN.size])
        if n > _MAX_FRAME:
            raise AuthenticationError(f"oversized frame ({n} bytes)")
        digest = header[_LEN.size:]
        payload = self._read_exact(sock, n)
        expected = hmac.new(self._key, payload, hashlib.sha256).digest()
        if not hmac.compare_digest(digest, expected):
            raise AuthenticationError(
                "HMAC verification failed; refusing to deserialize")
        return pickle.loads(payload)

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("connection closed mid-frame")
            buf.extend(chunk)
        return bytes(buf)


class PingRequest:
    pass


class PingResponse:
    pass


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        service: "BasicService" = self.server.service  # type: ignore
        wire = service._wire
        sock = self.request
        sock.settimeout(service.conn_timeout)
        try:
            while True:
                try:
                    req = wire.read(sock)
                except (ConnectionError, socket.timeout, OSError):
                    return
                except AuthenticationError:
                    return  # drop unauthenticated peers silently
                resp = service._dispatch(req, self.client_address)
                wire.write(sock, resp)
        except (ConnectionError, BrokenPipeError, OSError):
            return


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def routable_addresses(
        probes: Tuple[str, ...] = ("8.8.8.8", "10.255.255.255"),
) -> List[str]:
    """Candidate non-loopback addresses other hosts may reach us on.

    Combines hostname resolution with the UDP-connect trick (no packet is
    sent; the kernel's route selection picks the outbound interface per
    probe target). Multiple probe targets matter: on a host with a VPN or
    overlay route covering 10.0.0.0/8, the 10.x probe resolves to the
    tunnel IP while 8.8.8.8 resolves to the LAN IP — every candidate is
    returned so peers can pick the one they can actually dial (the
    reference probes all NICs for the same reason, network.py:93-107)."""
    out: List[str] = []

    def _add(ip: str) -> None:
        if ip and not ip.startswith("127.") and ip not in out:
            out.append(ip)

    try:
        for info in socket.getaddrinfo(socket.gethostname(), None,
                                       socket.AF_INET):
            _add(info[4][0])
    except OSError:
        pass
    for probe in probes:
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.connect((probe, 1))
                _add(s.getsockname()[0])
        except OSError:
            continue
    return out


class BasicService:
    """Threaded TCP service dispatching authenticated request objects.

    Subclasses override :meth:`_handle`. Mirrors the reference's
    ``network.BasicService`` (spark/util/network.py:81-142).
    """

    conn_timeout = 3600.0

    def __init__(self, name: str, key: bytes, host: str = "0.0.0.0",
                 port: int = 0):
        self.name = name
        self._wire = Wire(key)
        self._server = _Server((host, port), _Handler)
        self._server.service = self  # type: ignore[attr-defined]
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=f"{name}-rpc",
            daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._port

    def addresses(self) -> List[Tuple[str, int]]:
        """All (ip, port) pairs this service answers on — the reference
        collects every NIC's address so the driver can find a mutually
        routable interface (network.py:93-107).

        ``getaddrinfo(gethostname())`` alone is not enough: Debian-style
        /etc/hosts maps the hostname to 127.0.1.1, leaving only loopback
        candidates. The UDP-connect trick recovers the outbound interface's
        address without sending a packet (kernel route selection only)."""
        addrs = [("127.0.0.1", self._port)]
        for ip in routable_addresses():
            if (ip, self._port) not in addrs:
                addrs.append((ip, self._port))
        return addrs

    def _dispatch(self, req: Any, client_address) -> Any:
        if isinstance(req, PingRequest):
            return PingResponse()
        return self._handle(req, client_address)

    def _handle(self, req: Any, client_address) -> Any:
        raise NotImplementedError(f"{self.name}: unknown request {req!r}")

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class BasicClient:
    """RPC client with retries (network.py:~150+).

    The connection is persistent: the server handler loops over framed
    requests on one socket, so keeping it open avoids per-call TCP
    setup/teardown and handler-thread churn (the eager engine issues RPCs
    every ~1 ms cycle). Reconnects transparently on failure. Thread-safe:
    one in-flight request at a time per client.
    """

    def __init__(self, addresses, key: bytes, attempts: int = 3,
                 timeout: float = 60.0,
                 connect_attempts: Optional[int] = None):
        """``connect_attempts`` applies only until the FIRST successful
        connection (rendezvous patience — the peer may come up seconds
        later); once connected, failures retry ``attempts`` times so a
        dead peer surfaces fast instead of being masked for minutes."""
        if isinstance(addresses, tuple) and len(addresses) == 2 \
                and isinstance(addresses[0], str):
            addresses = [addresses]
        self._addresses: List[Tuple[str, int]] = list(addresses)
        self._wire = Wire(key)
        self._attempts = attempts
        self._connect_attempts = (connect_attempts
                                  if connect_attempts is not None
                                  else attempts)
        self._ever_connected = False
        self._timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._mu = threading.Lock()

    def _connect(self) -> socket.socket:
        last: Optional[Exception] = None
        for host, port in self._addresses:
            try:
                sock = socket.create_connection((host, port),
                                                timeout=self._timeout)
                sock.settimeout(self._timeout)
                return sock
            except (OSError, ConnectionError) as e:
                last = e
        raise ConnectionError(
            f"could not reach service at {self._addresses}: {last}")

    def close(self) -> None:
        with self._mu:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    def request(self, req: Any) -> Any:
        last: Optional[Exception] = None
        with self._mu:
            # Rendezvous patience is a wall-clock deadline, not an attempt
            # count: dropped SYNs block each connect() for up to the full
            # socket timeout, so counting attempts would multiply that
            # into hours. ~0.2 s/attempt of refused-connection pacing sets
            # the budget; once connected, the short attempt count governs.
            deadline = (None if self._ever_connected
                        else time.monotonic() + 0.2 * self._connect_attempts)
            attempt = 0
            while True:
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                        self._ever_connected = True
                        deadline = None
                    self._wire.write(self._sock, req)
                    return self._wire.read(self._sock)
                except (OSError, ConnectionError) as e:
                    last = e
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                    attempt += 1
                    if deadline is not None:
                        if time.monotonic() > deadline:
                            break
                    elif attempt >= self._attempts:
                        break
                    time.sleep(0.2)
        raise ConnectionError(
            f"could not reach service at {self._addresses}: {last}")

    def ping(self) -> bool:
        try:
            return isinstance(self.request(PingRequest()), PingResponse)
        except ConnectionError:
            return False


def find_free_port(host: str = "") -> int:
    """Ask the OS for an ephemeral port (used for the rendezvous store)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]
