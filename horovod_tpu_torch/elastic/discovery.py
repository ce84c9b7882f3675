"""Worker discovery — the ``HostProvider`` interface and its backends.

Counterpart of ``horovod_tpu/elastic/discovery.py``, copied (logging
through ``logging.getLogger(__name__)``).

This closes the launcher's cluster-manager gap (SURVEY M7): the
reference's L4 rides a real cluster manager — Spark executors announce
themselves to the driver and mpirun is bridged through them
(horovod/spark/__init__.py:80-196, driver/driver_service.py). The
TPU-native analogue of "run on my cluster" is *discovering* the pod's
worker hosts and feeding them to the existing ssh/RPC launch plane
(:mod:`horovod_tpu_torch.runner.launcher`), which already knows how to spawn
local/ssh ranks once it has a host list.

Three backends:

  - :class:`HostfileProvider` — a static hostfile (mpirun's ``-hostfile``
    syntax: ``host slots=N`` / ``host:N`` / bare host). Re-read on every
    ``discover()`` call so an elastic job can grow when the operator adds
    replacement hosts.
  - :class:`SSHProbeProvider` — candidate hosts filtered by an ssh
    reachability probe (the rsh-agent liveness check); a host that stops
    answering ssh disappears from the discovered set.
  - :class:`TPUPodProvider` — GCE metadata server discovery for Cloud TPU
    pods: every TPU VM exposes the pod's worker endpoints under
    ``computeMetadata/v1/instance/attributes/worker-network-endpoints``.
    The metadata base address comes from ``HOROVOD_TPU_METADATA_ADDR``
    so tests (and non-GCP environments) can point it at a fake server —
    no real GCP dependency anywhere in the code path.

Every provider returns ``[(host, slots), ...]`` — the launcher's
``parse_hosts`` shape — and is intentionally *re-entrant*: elastic
recovery calls ``discover()`` again after every membership change.
"""

from __future__ import annotations

import logging
import os
import subprocess
import threading
from typing import Callable, List, Optional, Sequence, Tuple

_log = logging.getLogger(__name__)

HostSlots = List[Tuple[str, int]]

METADATA_ADDR_ENV = "HOROVOD_TPU_METADATA_ADDR"
DEFAULT_METADATA_ADDR = "http://metadata.google.internal"
# The attribute every Cloud TPU VM carries: comma-separated worker
# endpoints, each ``uid:ip:port`` (older stacks ship bare ``ip``).
WORKER_ENDPOINTS_PATH = (
    "/computeMetadata/v1/instance/attributes/worker-network-endpoints")


class HostProvider:
    """Source of the job's current worker host list.

    ``discover()`` returns the *currently available* ``(host, slots)``
    pairs; elastic drivers call it repeatedly, so implementations must
    reflect membership changes (lost hosts vanish, replacements appear)
    rather than caching the first answer forever.
    """

    def discover(self) -> HostSlots:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class StaticProvider(HostProvider):
    """A fixed host list (the non-elastic ``-H host:slots`` path lifted
    into the provider interface so one code path serves both)."""

    def __init__(self, host_slots: Sequence[Tuple[str, int]]):
        self._host_slots = [(h, int(s)) for h, s in host_slots]

    def discover(self) -> HostSlots:
        return list(self._host_slots)

    def describe(self) -> str:
        return "static:" + ",".join(f"{h}:{s}" for h, s in self._host_slots)


class HostfileProvider(HostProvider):
    """mpirun-style hostfile, re-read per discovery.

    Accepted line forms (comments with ``#`` and blank lines ignored)::

        host1 slots=2
        host2:2
        host3
    """

    def __init__(self, path: str):
        self.path = path

    def discover(self) -> HostSlots:
        out: HostSlots = []
        with open(self.path) as f:
            for raw in f:
                line = raw.split("#", 1)[0].strip()
                if not line:
                    continue
                slots = 1
                if "slots=" in line:
                    host, _, rest = line.partition(" ")
                    for tok in rest.split():
                        if tok.startswith("slots="):
                            slots = int(tok.split("=", 1)[1])
                    host = host.strip()
                elif ":" in line:
                    host, s = line.rsplit(":", 1)
                    slots = int(s)
                else:
                    host = line
                out.append((host, slots))
        return out

    def describe(self) -> str:
        return f"hostfile:{self.path}"


def _ssh_alive(host: str, connect_timeout: float = 5.0) -> bool:
    """One reachability probe: can we run ``true`` on the host?
    BatchMode forbids password prompts (a dead host must fail, not
    hang on interactive auth)."""
    try:
        rc = subprocess.run(
            ["ssh", "-o", "BatchMode=yes", "-o", "StrictHostKeyChecking=no",
             "-o", f"ConnectTimeout={int(connect_timeout)}", host, "true"],
            capture_output=True, timeout=connect_timeout + 10).returncode
        return rc == 0
    except Exception:
        return False


def host_alive(host: str, connect_timeout: float = 5.0) -> bool:
    """Readmission probe (docs/adaptation.md): is ``host`` worth
    offering slots on again? Local names are trivially alive (the
    launcher spawns plain subprocesses there); remote ones get the ssh
    reachability probe. Used by the elastic driver's blacklist expiry
    so an evicted-then-recovered host grows back in, while a
    still-dead one has its penalty renewed with backoff."""
    from ..runner.launcher import is_local_host
    return is_local_host(host) or _ssh_alive(host, connect_timeout)


class SSHProbeProvider(HostProvider):
    """Candidate hosts filtered to the ssh-reachable subset.

    Probes run concurrently (a 32-host pod must not pay 32 sequential
    connect timeouts when half the hosts are down). Local names skip the
    probe — the launcher spawns those as plain subprocesses. ``probe``
    is injectable for tests."""

    def __init__(self, host_slots: Sequence[Tuple[str, int]],
                 connect_timeout: float = 5.0,
                 probe: Optional[Callable[[str], bool]] = None):
        self._host_slots = [(h, int(s)) for h, s in host_slots]
        self._timeout = connect_timeout
        self._probe = probe

    def discover(self) -> HostSlots:
        from ..runner.launcher import is_local_host
        probe = self._probe or (
            lambda h: _ssh_alive(h, self._timeout))
        alive: dict = {}
        threads = []

        def check(host):
            alive[host] = is_local_host(host) or probe(host)

        for host, _ in self._host_slots:
            t = threading.Thread(target=check, args=(host,), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(self._timeout + 15.0)
        out = [(h, s) for h, s in self._host_slots if alive.get(h)]
        dead = [h for h, _ in self._host_slots if not alive.get(h)]
        if dead:
            _log.warning("ssh probe dropped unreachable hosts: %s",
                         ", ".join(dead))
        return out

    def describe(self) -> str:
        return "ssh:" + ",".join(f"{h}:{s}" for h, s in self._host_slots)


def _parse_worker_endpoints(text: str) -> List[str]:
    """Parse the ``worker-network-endpoints`` attribute value.

    Observed forms per entry (comma-separated): ``uid:ip:port``,
    ``ip:port``, and bare ``ip``. The host is the field that the rest of
    the entry qualifies — second of three, first of two, only of one."""
    hosts: List[str] = []
    for entry in text.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) >= 3:
            host = parts[1]
        else:
            host = parts[0]
        host = host.strip()
        if host and host not in hosts:
            hosts.append(host)
    return hosts


class TPUPodProvider(HostProvider):
    """Cloud TPU pod discovery through the GCE metadata server.

    Fetches ``worker-network-endpoints`` from the instance metadata (the
    attribute the TPU runtime itself uses to wire pod workers) and
    returns one entry per worker VM. ``slots_per_host`` defaults to 1
    (``HOROVOD_TPU_SLOTS_PER_HOST``), as JAX's: there one process
    drives all of a host's chips; here one process drives one card, so
    a host of N cards is N slots.

    The metadata address is ``HOROVOD_TPU_METADATA_ADDR`` (default the
    real GCE server); tests point it at a local fake HTTP server, so the
    full code path — HTTP fetch, header, parsing — runs with no GCP."""

    def __init__(self, metadata_addr: Optional[str] = None,
                 slots_per_host: Optional[int] = None,
                 timeout: float = 10.0):
        self.metadata_addr = (
            metadata_addr or os.environ.get(METADATA_ADDR_ENV)
            or DEFAULT_METADATA_ADDR).rstrip("/")
        self.slots_per_host = int(
            slots_per_host
            if slots_per_host is not None
            else os.environ.get("HOROVOD_TPU_SLOTS_PER_HOST", 1))
        self.timeout = timeout

    def _fetch(self, path: str) -> str:
        import urllib.request
        req = urllib.request.Request(
            self.metadata_addr + path,
            headers={"Metadata-Flavor": "Google"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read().decode("utf-8", "replace")

    def discover(self) -> HostSlots:
        try:
            text = self._fetch(WORKER_ENDPOINTS_PATH)
        except Exception as e:
            raise RuntimeError(
                f"TPU-pod discovery failed: could not read "
                f"{WORKER_ENDPOINTS_PATH} from {self.metadata_addr} "
                f"({e}). Outside a TPU VM, set {METADATA_ADDR_ENV} to a "
                "metadata endpoint or use --discovery hostfile/ssh."
            ) from e
        hosts = _parse_worker_endpoints(text)
        if not hosts:
            raise RuntimeError(
                "TPU-pod discovery returned no worker endpoints "
                f"(attribute value: {text!r})")
        return [(h, self.slots_per_host) for h in hosts]

    def describe(self) -> str:
        return f"tpu-pod:{self.metadata_addr}"


def get_provider(discovery: Optional[str] = None,
                 hosts: Optional[str] = None,
                 hostfile: Optional[str] = None,
                 metadata_addr: Optional[str] = None,
                 slots_per_host: Optional[int] = None) -> HostProvider:
    """Resolve a provider from CLI/API arguments.

    ``discovery`` ∈ {None, 'hostfile', 'ssh', 'tpu-pod'}; with None a
    ``hosts`` string (mpirun ``-H`` syntax) becomes a StaticProvider and
    no hosts at all means localhost."""
    from ..runner.launcher import parse_hosts
    if discovery in (None, "", "static"):
        if hostfile:
            return HostfileProvider(hostfile)
        if hosts:
            return StaticProvider(parse_hosts(hosts))
        return StaticProvider([("localhost", os.cpu_count() or 1)])
    if discovery == "hostfile":
        if not hostfile:
            raise ValueError("--discovery hostfile requires --hostfile PATH")
        return HostfileProvider(hostfile)
    if discovery == "ssh":
        if not hosts:
            raise ValueError(
                "--discovery ssh requires -H/--hosts candidates to probe")
        return SSHProbeProvider(parse_hosts(hosts))
    if discovery == "tpu-pod":
        return TPUPodProvider(metadata_addr=metadata_addr,
                              slots_per_host=slots_per_host)
    raise ValueError(
        f"unknown discovery backend {discovery!r} "
        "(expected hostfile, ssh, or tpu-pod)")
