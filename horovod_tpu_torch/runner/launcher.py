"""Process launcher — the ``mpirun`` of the port.

Counterpart of ``horovod_tpu/runner/launcher.py``. The reference
launches ranks with bare ``mpirun -H host:slots`` (docs/running.md:1-45)
or through Spark executors bridged by an rsh agent
(horovod/spark/__init__.py:160-178, driver/mpirun_rsh.py:24-37). Here
the launcher itself spawns the workers:

  - slots are parsed from ``-H host1:2,host2:2`` (mpirun's syntax) or
    default to ``localhost:np``;
  - local slots become subprocesses; remote slots become ``ssh``
    commands (the orted/rsh role);
  - every worker gets the ``torch.distributed`` rendezvous through the
    environment variables :func:`horovod_tpu_torch.init` reads (the
    MPI_Init equivalent);
  - output is streamed with ``[rank]<stdout>:`` prefixes and the whole
    job is torn down fail-fast when any rank dies (safe_shell_exec
    semantics).

What differs from JAX's: the environment is torch's (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) instead of the JAX coordinator's, and there is no
separate control-plane port: the collective engine negotiates over a
gloo group of the same rendezvous.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .network import find_free_port, routable_addresses
from .safe_exec import ManagedProcess

_LOCAL_NAMES = {"localhost", "127.0.0.1", "::1"}

# The process that launched this one (set for every rank): a launched
# process may watch it and exit with it (safe_exec.start_parent_watchdog).
LAUNCHER_PID_ENV = "HOROVOD_TPU_LAUNCHER_PID"

# The rendezvous keys every rank gets, forwarded across an ssh hop too.
TORCH_ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT")

# The root that holds the ``horovod_tpu_torch`` package.
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_hosts(hosts: str) -> List[Tuple[str, int]]:
    """Parse mpirun-style ``host:slots[,host:slots...]``."""
    out: List[Tuple[str, int]] = []
    for part in hosts.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            host, slots = part.rsplit(":", 1)
            out.append((host, int(slots)))
        else:
            out.append((part, 1))
    return out


def expand_slots(host_slots: Sequence[Tuple[str, int]], np: int
                 ) -> List[str]:
    """One host entry per rank, hosts grouped contiguously (ranks on the
    same host are adjacent — the reference orders hosts the same way,
    spark/__init__.py:123-152)."""
    ranks: List[str] = []
    for host, slots in host_slots:
        ranks.extend([host] * slots)
    if len(ranks) < np:
        raise ValueError(
            f"host list provides {len(ranks)} slots but -np is {np}")
    return ranks[:np]


def is_local_host(host: str) -> bool:
    if host in _LOCAL_NAMES:
        return True
    try:
        return host == socket.gethostname()
    except OSError:
        return False


def routable_local_address() -> str:
    """Best-effort address OTHER hosts can reach this machine on (the
    reference eliminates non-routable NAT/loopback interfaces the same
    way, spark/__init__.py:134-159). Delegates to the shared probe in
    :mod:`.network`; first candidate wins."""
    candidates = routable_addresses()
    if candidates:
        return candidates[0]
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _ssh_spawn_spec(host: str, env: Dict[str, str], args: List[str],
                    extra_keys: Sequence[str] = ()
                    ) -> Tuple[List[str], bytes]:
    """Remote spawn via ssh — the rsh-agent role (mpirun_rsh.py:24-37).

    Returns (ssh argv, stdin payload). Env and command are shipped as one
    JSON line over ssh's stdin to :mod:`.remote_bootstrap`: no shell
    quoting pitfalls, and the HMAC secret stays off the remote argv.
    The rendezvous keys, HOROVOD_TPU_*/NCCL_*/TORCH_* env plus every
    caller-supplied ``extra_env`` key is forwarded across the hop, so
    the ``run(fn, extra_env=...)`` contract holds on remote workers
    too."""
    import json
    fwd = {k: v for k, v in env.items()
           if k.startswith(("HOROVOD_TPU_", "NCCL_", "TORCH_"))
           or k in TORCH_ENV_KEYS or k in extra_keys}
    payload = json.dumps({"env": fwd, "cmd": args}).encode() + b"\n"
    argv = ["ssh", "-o", "StrictHostKeyChecking=no", host,
            "python3", "-m", "horovod_tpu_torch.runner.remote_bootstrap"]
    return argv, payload


def _probe_remote_ports(host: str, ports: List[int],
                        timeout: float = 20.0) -> Optional[List[int]]:
    """Bind-check ``ports`` on ``host`` via the bootstrap's --probe mode.
    Returns the free subset, or None when the probe could not run (no
    ssh / no python on the remote) — callers then fall back to a blind
    pick, the pre-probe behavior."""
    import json as _json
    import subprocess
    argv = (["ssh", "-o", "StrictHostKeyChecking=no", host, "python3",
             "-m", "horovod_tpu_torch.runner.remote_bootstrap", "--probe"]
            + [str(p) for p in ports])
    try:
        out = subprocess.run(argv, capture_output=True, timeout=timeout)
        if out.returncode != 0:
            return None
        return list(_json.loads(out.stdout.decode().strip())["free"])
    except Exception:
        return None


def _pick_remote_port(host: str, master_port: Optional[int]) -> int:
    """Choose the rendezvous port for a remote rank-0 host, probing
    candidates over ssh. A pinned ``master_port`` that turns out busy
    raises with a message naming the knob."""
    import random
    rnd = random.SystemRandom()
    for _ in range(3):
        port = (master_port if master_port is not None
                else rnd.randrange(20000, 60000))
        free = _probe_remote_ports(host, [port])
        if free is None or port in free:
            return port   # free, or the probe is unavailable: blind pick
        if master_port is not None:
            raise RuntimeError(
                f"master_port {master_port} is already in use on {host}; "
                "pick a different master_port or free the port")
    raise RuntimeError(
        f"could not find a free rendezvous port on {host} after 3 probe "
        "attempts; pass master_port to pin a known-free one")


class LaunchedJob:
    def __init__(self, workers: List[ManagedProcess]):
        self.workers = workers

    def failfast_check(self) -> None:
        """Raise if any worker exited nonzero (and kill the rest)."""
        for rank, w in enumerate(self.workers):
            rc = w.poll()
            if rc is not None and rc != 0:
                self.terminate()
                raise RuntimeError(
                    f"worker rank {rank} exited with code {rc}")

    def wait(self, timeout: Optional[float] = None) -> int:
        """Wait for all workers; fail-fast on the first nonzero exit.
        Returns 0 on full success."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rcs = [w.poll() for w in self.workers]
            for rank, rc in enumerate(rcs):
                if rc is not None and rc != 0:
                    self.terminate()
                    self._drain()
                    return rc
            if all(rc == 0 for rc in rcs):
                self._drain()
                return 0
            if deadline is not None and time.monotonic() > deadline:
                self.terminate()
                self._drain()
                raise TimeoutError("job did not finish in time")
            time.sleep(0.1)

    def _drain(self) -> None:
        """Join output pumps of exited workers so their last lines are
        flushed before the launcher returns (poll() can report exit while
        output still sits in the pipe buffer)."""
        for w in self.workers:
            if w.poll() is not None:
                try:
                    w.wait(timeout=5.0)
                except Exception:
                    pass

    def terminate(self) -> None:
        for w in self.workers:
            w.terminate()

    def signal(self, sig: int, ranks: Optional[Sequence[int]] = None
               ) -> None:
        """Send ``sig`` to the process group of each live worker of
        ``ranks`` (all by default) and return: a SIGTERM forwarded so,
        unlike :meth:`terminate`, lets a worker drain on its own time."""
        for rank, w in enumerate(self.workers):
            if (ranks is None or rank in ranks) and w.poll() is None:
                try:
                    os.killpg(w.proc.pid, sig)
                except (ProcessLookupError, PermissionError):
                    pass


def launch(command: List[str], np: int, hosts: Optional[str] = None,
           extra_env: Optional[Dict[str, str]] = None,
           stdout=None, stderr=None, tag_output: bool = True,
           master_port: Optional[int] = None) -> LaunchedJob:
    """Spawn ``np`` copies of ``command`` with the distributed env wired up.

    Env contract consumed by :func:`horovod_tpu_torch.init`
    (``topology.py``) and by ``torch.distributed``'s ``env://``
    rendezvous:
      MASTER_ADDR, MASTER_PORT   rank 0's host and its store's port
      WORLD_SIZE, RANK           world size, this worker's rank
      LOCAL_WORLD_SIZE           ranks on this worker's host
      LOCAL_RANK                 rank within its host (the card it takes)
    Also:
      HOROVOD_TPU_SECRET_KEY     HMAC key of the launcher's RPC (created
                                 here unless the caller already set one)
      HOROVOD_TPU_LAUNCHER_PID   this process, for a parent watchdog
      PYTHONPATH                 led by the root holding the package
    """
    host_slots = parse_hosts(hosts) if hosts else [("localhost", np)]
    rank_hosts = expand_slots(host_slots, np)
    any_remote = any(not is_local_host(h) for h in rank_hosts)

    # The rendezvous store binds on rank 0's host. All-local jobs use
    # loopback; once any worker is remote, loopback is unreachable from
    # it, so advertise a routable address of rank 0's machine instead
    # (the launcher's own when rank 0 is local).
    first_host = rank_hosts[0]
    if not any_remote:
        master_host = "127.0.0.1"
    elif is_local_host(first_host):
        master_host = routable_local_address()
    else:
        master_host = first_host
    if is_local_host(first_host):
        # Probing only tells us the port is free HERE — valid exactly
        # when the store binds here.
        port = master_port if master_port is not None else find_free_port()
    else:
        # Rank 0 binds on a remote machine: verify the candidate over
        # the ssh hop (remote_bootstrap --probe) before committing, so a
        # collision fails HERE with a clear message.
        port = _pick_remote_port(first_host, master_port)

    # The RPC plane authenticates with a shared HMAC key (secret.py,
    # reference spark/util/secret.py:21-36); mint one per launch unless
    # the caller (e.g. api.run) already provided it.
    from .secret import SECRET_ENV, encode_key, make_secret_key
    secret = ((extra_env or {}).get(SECRET_ENV)
              or os.environ.get(SECRET_ENV) or encode_key(make_secret_key()))

    local_sizes: Dict[str, int] = {}
    for host in rank_hosts:
        local_sizes[host] = local_sizes.get(host, 0) + 1
    extra_keys = tuple(extra_env.keys()) if extra_env else ()
    workers: List[ManagedProcess] = []
    local_counts: Dict[str, int] = {}
    for rank, host in enumerate(rank_hosts):
        env = dict(os.environ)
        if extra_env:
            env.update(extra_env)
        # Local workers must import the package (and task_exec) whatever
        # the caller's cwd. Remote hosts need the package installed;
        # PYTHONPATH is not shipped there.
        prev_pp = env.get("PYTHONPATH", "")
        if _PKG_ROOT not in prev_pp.split(os.pathsep):
            env["PYTHONPATH"] = (f"{_PKG_ROOT}{os.pathsep}{prev_pp}"
                                 if prev_pp else _PKG_ROOT)
        local_rank = local_counts.get(host, 0)
        local_counts[host] = local_rank + 1
        env.update({"MASTER_ADDR": master_host, "MASTER_PORT": str(port),
                    "WORLD_SIZE": str(np), "RANK": str(rank),
                    "LOCAL_WORLD_SIZE": str(local_sizes[host]),
                    "LOCAL_RANK": str(local_rank)})
        env[SECRET_ENV] = secret
        env[LAUNCHER_PID_ENV] = str(os.getpid())

        prefix = f"[{rank}]" if tag_output else None
        if is_local_host(host):
            workers.append(ManagedProcess(list(command), env, prefix=prefix,
                                          stdout=stdout, stderr=stderr))
        else:
            args, stdin_data = _ssh_spawn_spec(host, env, list(command),
                                               extra_keys)
            workers.append(ManagedProcess(args, env, prefix=prefix,
                                          stdout=stdout, stderr=stderr,
                                          stdin_data=stdin_data))
    return LaunchedJob(workers)


def watch_launcher() -> bool:
    """In a process this launcher started: exit with the launcher (a
    parent watchdog, :func:`.safe_exec.start_parent_watchdog`). True
    when the watchdog runs; False in a process nobody launched."""
    if os.environ.get(LAUNCHER_PID_ENV) != str(os.getppid()):
        return False
    from .safe_exec import start_parent_watchdog
    start_parent_watchdog()
    return True
