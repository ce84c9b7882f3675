"""Remote worker bootstrap
(``python -m horovod_tpu_torch.runner.remote_bootstrap``).

Counterpart of ``horovod_tpu/runner/remote_bootstrap.py``, copied.

The rsh/orted hop of the stack (reference: horovod/spark/driver/
mpirun_rsh.py:24-37 bridging orted launches through remote agents). The
launcher ssh-es to the host and pipes ONE JSON line on stdin:

    {"env": {...}, "cmd": ["python", "train.py", ...]}

Env (including the HMAC secret) and command travel over ssh's encrypted
stdin rather than the remote argv, so values with spaces survive and
secrets never show up in ``ps`` output. The child is exec'd directly —
no shell interprets any of it.

Probe mode (``--probe PORT [PORT ...]``): bind-checks the given ports on
this host and prints one JSON line ``{"free": [...], "busy": [...]}``.
The launcher uses this before starting a job whose rank 0 is remote, so
the rendezvous port is verified free on the machine that will
actually bind them instead of being drawn blind from the high range.
"""

from __future__ import annotations

import json
import os
import socket
import sys


def probe_ports(ports) -> dict:
    """Try binding each port on all interfaces; report free vs busy."""
    free, busy = [], []
    for p in ports:
        p = int(p)
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
                # No SO_REUSEADDR: a TIME_WAIT remnant should count as
                # busy — the coordinator binds immediately after this.
                s.bind(("", p))
            free.append(p)
        except OSError:
            busy.append(p)
    return {"free": free, "busy": busy}


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--probe":
        print(json.dumps(probe_ports(sys.argv[2:])), flush=True)
        return 0
    line = sys.stdin.readline()
    spec = json.loads(line)
    env = dict(os.environ)
    env.update(spec["env"])
    cmd = spec["cmd"]
    os.execvpe(cmd[0], cmd, env)
    return 127  # unreachable


if __name__ == "__main__":
    sys.exit(main())
