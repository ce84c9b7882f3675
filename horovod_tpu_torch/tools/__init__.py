"""Offline analysis tools of the port (``python -m
horovod_tpu_torch.tools.<name>``), counterparts of ``horovod_tpu.tools``:

- :mod:`.postmortem` — merge per-rank flight-recorder dumps and name the
  rank that went first, its phase and the first divergent group;
- :mod:`.trace` — merge per-rank timelines onto rank 0's clock, the
  per-group critical path and straggler report, and the serving
  request-trace budget;
- :mod:`.health` — the fleet health report over the history files, and
  its baseline A/B;
- :mod:`.slo` — goodput against offered load over loadgen runs.

Importing this package imports none of them.
"""

import subprocess
import sys
import time


def run(name, *argv, timeout=300):
    """``python -m horovod_tpu_torch.tools.<name> ARGV`` in a subprocess:
    (exit code, stdout, stderr, host seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"horovod_tpu_torch.tools.{name}", *argv],
        capture_output=True, text=True, timeout=timeout)
    return (proc.returncode, proc.stdout, proc.stderr,
            time.perf_counter() - t0)
