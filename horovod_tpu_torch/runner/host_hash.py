"""Host identity hashing for slot grouping.

Counterpart of ``horovod_tpu/runner/host_hash.py``, copied.

Parity: horovod/spark/util/host_hash.py (reference :15-36) — tasks on the
same physical host must be grouped so ranks land contiguously per host (the
reference feeds ``-H host_hash:count`` to mpirun). The hash combines
hostname with an optional namespace salt for containerized environments
where hostnames collide.
"""

from __future__ import annotations

import hashlib
import os
import socket


def host_hash(salt: str | None = None) -> str:
    """Stable identifier for this host."""
    parts = [socket.gethostname()]
    # Containers may share hostnames across nodes; a namespace env
    # disambiguates (the reference mixes in the mount namespace).
    ns = os.environ.get("HOROVOD_TPU_HOST_NAMESPACE")
    if ns:
        parts.append(ns)
    if salt:
        parts.append(salt)
    joined = "-".join(parts)
    return "%s-%s" % (parts[0],
                      hashlib.md5(joined.encode("utf-8")).hexdigest()[:8])
