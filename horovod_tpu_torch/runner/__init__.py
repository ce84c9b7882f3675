"""Cluster launcher of the port: the counterpart of
``horovod_tpu/runner``, the reference's L4 layer (horovod/spark/ + bare
mpirun, docs/running.md).

Pieces:
  - :mod:`.network`   HMAC-authenticated pickle RPC (spark/util/network.py)
  - :mod:`.secret`    shared-secret handling (spark/util/secret.py)
  - :mod:`.host_hash` host grouping (spark/util/host_hash.py)
  - :mod:`.safe_exec` process management + watchdogs (safe_shell_exec.py,
                      mpirun_exec_fn.py)
  - :mod:`.launcher`  rank spawning, local + ssh (mpirun / mpirun_rsh.py),
                      with ``torch.distributed``'s env rendezvous
  - :mod:`.driver_service` rendezvous + result collection
                      (driver/driver_service.py)
  - :mod:`.api`       ``run(fn)`` (horovod.spark.run, spark/__init__.py)
  - CLI: ``python -m horovod_tpu_torch.runner -np 4 python train.py``
        (``--discovery {hostfile,ssh,tpu-pod}`` resolves workers through
        the elastic subsystem's HostProvider; ``--elastic`` survives
        worker loss — see horovod_tpu_torch/elastic/; ``--serve`` starts
        ``python -m horovod_tpu_torch.serving``)
"""

from .api import run
from .launcher import launch, parse_hosts
from .network import find_free_port

__all__ = ["run", "run_elastic", "launch", "parse_hosts",
           "find_free_port"]


def __getattr__(name):
    # Lazy: the elastic driver imports this package's submodules, so a
    # top-level import here would be circular.
    if name == "run_elastic":
        from ..elastic.driver import run_elastic
        return run_elastic
    raise AttributeError(name)
