"""Programmatic launch API: ``runner.run(fn, args=..., np=...)``.

Counterpart of ``horovod_tpu/runner/api.py``. Parity: ``horovod.spark.run``
(reference horovod/spark/__init__.py:80-196) — run a Python function on
every rank of a fresh distributed job and return the per-rank results in
rank order. Where the reference rides Spark executors + mpirun, this
spawns workers directly (subprocess/ssh) and wires them with the
``torch.distributed`` rendezvous (:mod:`.launcher`).

The function travels pickled: by ``cloudpickle`` where it is installed,
by ``pickle`` otherwise, which ships a function by reference — then it
must be importable at module level in the workers.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Any, Callable, Dict, List, Optional

from .driver_service import DriverService
from .launcher import is_local_host, launch, parse_hosts
from .secret import SECRET_ENV, encode_key, make_secret_key
from .timeout import Timeout

START_TIMEOUT_ENV = "HOROVOD_TPU_START_TIMEOUT"


def driver_addresses(driver: DriverService, hosts: Optional[str]) -> str:
    """``HOROVOD_TPU_DRIVER``: the driver's addresses the workers try in
    turn. Loopback when every host is this one; with a remote host every
    interface it answers on (the reference probes NICs for mutually
    routable interfaces, spark/util/network.py:93-107)."""
    if not hosts or all(is_local_host(h) for h, _ in parse_hosts(hosts)):
        return f"127.0.0.1:{driver.port}"
    return ",".join(f"{h}:{p}" for h, p in driver.addresses())


def run(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
        np: int = 1, hosts: Optional[str] = None,
        extra_env: Optional[Dict[str, str]] = None,
        start_timeout: Optional[float] = None,
        run_timeout: Optional[float] = None,
        stdout=None, stderr=None, verbose: bool = False) -> List[Any]:
    """Execute ``fn(*args, **kwargs)`` on ``np`` ranks; return results in
    rank order.

    The launched workers may freely call :func:`horovod_tpu_torch.init`
    and the collective API — the driver pre-wires the rendezvous through
    the environment.
    """
    kwargs = kwargs or {}
    if start_timeout is None:
        start_timeout = float(os.environ.get(START_TIMEOUT_ENV, 600))

    try:
        import cloudpickle as pickler
    except ImportError:  # pragma: no cover
        import pickle as pickler
    fn_bytes = pickler.dumps((fn, args, kwargs))

    key = make_secret_key()
    driver = DriverService(np, key, fn_bytes)
    try:
        env = dict(extra_env or {})
        env[SECRET_ENV] = encode_key(key)
        env["HOROVOD_TPU_DRIVER"] = driver_addresses(driver, hosts)

        job = launch([sys.executable, "-m",
                      "horovod_tpu_torch.runner.task_exec"],
                     np=np, hosts=hosts, extra_env=env,
                     stdout=stdout, stderr=stderr)
        try:
            reg_timeout = Timeout(
                start_timeout,
                "Timed out waiting for {timeout} s for all ranks to "
                "register with the driver. Check worker logs for startup "
                "failures.")
            driver.wait_for_registration(reg_timeout,
                                         failfast=job.failfast_check)
            total = Timeout(
                run_timeout if run_timeout is not None else 10 ** 9,
                "Timed out after {timeout} s waiting for results.")
            results = driver.wait_for_results(total,
                                              failfast=job.failfast_check)
            # Results are already in hand: a worker lingering in teardown
            # past the grace period is not a reason to discard a
            # successful job — wait() already terminates stragglers
            # before raising.
            with contextlib.suppress(TimeoutError):
                job.wait(timeout=60)
            return results
        finally:
            job.terminate()
    finally:
        driver.shutdown()
