"""Driver-side rendezvous service for function-mode launches.

Counterpart of ``horovod_tpu/runner/driver_service.py``, copied.

Parity: horovod/spark/driver/driver_service.py (reference :1-234) and the
result-collection flow of horovod/spark/__init__.py:80-196 — the driver runs
an HMAC RPC service; each worker registers on start, fetches the pickled
function plus its world assignment, executes, and registers its result; the
driver collects results in rank order.

TPU-native redesign: the Spark scheduler is replaced by direct process
spawning (local subprocess or ssh — :mod:`.launcher`), and the mpirun
wire-up is replaced by handing every worker the ``torch.distributed``
rendezvous (``init_process_group`` is the MPI_Init equivalent, see
``horovod_tpu_torch/topology.py``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from .network import BasicClient, BasicService
from .timeout import Timeout


class RegisterTaskRequest:
    def __init__(self, index: int, host_hash: str):
        self.index = index
        self.host_hash = host_hash


class RegisterTaskResponse:
    pass


class WorldInfoRequest:
    """Worker asks for its world assignment + the pickled function."""

    def __init__(self, index: int):
        self.index = index


class WorldInfoResponse:
    """Rank/size + the function to run. The distributed wire-up
    travels exclusively through the env vars set by the launcher — one
    authoritative channel, consumed by :func:`horovod_tpu_torch.init`."""

    def __init__(self, rank: int, size: int, fn_bytes: bytes):
        self.rank = rank
        self.size = size
        self.fn_bytes = fn_bytes


class RegisterResultRequest:
    def __init__(self, rank: int, result: Any, error: Optional[str] = None):
        self.rank = rank
        self.result = result
        self.error = error


class RegisterResultResponse:
    pass


class DriverService(BasicService):
    """Rendezvous + result collection for ``runner.run(fn)``."""

    def __init__(self, num_proc: int, key: bytes, fn_bytes: bytes):
        self._num_proc = num_proc
        self._fn_bytes = fn_bytes
        self._lock = threading.Lock()
        self._registered: Dict[int, str] = {}
        self._results: Dict[int, Tuple[Any, Optional[str]]] = {}
        self._all_registered = threading.Event()
        self._all_done = threading.Event()
        super().__init__("horovod-tpu-driver", key)

    # ------------------------------------------------------------- dispatch

    def _handle(self, req, client_address):
        if isinstance(req, RegisterTaskRequest):
            with self._lock:
                self._registered[req.index] = req.host_hash
                if len(self._registered) == self._num_proc:
                    self._all_registered.set()
            return RegisterTaskResponse()
        if isinstance(req, WorldInfoRequest):
            # index == rank: slot assignment happens at spawn time (the
            # launcher already grouped slots by host, mirroring the
            # reference's host ordering, spark/__init__.py:123-152).
            return WorldInfoResponse(
                rank=req.index, size=self._num_proc,
                fn_bytes=self._fn_bytes)
        if isinstance(req, RegisterResultRequest):
            with self._lock:
                self._results[req.rank] = (req.result, req.error)
                if len(self._results) == self._num_proc:
                    self._all_done.set()
            return RegisterResultResponse()
        return super()._handle(req, client_address)

    # -------------------------------------------------------------- waiting

    def wait_for_registration(self, timeout: Timeout, failfast=None) -> None:
        while not self._all_registered.wait(timeout=1.0):
            timeout.check()
            if failfast is not None:
                failfast()

    def wait_for_results(self, timeout: Timeout,
                         failfast=None) -> List[Any]:
        """Block until every rank registered a result; raise if any worker
        reported an error (or ``failfast()`` flags a dead worker)."""
        while not self._all_done.wait(timeout=1.0):
            timeout.check()
            if failfast is not None:
                failfast()
        out: List[Any] = []
        errors = []
        typed = None
        for r in range(self._num_proc):
            result, error = self._results[r]
            if error is not None:
                errors.append(f"rank {r}: {error}")
                if typed is None and isinstance(error, BaseException):
                    typed = error
            out.append(result)
        if typed is not None:
            # A worker registered a typed failure object (WorkerFailure
            # from a slow-rank eviction / escalated stall): re-raise IT
            # so the elastic driver can dispatch on rank/host/kind and
            # recover, instead of burying it in a generic RuntimeError.
            raise typed
        if errors:
            raise RuntimeError("worker function failed on "
                               + "; ".join(errors))
        return out

    def results_so_far(self) -> int:
        with self._lock:
            return len(self._results)


class DriverClient(BasicClient):
    def register_task(self, index: int, hh: str) -> None:
        self.request(RegisterTaskRequest(index, hh))

    def world_info(self, index: int) -> WorldInfoResponse:
        return self.request(WorldInfoRequest(index))

    def register_result(self, rank: int, result: Any,
                        error: Optional[str] = None) -> None:
        self.request(RegisterResultRequest(rank, result, error))
