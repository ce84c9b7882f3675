"""Worker-side entry for function-mode launches
(``python -m horovod_tpu_torch.runner.task_exec``).

Counterpart of ``horovod_tpu/runner/task_exec.py``. Parity:
horovod/spark/task/mpirun_exec_fn.py (reference :1-55) — start a parent
watchdog, read the driver address + own index from env, fetch the
pickled function and world assignment, execute, register the result (or
the error) back with the driver. The index is the launcher's ``RANK``.
"""

from __future__ import annotations

import os
import sys
import traceback


def main() -> int:
    from .driver_service import DriverClient
    from .host_hash import host_hash
    from .safe_exec import start_parent_watchdog
    from .secret import key_from_env

    start_parent_watchdog()

    # Comma-separated host:port candidates — every interface the driver
    # answers on; the client tries them in order.
    addresses = []
    for hp in os.environ["HOROVOD_TPU_DRIVER"].split(","):
        host, port = hp.rsplit(":", 1)
        addresses.append((host, int(port)))
    index = int(os.environ["RANK"])
    client = DriverClient(addresses, key_from_env())

    client.register_task(index, host_hash())
    info = client.world_info(index)

    try:
        try:
            import cloudpickle as pickler
        except ImportError:  # pragma: no cover
            import pickle as pickler
        fn, args, kwargs = pickler.loads(info.fn_bytes)
        result = fn(*args, **kwargs)
        client.register_result(info.rank, result, None)
        return 0
    except BaseException as e:
        # Exit 0 once the traceback is registered: the driver raises the
        # real exception from wait_for_results; a nonzero exit here would
        # race failfast into masking it with a generic "exited with code
        # 1". Final gasp FIRST (docs/postmortem.md): function-mode
        # workers catch the exception here — sys.excepthook never fires —
        # so this is the flight recorder's last chance to dump the ring
        # and flush the metrics file.
        try:
            from ..observability import flight_recorder as _flight
            _flight.dump_on("exception", exc=e)
        except Exception:
            pass
        error = traceback.format_exc()
        try:
            # A typed WorkerFailure travels as the OBJECT, not flattened
            # text: the elastic driver dispatches on its class/fields to
            # recover instead of aborting (docs/adaptation.md).
            from ..elastic.failure import WorkerFailure
            if isinstance(e, WorkerFailure):
                error = e
        except Exception:
            pass
        client.register_result(info.rank, None, error)
        return 0


if __name__ == "__main__":
    sys.exit(main())
