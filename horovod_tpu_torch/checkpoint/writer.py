"""Durable shard writing — crash-atomic files and the async writer thread.

Counterpart of ``horovod_tpu/checkpoint/writer.py``: the same bytes on
disk for the same leaf, bf16 included (:func:`encode_shard`).

Durability discipline (``utils/checkpoint.py`` keeps the same one):
``os.replace`` alone orders nothing on several filesystems — after
power loss the rename can survive while the data blocks do not, leaving
a complete-looking but empty target. Every write
here therefore goes tmp → ``flush`` → ``fsync(file)`` → ``replace`` →
``fsync(parent dir)`` (the directory entry itself must be durable for
the rename to be).

Shard format: the standard ``.npy`` encoding (``allow_pickle=False`` on
both ends — shard payloads are raw arrays and restoring one must never
execute code), serialized to memory first so the crc32 covers the exact
bytes on disk; the checksum + byte count land in a ``<file>.crc32``
sidecar. Sidecars are how per-shard checksums reach rank 0's manifest
without a collective: after the commit barrier rank 0 reads them back
from the (shared) step directory.

:class:`AsyncWriter` is the single background thread behind the engine's
non-blocking save: jobs run FIFO, ``wait()`` joins and re-raises the
first failure, and a failed job poisons the writer until waited on — a
training loop cannot silently keep "committing" over a dead disk.
"""

from __future__ import annotations

import io
import os
import queue
import threading
import zlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def fsync_dir(path: str) -> None:
    """fsync a directory so renames/creates inside it are durable.
    Best-effort: some filesystems (and platforms) refuse O_RDONLY
    directory fds — those also do not need the flush."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(target: str, data: bytes) -> None:
    """tmp + flush + fsync + rename + parent-dir fsync."""
    parent = os.path.dirname(os.path.abspath(target))
    tmp = target + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    fsync_dir(parent)


# Leaf dtypes numpy lacks without ``ml_dtypes``: the ``.npy`` header
# descr numpy writes for them (with ``ml_dtypes``, as the JAX engine
# does) and the integer type of the same width that carries their bits.
RAW_DTYPES = {
    "bfloat16": ("<V2", torch.bfloat16, torch.int16, np.int16),
    "float8_e4m3fn": ("<V1", torch.float8_e4m3fn, torch.uint8, np.uint8),
}
_RAW_BY_TORCH = {v[1]: (k, v[0], v[2]) for k, v in RAW_DTYPES.items()}


def encode_shard(arr) -> Tuple[bytes, str]:
    """``.npy`` bytes + crc32 hex of exactly those bytes. ``arr`` is a
    numpy array or a CPU tensor; a bf16 tensor is written as numpy with
    ``ml_dtypes`` writes it (descr ``'<V2'``, the raw 2-byte payload),
    from its bits, never through a numpy bfloat16 dtype."""
    buf = io.BytesIO()
    if isinstance(arr, torch.Tensor) and arr.dtype in _RAW_BY_TORCH:
        _, descr, bits = _RAW_BY_TORCH[arr.dtype]
        np.lib.format.write_array_header_1_0(buf, {
            "descr": descr, "fortran_order": False,
            "shape": tuple(int(d) for d in arr.shape)})
        buf.write(arr.contiguous().view(bits).numpy().tobytes())
    else:
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        # reshape: ascontiguousarray promotes 0-d to 1-d, which would
        # break the manifest span check on restore.
        np.save(buf, np.ascontiguousarray(arr).reshape(np.shape(arr)),
                allow_pickle=False)
    data = buf.getvalue()
    return data, f"{zlib.crc32(data) & 0xFFFFFFFF:08x}"


def write_shard(directory: str, filename: str, arr) -> Tuple[str, int]:
    """Write one shard + its crc32 sidecar; returns (crc hex, nbytes)."""
    data, crc = encode_shard(arr)
    atomic_write_bytes(os.path.join(directory, filename), data)
    atomic_write_bytes(os.path.join(directory, filename + ".crc32"),
                       f"{crc} {len(data)}\n".encode())
    return crc, len(data)


def read_sidecar(directory: str, filename: str) -> Tuple[str, int]:
    """(crc hex, nbytes) recorded next to a shard file."""
    with open(os.path.join(directory, filename + ".crc32")) as f:
        crc, nbytes = f.read().split()
    return crc, int(nbytes)


class AsyncWriter:
    """One background thread running write jobs FIFO.

    ``submit`` never blocks on I/O; ``wait`` drains the queue and
    re-raises the first job failure. After a failure every subsequent
    submit/wait keeps raising until ``wait`` has surfaced it once.
    """

    def __init__(self, name: str = "hvdtpu-ckpt-writer"):
        self._queue: "queue.Queue[Optional[Callable[[], None]]]" = \
            queue.Queue()
        self._idle = threading.Event()
        self._idle.set()
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                if self._error is None:
                    job()
            except BaseException as e:  # surfaced on wait()
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                if self._queue.unfinished_tasks == 1:
                    self._idle.set()
                self._queue.task_done()

    def submit(self, job: Callable[[], None]) -> None:
        self._raise_pending()
        self._idle.clear()
        self._queue.put(job)

    def wait(self) -> None:
        self._queue.join()
        self._idle.set()
        self._raise_pending()

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                "asynchronous checkpoint write failed") from err

    @property
    def busy(self) -> bool:
        return not self._idle.is_set()

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join(timeout=5)
