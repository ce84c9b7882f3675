"""Prefetch to the device, ``depth`` batches ahead.

Counterpart of ``horovod_tpu/data/prefetch.py``.
``prefetch_to_device(loader, device, depth=2)`` runs the loader and the
host-to-device copy on a background thread and keeps up to ``depth``
batches on the device ahead of the consumer: while the step runs on
batch k, the thread materializes and stages batch k+1.

On a CUDA device each field goes through a pinned host buffer and a
``non_blocking`` copy on a side stream; the batch carries the copy's
event, the consumer's stream waits on it in ``__next__`` (no host
synchronization), and every staged tensor is marked with
``record_stream`` for the consumer's stream, so the caching allocator
does not hand its memory back to the side stream while the step still
reads it. The producer thread waits on the event itself before it
queues the batch, which times the copy and keeps the pinned buffer
alive until the copy is done. On the CPU device staging is
``torch.as_tensor``.

The loader runs up to ``depth`` batches ahead of the consumer, so its
own cursor is ahead of the step. ``commit_cursor()`` gives the cursor
the loader had right after producing the batch the consumer took last:
the point a resumed job continues from (the tree an ``ElasticState``
commits beside the model).

``timer=`` takes any object with ``credit_h2d(seconds)`` and
``mark_h2d_done()`` (the duck type of the JAX package's ``StepTimer``):
when the consumer had to wait, the staged copy of that batch is credited
as its h2d share. A source's exception reaches the consumer at the
batch where it happened.

Where JAX's ``prefetch_to_device`` takes a ``sharding`` (a mesh meaning
``P('dp')``), the port takes this rank's device: each rank's loader
already holds only its own microbatch, and one process drives one
device (deviation 24 in ROADMAP.md). ``device=None`` is the device
``init()`` chose, else CUDA; without a card it raises unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Union

import numpy as np
import torch

from .. import topology as _topo
from .loader import Batch, _observe

_SENTINEL = object()


def _device(device) -> torch.device:
    if device is None and _topo.is_initialized():
        return _topo.device()
    return _topo.resolve_device(device)


def _fields(batch):
    return batch.data if isinstance(batch, Batch) else tuple(batch)


def _with(batch, data):
    return batch._replace(data=data) if isinstance(batch, Batch) else data


def _to_device(arrays, device: torch.device, stream=None):
    """(tensors on ``device``, the copy's CUDA event or None)."""
    hosts = [torch.as_tensor(np.asarray(a)) for a in arrays]
    if device.type != "cuda":
        return tuple(h.to(device) for h in hosts), None
    with torch.cuda.stream(stream):
        out = tuple(h.pin_memory().to(device, non_blocking=True)
                    for h in hosts)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


class DevicePrefetcher:
    """The iterator :func:`prefetch_to_device` returns. ``waited_s`` is
    the host seconds the consumer blocked in ``__next__``, ``h2d_s`` the
    seconds the staged copies took (on the producer thread), both summed
    since construction."""

    def __init__(self, it, device: Union[str, torch.device, None] = None,
                 *, depth: int = 2, timer=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.device = _device(device)
        self._it = iter(it)
        self._timer = timer
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._closed = False
        self.depth = depth
        self.waited_s = 0.0
        self.h2d_s = 0.0
        # The cursor after the last batch the consumer took (a loader's).
        self._has_cursor = hasattr(it, "cursor")
        self._cursor = it.cursor() if self._has_cursor else None
        self._thread = threading.Thread(
            target=self._producer, name="hvd-tpu-torch-data-prefetch",
            daemon=True)
        self._thread.start()

    def _stage(self, batch):
        t0 = time.perf_counter()
        data, event = _to_device(_fields(batch), self.device, self._stream)
        if event is not None:
            event.synchronize()
        h2d_s = time.perf_counter() - t0
        self.h2d_s += h2d_s
        return _with(batch, data), event, h2d_s

    def _producer(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            for batch in self._it:
                if self._closed:
                    return
                cursor = self._it.cursor() if self._has_cursor else None
                self._q.put(self._stage(batch) + (cursor,))
            self._q.put(_SENTINEL)
        except BaseException as e:  # the consumer raises it
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        wait_s = time.perf_counter() - t0
        self.waited_s += wait_s
        if item is _SENTINEL:
            self._closed = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._closed = True
            raise item
        batch, event, h2d_s, self._cursor = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in _fields(batch):
                t.record_stream(consumer)
        if self._timer is not None and wait_s > 0:
            # The consumer stalled: the staged copy of this batch is the
            # h2d share of the stall, the rest was the source.
            self._timer.credit_h2d(min(wait_s, h2d_s))
        return batch

    def commit_cursor(self):
        """The loader's cursor as of the last batch this iterator handed
        out, observed as a commit (see the module docstring)."""
        if not self._has_cursor:
            raise TypeError("the prefetched iterator has no cursor()")
        _observe("cursor_commit", int(self._cursor["epoch"]),
                 int(self._cursor["offset"]), getattr(self._it, "rank", 0))
        return dict(self._cursor)

    def close(self) -> None:
        """Stop the background thread (the loader may be infinite) and
        wait for it to end, which it does once the batch it is reading,
        if any, arrives: no producer outlives its prefetcher to compete
        with the next one for the host."""
        self._closed = True
        while self._thread.is_alive():
            # Unblock a producer waiting on a full queue.
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(0.01)


def prefetch_to_device(it, device: Union[str, torch.device, None] = None,
                       *, depth: int = 2, timer=None) -> DevicePrefetcher:
    """Wrap a loader (or any iterator of :class:`Batch` or array tuples)
    with background host-to-device staging ``depth`` batches deep
    (``depth=2`` is double buffering). See the module docstring."""
    return DevicePrefetcher(it, device, depth=depth, timer=timer)


def stage(batch, device: Union[str, torch.device, None] = None, *,
          timer=None):
    """Synchronous staging for simple loops: copy to the device, wait for
    it, then ``timer.mark_h2d_done()``. The unprefetched side of a
    prefetch comparison."""
    dev = _device(device)
    data, event = _to_device(_fields(batch), dev,
                             torch.cuda.current_stream(dev)
                             if dev.type == "cuda" else None)
    if event is not None:
        event.synchronize()
    if timer is not None:
        timer.mark_h2d_done()
    return _with(batch, data)


__all__ = ["DevicePrefetcher", "prefetch_to_device", "stage"]
