"""Eager collectives over ``torch.distributed``.

Counterpart of the public half of ``horovod_tpu/ops/collective.py``:
``allreduce[_async]`` (with ``average``), ``grouped_allreduce``,
``allgather[_async]``, ``broadcast[_async]``, ``poll``, ``synchronize``
and ``Handle``. Async ops wrap ``torch.distributed`` work handles; there
is no background coordinator thread. Every op returns a new tensor and
leaves its input untouched. Names must be unique among in-flight ops, as
in Horovod.
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import topology as _topo
from ..utils import env as _env


class HorovodInternalError(RuntimeError):
    pass


DUPLICATE_NAME_ERROR = (
    "Requested to {op} a tensor with the same name as another tensor that is "
    "currently being processed. If you want to request another tensor, use a "
    "different tensor name.")

_names_lock = threading.Lock()
_in_flight: set = set()
_counter = itertools.count()


def _claim(op: str, name: Optional[str]) -> str:
    nm = name if name is not None else f"{op}.noname.{next(_counter)}"
    with _names_lock:
        if nm in _in_flight:
            raise ValueError(DUPLICATE_NAME_ERROR.format(op=op))
        _in_flight.add(nm)
    return nm


def _release(name: str) -> None:
    with _names_lock:
        _in_flight.discard(name)


class Handle:
    """An async operation: the ``torch.distributed`` work objects it
    waits on and a finisher that turns their buffers into the result."""

    __slots__ = ("name", "_works", "_finish", "_result", "_done")

    def __init__(self, name: str, works: Sequence, finish: Callable):
        self.name = name
        self._works = [w for w in works if w is not None]
        self._finish = finish
        self._result = None
        self._done = False

    def poll(self) -> bool:
        """Non-blocking completion check."""
        return self._done or all(w.is_completed() for w in self._works)

    def wait(self):
        """Block until done and return the op's output."""
        if not self._done:
            try:
                for w in self._works:
                    w.wait()
                self._result = self._finish()
            except RuntimeError as e:
                raise HorovodInternalError(
                    f"collective '{self.name}' failed: {e}") from e
            finally:
                self._done = True
                _release(self.name)
        return self._result


def _average(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.is_floating_point() or t.is_complex():
        return t.div_(n)
    return t.div_(n, rounding_mode="floor")


def allreduce_async(tensor: torch.Tensor, average: bool = True,
                    name: Optional[str] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> Handle:
    """Asynchronous sum (or mean, with ``average``) over all ranks."""
    n = _topo.size()
    nm = _claim("allreduce", name)
    out = tensor.detach().clone()
    if prescale_factor != 1.0:
        out.mul_(prescale_factor)
    work = dist.all_reduce(out, async_op=True)

    def finish():
        if average:
            _average(out, n)
        if postscale_factor != 1.0:
            out.mul_(postscale_factor)
        return out

    return Handle(nm, [work], finish)


def allreduce(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None, compression=None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Synchronous allreduce. A cast ``compression`` moves the tensor on
    the wire in its dtype and restores the input dtype after."""
    if compression is not None:
        t, ctx = compression.compress(tensor)
        out = allreduce_async(t, average, name, prescale_factor,
                              postscale_factor).wait()
        return compression.decompress(out, ctx)
    return allreduce_async(tensor, average, name, prescale_factor,
                           postscale_factor).wait()


def fused_allreduce_async(tensors: Sequence[torch.Tensor],
                          average: bool = True,
                          name: Optional[str] = None) -> Handle:
    """Allreduce ``tensors`` through flat fusion buffers: one buffer per
    dtype, cut at ``fusion_threshold_bytes()`` (a tensor larger than the
    cap gets a buffer of its own). The handle's result is the list of
    reduced tensors in input order."""
    n = _topo.size()
    cap = _env.fusion_threshold_bytes()
    nm = _claim("allreduce", name)
    groups: List[List[int]] = []
    open_group = {}      # dtype -> (indices, bytes)
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        cur = open_group.get(t.dtype)
        if cur is None or (cur[1] + nbytes > cap and cur[0]):
            cur = ([], 0)
            groups.append(cur[0])
        cur[0].append(i)
        open_group[t.dtype] = (cur[0], cur[1] + nbytes)
    buffers, works = [], []
    for idx in groups:
        buf = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        buffers.append(buf)
        works.append(dist.all_reduce(buf, async_op=True))

    def finish():
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for idx, buf in zip(groups, buffers):
            if average:
                _average(buf, n)
            off = 0
            for i in idx:
                k = tensors[i].numel()
                out[i] = buf[off:off + k].view(tensors[i].shape)
                off += k
        return out

    return Handle(nm, works, finish)


def grouped_allreduce(tensors: Sequence[torch.Tensor], average: bool = True,
                      name: Optional[str] = None) -> List[torch.Tensor]:
    """Allreduce a list of tensors as one fused submission."""
    return fused_allreduce_async(tensors, average, name).wait()


def allgather_async(tensor: torch.Tensor,
                    name: Optional[str] = None) -> Handle:
    """Asynchronous concatenation along dim 0 of every rank's tensor;
    first dims may differ across ranks (the MPI_Allgatherv case)."""
    n = _topo.size()
    nm = _claim("allgather", name)
    t = tensor.detach().contiguous()
    if t.dim() == 0:
        t = t.reshape(1)
    rows = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    all_rows = [torch.empty_like(rows) for _ in range(n)]
    try:
        dist.all_gather(all_rows, rows)
    except RuntimeError:
        _release(nm)
        raise
    counts = [int(r.item()) for r in all_rows]
    top = max(counts)
    padded = t
    if t.shape[0] < top:
        padded = torch.cat([t, t.new_zeros((top - t.shape[0],) +
                                           tuple(t.shape[1:]))])
    parts = [torch.empty_like(padded) for _ in range(n)]
    work = dist.all_gather(parts, padded, async_op=True)

    def finish():
        return torch.cat([p[:c] for p, c in zip(parts, counts)])

    return Handle(nm, [work], finish)


def allgather(tensor: torch.Tensor, name: Optional[str] = None):
    return allgather_async(tensor, name).wait()


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None) -> Handle:
    """Asynchronous copy of ``root_rank``'s tensor to every rank."""
    n = _topo.size()
    if not (0 <= root_rank < n):
        raise ValueError(
            f"Invalid root_rank {root_rank}: root rank must be in [0, {n})")
    nm = _claim("broadcast", name)
    out = tensor.detach().clone().contiguous()
    work = dist.broadcast(out, src=root_rank, async_op=True)
    return Handle(nm, [work], lambda: out)


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None):
    return broadcast_async(tensor, root_rank, name).wait()


def poll(handle: Handle) -> bool:
    """True iff the op behind ``handle`` finished."""
    return handle.poll()


def synchronize(handle: Handle):
    """Wait for ``handle`` and return its output."""
    return handle.wait()
